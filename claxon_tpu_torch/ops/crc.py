"""K4: frame CRC-16 over byte ranges of the stream upload (counterpart of
``claxon_tpu.ops.crc.crc16_ranges_device``), and the JAX module's two
other CRC functions, ``crc16_device`` (rows of a byte matrix) and
``crc16_frames_device`` (right-aligned windows of the upload), which no
decode route calls (their kernels: ``csrc/crc_lanes.cu``).

CRC-16 with polynomial 0x8005, init 0, MSB-first (claxon ``src/crc.rs``),
over bytes ``[starts[f], ends[f])`` of an int32 stream whose words hold
their bytes big-endian. Checking a frame together with its stored CRC
gives 0 iff the CRC matches.

Ranges are clamped to the upload: ``start`` to ``[0, 4W]`` and ``end`` to
``[start, 4W]`` (by design, so that no read leaves the stream). The JAX
function does not clamp: its prefix lookups give other values outside
the upload, for example on a 16-byte stream (-5, 3) -> 10002 there and
1548 here, (10, 99) -> 64596 and 26503, (14, 12) -> 38786 and 0. No path
hands K4 such a range: both planners pad with empty (0, 0) ranges
(``pipeline_bits.plan_raw_bits``, ``pipeline_seg.finish_segmented``), and
the ranges themselves come from walked frames.

The kernel (``csrc/crc.cu``) splits the ranges into items of
:data:`ITEM_BYTES` bytes aligned to each range's end, reads each item in
warp-wide steps of :data:`STEP_BYTES`, and joins the pieces by linearity
with the shift tables of :func:`kernel_tables`.
"""

import numpy as np
import torch

from ..crc import CRC16_TABLE, crc16_combine_matrices
from . import _build
from ._checks import on_cpu, require_cuda_int32
from .entropy import _wrap32

__all__ = ["crc16_ranges", "crc16_ranges_plain", "crc16_device",
           "crc16_device_plain", "crc16_frames_device",
           "crc16_frames_device_plain", "kernel_tables", "ITEM_BYTES",
           "STEP_BYTES", "LEVELS"]

#: bytes of one work item of the kernel (one warp), and of one warp-wide
#: step (16 bytes a lane).
ITEM_BYTES = 4096
STEP_BYTES = 512
#: shift matrices M_0..M_30 (by 2^k zero bytes): an int32 range is
#: shorter than 2^31 bytes.
LEVELS = 31

_TABLES = {}


def _shift_rows(state, rows):
    """Apply a GF(2) matrix given by its basis images to int array
    ``state``."""
    out = np.zeros_like(state)
    for i in range(16):
        out ^= np.where((state >> i) & 1 != 0, int(rows[i]), 0)
    return out


def kernel_tables():
    """(1024 + LEVELS * 512,) int32: the slice-by-4 tables T0..T3
    (``T_k[b]``, the CRC of byte b followed by k zero bytes), then for
    each k < LEVELS the shift by 2^k zero bytes as two 256-entry tables,
    the image of the state's low byte, then of its high byte."""
    mats = crc16_combine_matrices(LEVELS)
    b = np.arange(256, dtype=np.int64)
    slices = [CRC16_TABLE.astype(np.int64)]
    for _ in range(3):
        slices.append(_shift_rows(slices[-1], mats[0]))
    parts = slices[:]
    for k in range(LEVELS):
        parts += [_shift_rows(b, mats[k]), _shift_rows(b << 8, mats[k])]
    return np.concatenate(parts).astype(np.int32)


def _device_tables(dev):
    t = _TABLES.get(dev)
    if t is None:
        t = _TABLES[dev] = torch.from_numpy(kernel_tables()).to(dev)
    return t


def crc16_ranges_plain(stream, starts, ends):
    """The plain PyTorch form: the table CRC, one byte of every range per
    step. Returns (F,) int32."""
    dev = stream.device
    nbytes = 4 * stream.shape[0]
    s = starts.to(torch.int64).clamp(0, nbytes)
    e = torch.maximum(ends.to(torch.int64).clamp(max=nbytes), s)
    u = stream.to(torch.int64) & 0xFFFFFFFF
    table = torch.from_numpy(CRC16_TABLE.astype(np.int64)).to(dev)
    crc = torch.zeros_like(s)
    n = int((e - s).max()) if s.numel() else 0
    for i in range(n):
        pos = s + i
        w = u[(pos >> 2).clamp(max=max(stream.shape[0] - 1, 0))]
        b = (w >> (8 * (3 - (pos & 3)))) & 0xFF
        nxt = table[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
        crc = torch.where(pos < e, nxt, crc)
    return crc.to(torch.int32)


def crc16_ranges(stream, starts, ends):
    """K4 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/crc.cu``), or an exception.

    Args:
      stream: (W,) int32 big-endian words.
      starts, ends: (F,) int32 byte offsets.

    Returns:
      (F,) int32 CRC-16 values.
    """
    if on_cpu(stream, starts, ends):
        return crc16_ranges_plain(stream, starts, ends)
    dev = require_cuda_int32("crc16_ranges", stream=stream, starts=starts,
                             ends=ends)
    if stream.dim() != 1 or starts.dim() != 1 or \
            starts.shape != ends.shape:
        raise ValueError("crc16_ranges: expected (W,) stream and (F,) "
                         "starts/ends")
    lib = _build.load()
    F = starts.shape[0]
    out = torch.empty((F,), dtype=torch.int32, device=dev)
    item_off = torch.empty((F + 1,), dtype=torch.int64, device=dev)
    _build.check(lib.cxk_crc16_ranges(
        stream.data_ptr(), stream.shape[0], starts.data_ptr(),
        ends.data_ptr(), out.data_ptr(), F, _device_tables(dev).data_ptr(),
        item_off.data_ptr(), _build.stream_handle(dev)), "cxk_crc16_ranges")
    crc16_ranges.launches += 1
    return out


#: kernel launches through the wrapper (CUDA tensors only).
crc16_ranges.launches = 0


def crc16_device_plain(data, lengths):
    """The plain form of :func:`crc16_device`: the JAX scan, one byte
    column of every row per step. Returns (L,) int32."""
    table = torch.from_numpy(CRC16_TABLE.astype(np.int64)).to(data.device)
    d = data.to(torch.int64)
    n = lengths.to(torch.int64)
    state = torch.zeros((data.shape[0],), dtype=torch.int64,
                        device=data.device)
    for i in range(data.shape[1]):
        nxt = table[((state >> 8) ^ d[:, i]) & 0xFF] ^ ((state << 8) & 0xFFFF)
        state = torch.where(i < n, nxt, state)
    return state.to(torch.int32)


def crc16_device(data, lengths):
    """CRC-16 of each row's first ``lengths[l]`` bytes (counterpart of
    ``claxon_tpu.ops.crc.crc16_device``): the plain form for CPU tensors;
    for CUDA tensors the kernel (``csrc/crc_lanes.cu``), or an exception.

    Args:
      data:    (L, B) int32; only each element's low byte counts.
      lengths: (L,) int32; a negative length gives 0, one above B the CRC
               of all B columns.

    Returns:
      (L,) int32 CRC-16 values.
    """
    if on_cpu(data, lengths):
        return crc16_device_plain(data, lengths)
    dev = require_cuda_int32("crc16_device", data=data, lengths=lengths)
    if data.dim() != 2 or lengths.shape != data.shape[:1]:
        raise ValueError("crc16_device: expected (L, B) data and (L,) "
                         "lengths")
    L, B = data.shape
    out = torch.empty((L,), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    lib = _build.load()
    _build.check(lib.cxk_crc16_rows(
        data.data_ptr(), L, B, lengths.data_ptr(),
        _device_tables(dev).data_ptr(), out.data_ptr(),
        _build.stream_handle(dev)), "cxk_crc16_rows")
    crc16_device.launches += 1
    return out


def _check_n_words(stream, n_words):
    """``n_words`` as an int, refused as the JAX function refuses it."""
    W = int(n_words)
    if W & (W - 1) != 0:
        raise AssertionError("n_words must be a power of two")
    if W == 0:
        raise IndexError("crc16_frames_device: n_words is 0 (an empty "
                         "window)")
    if stream.shape[0] == 0:
        raise TypeError("crc16_frames_device: the stream is empty (the "
                        "clipped reads need a word)")
    return W


def crc16_frames_device_plain(stream, starts, ends, n_words):
    """The plain form of :func:`crc16_frames_device`: the JAX formula,
    vectorised over (F, n_words + 1) in int64 tensors that hold its int32
    values, then the word CRCs (slice-by-4 tables) joined pairwise by the
    shift tables, as the JAX reduction tree joins them. Returns (F,)
    int32."""
    W = _check_n_words(stream, n_words)
    dev = stream.device
    S = stream.shape[0]
    tables = torch.from_numpy(kernel_tables().astype(np.int64)).to(dev)
    u = stream.to(torch.int64) & 0xFFFFFFFF
    starts = starts.to(torch.int64)[:, None]
    ends = ends.to(torch.int64)[:, None]
    s = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    p0 = _wrap32(ends - 4 * (W - s))
    q0 = _wrap32(ends - 4 * W) >> 2
    idx = q0 + torch.arange(W + 1, dtype=torch.int64, device=dev)[None, :]
    g = u[idx.clamp(0, S - 1)]
    w0, w1 = g[:, :-1], g[:, 1:]
    sh = 8 * (ends & 3)
    w = torch.where(sh == 0, w0,
                    ((w0 << sh) & 0xFFFFFFFF) | (w1 >> (32 - sh)))
    for j in range(4):
        p = _wrap32(p0 + j)
        keep = (p >= starts) & (p < ends)
        w = torch.where(keep, w, w & ~(0xFF << (8 * (3 - j))))
    crcs = (tables[768 + (w >> 24)] ^ tables[512 + ((w >> 16) & 255)] ^
            tables[256 + ((w >> 8) & 255)] ^ tables[w & 255])
    k = 2  # each word spans 4 = 2^2 bytes
    while crcs.shape[1] > 1:
        left, right = crcs[:, 0::2], crcs[:, 1::2]
        m = 1024 + 512 * k
        crcs = tables[m + (left & 255)] ^ tables[m + 256 + (left >> 8)] ^ \
            right
        k += 1
    return crcs[:, 0].to(torch.int32)


def crc16_frames_device(stream, starts, ends, n_words):
    """CRC-16 over byte ranges [starts[f], ends[f]) of the big-endian
    upload, each in a right-aligned window of ``4 * n_words`` bytes ending
    at ``ends[f]`` (counterpart of ``claxon_tpu.ops.crc.
    crc16_frames_device``): the plain form for CPU tensors; for CUDA
    tensors the kernel (``csrc/crc_lanes.cu``), or an exception.

    Not K4's rule: a range longer than the window gives the CRC of its
    last ``4 * n_words`` bytes, ``starts > ends`` gives 0, and positions
    outside the upload read the words of the clipped gather.

    Args:
      stream: (S,) int32 big-endian words.
      starts, ends: (F,) int32 byte offsets.
      n_words: int, a power of two.

    Returns:
      (F,) int32 CRC-16 values.
    """
    if on_cpu(stream, starts, ends):
        return crc16_frames_device_plain(stream, starts, ends, n_words)
    W = _check_n_words(stream, n_words)
    dev = require_cuda_int32("crc16_frames_device", stream=stream,
                             starts=starts, ends=ends)
    if stream.dim() != 1 or starts.dim() != 1 or \
            starts.shape != ends.shape:
        raise ValueError("crc16_frames_device: expected (S,) stream and "
                         "(F,) starts/ends")
    if W > 1 << 28:
        raise ValueError(f"crc16_frames_device: n_words {W} above 2^28 "
                         "(an int32 window)")
    F = starts.shape[0]
    out = torch.empty((F,), dtype=torch.int32, device=dev)
    if F == 0:
        return out
    lib = _build.load()
    _build.check(lib.cxk_crc16_windows(
        stream.data_ptr(), stream.shape[0], starts.data_ptr(),
        ends.data_ptr(), F, W, _device_tables(dev).data_ptr(),
        out.data_ptr(), _build.stream_handle(dev)), "cxk_crc16_windows")
    crc16_frames_device.launches += 1
    return out


#: kernel launches through the wrappers (CUDA tensors only).
crc16_device.launches = 0
crc16_frames_device.launches = 0

