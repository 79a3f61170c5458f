"""K4: frame CRC-16 over byte ranges of the stream upload (counterpart of
``claxon_tpu.ops.crc.crc16_ranges_device``).

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

__all__ = ["crc16_ranges", "crc16_ranges_plain", "kernel_tables",
           "ITEM_BYTES", "STEP_BYTES", "LEVELS"]

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
