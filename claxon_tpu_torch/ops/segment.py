"""K5: frame-header search over a stream upload (counterpart of
``claxon_tpu.ops.segment.find_frame_headers``).

Every byte position of the big-endian int32 stream is tested for a frame
sync code: byte ``0xFF`` followed by a byte ``b`` with ``b & 0xFE ==
0xF8``, at a position below ``n_bytes - 2``. The first ``max_candidates``
hits, in stream order, are the candidates; ``count`` is the number of all
hits, so a caller whose capacity was too small learns by how much. Each
candidate's 16-byte header window is checked like the reference reader
checks a header (claxon ``src/frame.rs:131-316``): the fixed fields, the
UTF-8 frame or sample number, and the CRC-8 over the header bytes against
the byte after them.

Window bytes past the upload repeat the bytes of its last word, as the
JAX program's clamped gather reads them (only headers that cannot pass the
``p + hlen < n_bytes`` check see them). The TPU form's top_k compaction
and gather-free GF(2) CRC steps are not carried over: the CUDA kernel
counts hits per block, scans the block totals and writes each block's
hits in order, then checks one candidate per thread with a table CRC.
"""

import numpy as np
import torch

from ..crc import CRC8_TABLE
from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["find_frame_headers", "find_frame_headers_plain",
           "MAX_HEADER_BYTES"]

#: sync(2) + fixed(2) + UTF-8 number(<= 7) + block size(<= 2) + sample
#: rate(<= 2); the CRC-8 byte follows at offset hlen.
MAX_HEADER_BYTES = 15
WIN = MAX_HEADER_BYTES + 1

_M32 = 0xFFFFFFFF


def _empty(max_candidates, device):
    return (torch.full((max_candidates,), -1, dtype=torch.int32,
                       device=device),
            torch.zeros((max_candidates,), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((max_candidates, WIN), dtype=torch.int32,
                        device=device))


def _leading_ones8(b):
    """Leading one bits of byte values (0..8)."""
    n = torch.zeros_like(b)
    live = torch.ones_like(b, dtype=torch.bool)
    for i in range(7, -1, -1):
        live = live & (((b >> i) & 1) != 0)
        n = n + live.to(b.dtype)
    return n


def header_checks(win, positions, n_bytes):
    """(C,) bool: the header grammar and CRC-8 checks of each window, and
    the candidate and its CRC byte inside ``n_bytes``. ``win`` (C, 16)
    int64 bytes."""
    bs_code = win[:, 2] >> 4
    sr_code = win[:, 2] & 15
    chan = win[:, 3]
    ca = chan >> 4
    bps_code = (chan >> 1) & 7
    ok = (bs_code != 0) & (sr_code != 15) & (ca <= 10) & (bps_code != 3) \
        & (bps_code != 7) & ((chan & 1) == 0)
    lead = _leading_ones8(win[:, 4])
    utf8_len = torch.where(lead == 0, 1, lead)
    ok = ok & (lead != 1) & (lead != 8)
    for j in range(1, 7):
        ok = ok & ((j >= utf8_len) | ((win[:, 4 + j] & 0xC0) == 0x80))
    bs_extra = (bs_code == 6).to(win.dtype) + 2 * (bs_code == 7).to(win.dtype)
    sr_extra = (sr_code == 12).to(win.dtype) \
        + 2 * ((sr_code == 13) | (sr_code == 14)).to(win.dtype)
    hlen = 4 + utf8_len + bs_extra + sr_extra
    table = torch.from_numpy(CRC8_TABLE.astype(np.int64)).to(win.device)
    state = torch.zeros_like(hlen)
    for j in range(MAX_HEADER_BYTES):
        state = torch.where(j < hlen, table[state ^ win[:, j]], state)
    stored = torch.gather(win, 1, hlen.clamp(max=WIN - 1)[:, None])[:, 0]
    p = positions.clamp(min=0)
    return ok & (state == stored) & (positions >= 0) & (p + hlen < n_bytes)


def find_frame_headers_plain(stream, n_bytes, max_candidates):
    """The plain PyTorch form.

    Args:
      stream: (W,) int32 big-endian words (byte i is word i >> 2, lane
              3 - (i & 3)).
      n_bytes: number of valid bytes.
      max_candidates: output capacity C.

    Returns:
      (positions (C,) int32, -1 past the count; valid (C,) bool; count ()
      int32, all hits; win (C, 16) int32 header window bytes).
    """
    C = max_candidates
    dev = stream.device
    W = stream.shape[0]
    if W == 0 or n_bytes < 2:
        return _empty(C, dev)
    u = stream.to(torch.int64) & _M32
    b = torch.stack([(u >> 24) & 255, (u >> 16) & 255, (u >> 8) & 255,
                     u & 255], dim=1).reshape(-1)
    nxt = torch.cat([b[1:], b.new_zeros(1)])
    i = torch.arange(4 * W, dtype=torch.int64, device=dev)
    hit = (b == 255) & ((nxt & 0xFE) == 0xF8) & (i < n_bytes - 2)
    count = hit.sum().to(torch.int32)
    first = torch.nonzero(hit)[:C, 0]
    positions = torch.full((C,), -1, dtype=torch.int64, device=dev)
    positions[:first.shape[0]] = first
    q = positions.clamp(min=0)[:, None] + torch.arange(WIN, device=dev)
    words = u[(q >> 2).clamp(max=W - 1)]
    win = (words >> (24 - 8 * (q & 3))) & 255
    valid = header_checks(win, positions, n_bytes)
    return positions.to(torch.int32), valid, count, win.to(torch.int32)


def find_frame_headers(stream, n_bytes, max_candidates):
    """K5 wrapper: the plain form for a CPU tensor; for a CUDA tensor the
    hand-written kernels (``csrc/segment.cu``), or an exception. Same
    arguments and results as :func:`find_frame_headers_plain`."""
    if on_cpu(stream):
        return find_frame_headers_plain(stream, n_bytes, max_candidates)
    dev = require_cuda_int32("find_frame_headers", stream=stream)
    if stream.dim() != 1 or max_candidates < 1:
        raise ValueError("find_frame_headers: expected a (W,) stream and "
                         "max_candidates >= 1")
    W = stream.shape[0]
    C = max_candidates
    if W == 0 or n_bytes < 2:
        return _empty(C, dev)
    lib = _build.load()
    cs = _build.stream_handle(dev)
    n_blocks = int(lib.cxk_sync_blocks(W))
    blk = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_sync_count(stream.data_ptr(), W, n_bytes,
                                    blk.data_ptr(), cs), "cxk_sync_count")
    # Glue: an inclusive scan of the per-block hit totals (n_blocks is
    # W / 1024, a few thousand at most).
    incl = torch.cumsum(blk, 0, dtype=torch.int32)
    positions = torch.empty((C,), dtype=torch.int32, device=dev)
    valid = torch.empty((C,), dtype=torch.bool, device=dev)
    win = torch.empty((C, WIN), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_sync_write(stream.data_ptr(), W, n_bytes,
                                    incl.data_ptr(), positions.data_ptr(), C,
                                    cs), "cxk_sync_write")
    count = incl[-1]
    _build.check(lib.cxk_header_check(stream.data_ptr(), W, n_bytes,
                                      count.data_ptr(), positions.data_ptr(),
                                      valid.data_ptr(), win.data_ptr(), C,
                                      cs), "cxk_header_check")
    find_frame_headers.launches += 1
    return positions, valid, count, win


#: kernel launches through the wrapper (CUDA tensors only).
find_frame_headers.launches = 0
