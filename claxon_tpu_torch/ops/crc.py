"""K4: frame CRC-16 over byte ranges of the stream upload (counterpart of
``claxon_tpu.ops.crc.crc16_ranges_device``).

CRC-16 with polynomial 0x8005, init 0, MSB-first (claxon ``src/crc.rs``),
over bytes ``[starts[f], ends[f])`` of an int32 stream whose words hold
their bytes big-endian. Checking a frame together with its stored CRC
gives 0 iff the CRC matches. Ranges are clamped to the upload: ``start``
to ``[0, 4W]`` and ``end`` to ``[start, 4W]``.
"""

import numpy as np
import torch

from ..crc import CRC16_TABLE
from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["crc16_ranges", "crc16_ranges_plain"]


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
    _build.check(lib.cxk_crc16_ranges(
        stream.data_ptr(), stream.shape[0], starts.data_ptr(),
        ends.data_ptr(), out.data_ptr(), F, _build.stream_handle(dev)),
        "cxk_crc16_ranges")
    crc16_ranges.launches += 1
    return out


#: kernel launches through the wrapper (CUDA tensors only).
crc16_ranges.launches = 0
