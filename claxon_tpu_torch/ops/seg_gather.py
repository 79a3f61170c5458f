"""K8: the segmented decode's values gather (counterpart of the values-mode
body of ``claxon_tpu.pipeline_seg._seg_decode_program_impl``).

The subframe walk (K7) decoded every residual while locating it, so a
decode dispatch needs no entropy pass: it gathers its lanes' rows of the
walk's values and puts each lane's warm-up samples in front,

    x[l, t] = warm[r, t] if t < order[r] else values[r, t],  r = rows[l],

for ``t < Tb32``, the dispatch bucket's chunk count times 32 (which may be
smaller than the walk's row width: a group walks at its largest block
size, a dispatch decodes at its frames'). Warm-up slots past the 32 stored
ones read as zero. Rows are clamped into the walk arrays. K1 synthesis
and the K3 epilogue follow.
"""

import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["gather_values", "gather_values_plain"]


def gather_values_plain(values, warm, order, rows, tb32):
    """The plain PyTorch form.

    Args:
      values: (R, NC * 32) int32 walk values.
      warm:   (R, 32) int32 warm-up samples.
      order:  (R,) int32 predictor orders.
      rows:   (L,) int32 walk row of each output lane.
      tb32:   output width, a multiple of 32 and at most NC * 32.

    Returns:
      (L, tb32) int32.
    """
    L = rows.shape[0]
    r = rows.to(torch.int64).clamp(0, max(values.shape[0] - 1, 0))
    if values.shape[0] == 0:
        return torch.zeros((L, tb32), dtype=torch.int32, device=rows.device)
    x = values[r, :tb32]
    w = torch.zeros((L, tb32), dtype=torch.int32, device=rows.device)
    n = min(32, tb32)
    w[:, :n] = warm[r, :n]
    t = torch.arange(tb32, device=rows.device)
    return torch.where(t[None, :] < order[r].to(torch.int64)[:, None], w, x)


def gather_values(values, warm, order, rows, tb32):
    """K8 wrapper: the plain form for CPU tensors; for CUDA tensors the
    kernel (``csrc/seg_gather.cu``), or an exception. Same arguments and
    result as :func:`gather_values_plain`."""
    if on_cpu(values, warm, order, rows):
        return gather_values_plain(values, warm, order, rows, tb32)
    dev = require_cuda_int32("gather_values", values=values, warm=warm,
                             order=order, rows=rows)
    R = values.shape[0]
    L = rows.shape[0]
    if values.dim() != 2 or warm.shape != (R, 32) or order.shape != (R,) \
            or rows.dim() != 1 or tb32 % 32 or not \
            0 <= tb32 <= values.shape[1] or values.shape[1] % 32:
        raise ValueError("gather_values: expected (R, NC*32) values, "
                         "(R, 32) warm, (R,) order, (L,) rows and a "
                         "multiple of 32 tb32 <= NC*32")
    out = torch.empty((L, tb32), dtype=torch.int32, device=dev)
    if R == 0:
        return out.zero_()
    lib = _build.load()
    _build.check(lib.cxk_seg_gather(
        values.data_ptr(), warm.data_ptr(), order.data_ptr(),
        rows.data_ptr(), R, values.shape[1], L, tb32, out.data_ptr(),
        _build.stream_handle(dev)), "cxk_seg_gather")
    gather_values.launches += 1
    return out


#: kernel launches through the wrapper (CUDA tensors only).
gather_values.launches = 0
