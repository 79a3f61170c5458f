"""K1: batched prediction synthesis (counterpart of ``claxon_tpu.ops.
predict`` and the Pallas kernel ``claxon_tpu.ops.pallas_synth``).

One recurrence reconstructs every FLAC subframe type, one (frame,
channel) per lane:

* LPC (orders 1-32): ``out[t] = x[t] + ((sum_k C[k] * out[t-32+k]) >>
  shift)`` with an exact int64 sum (|c| < 2^15 and 32 int32 taps stay
  below 2^51), an arithmetic shift and a wrapping int32 add;
* FIXED (orders 0-4): the same with Pascal coefficients and shift 0;
* CONSTANT / VERBATIM: order 0, zero coefficients, x passes through.

Warm-up samples in ``x[:, :order]`` pass through, and ``t >= length``
gives 0. The TPU's 8/16-bit limb arithmetic (``claxon_tpu.ops.i64``) is
not carried over: PyTorch and CUDA have int64.

:func:`synthesize_epilogue` is K1 with K3 (``ops.epilogue.
apply_epilogue``: wasted bits and stereo decorrelation) fused into the
kernel's store, as XLA fused them on the TPU; the decode paths call it.
"""

import numpy as np
import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32
from .epilogue import apply_epilogue

__all__ = ["synthesize", "synthesize_plain", "synthesize_best",
           "synthesize_reference", "synthesize_epilogue",
           "synthesize_epilogue_plain", "pack_coefficients", "ORDER_MAX"]

ORDER_MAX = 32


def pack_coefficients(coef_lists):
    """Pack per-subframe coefficient lists (oldest-sample-first, the
    convention of ``claxon_tpu_torch.subframe.decode_lpc``) into an (L, 32)
    int32 array, left-padded with zeros so column 31 multiplies out[t-1]
    (a copy of ``claxon_tpu.ops.predict.pack_coefficients``)."""
    out = np.zeros((len(coef_lists), ORDER_MAX), dtype=np.int32)
    for i, coefs in enumerate(coef_lists):
        if len(coefs):
            out[i, ORDER_MAX - len(coefs):] = coefs
    return out


def synthesize_plain(x, coefs, shifts, orders, lengths):
    """The plain PyTorch form: a loop over time on (L,) vectors.

    Args:
      x:       (L, T) int32, warm-up samples at t < order, residuals after.
      coefs:   (L, 32) int32, |c| < 2^15, column 31 the newest tap.
      shifts:  (L,) int32 QLP shift in [0, 31].
      orders:  (L,) int32 predictor order.
      lengths: (L,) int32 valid length; ``t >= length`` gives 0.

    Returns:
      (L, T) int32 decoded samples.
    """
    L, T = x.shape
    dev = x.device
    c = coefs.to(torch.int64)
    sh = shifts.to(torch.int64)
    buf = torch.zeros((L, T + ORDER_MAX), dtype=torch.int64, device=dev)
    x64 = x.to(torch.int64)
    for t in range(T):
        acc = (c * buf[:, t:t + ORDER_MAX]).sum(dim=1)
        # int64 -> int32 keeps the low 32 bits: the wrapping add.
        val = (x64[:, t] + (acc >> sh)).to(torch.int32).to(torch.int64)
        val = torch.where(t >= orders, val, x64[:, t])
        val = torch.where(t < lengths, val, 0)
        buf[:, t + ORDER_MAX] = val
    return buf[:, ORDER_MAX:].to(torch.int32)


def synthesize(x, coefs, shifts, orders, lengths=None):
    """K1 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/synth.cu``), or an exception. Same
    arguments as :func:`synthesize_plain`; ``lengths`` defaults to T."""
    if lengths is None:
        lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                             device=x.device)
    if on_cpu(x, coefs, shifts, orders, lengths):
        return synthesize_plain(x, coefs, shifts, orders, lengths)
    dev = require_cuda_int32("synthesize", x=x, coefs=coefs, shifts=shifts,
                             orders=orders, lengths=lengths)
    L, T = x.shape
    if coefs.shape != (L, ORDER_MAX) or any(
            v.shape != (L,) for v in (shifts, orders, lengths)):
        raise ValueError("synthesize: expected coefs (L, 32) and (L,) "
                         "shifts/orders/lengths for x of shape "
                         f"{tuple(x.shape)}")
    lib = _build.load()
    out = torch.empty_like(x)
    _build.check(lib.cxk_synthesize(
        x.data_ptr(), coefs.data_ptr(), shifts.data_ptr(), orders.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), L, T,
        _build.stream_handle(dev)), "cxk_synthesize")
    synthesize.launches += 1
    return out


def synthesize_best(x, coefs, shifts, orders, lengths=None):
    """The JAX package's pick of the fastest synthesis for the target: here
    the tensors' device picks, as in :func:`synthesize` (the kernel for
    CUDA tensors, the plain form for CPU ones)."""
    return synthesize(x, coefs, shifts, orders, lengths)


def synthesize_reference(x, coefs, shifts, orders):
    """The plain form with the signature of ``claxon_tpu.ops.predict.
    synthesize_reference``: array-likes in (x (L, T), coefs (L, 32),
    shifts and orders (L,)), every lane's full length, an (L, T) int32
    numpy array out."""
    x, coefs, shifts, orders = (torch.as_tensor(np.asarray(a, np.int32))
                                for a in (x, coefs, shifts, orders))
    lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32)
    return synthesize_plain(x, coefs, shifts, orders, lengths).numpy()


def synthesize_epilogue_plain(x, coefs, shifts, orders, lengths, wasted,
                              pair_modes):
    """The plain PyTorch form of :func:`synthesize_epilogue`."""
    return apply_epilogue(synthesize_plain(x, coefs, shifts, orders, lengths),
                          wasted, pair_modes)


def synthesize_epilogue(x, coefs, shifts, orders, lengths, wasted,
                        pair_modes):
    """K1 + K3 wrapper: synthesis, then each lane's wasted-bits shift and
    each lane pair's stereo decorrelation, in one kernel
    (``csrc/synth.cu``, the epilogue applied as tiles are stored). The
    plain form for CPU tensors; for CUDA tensors the kernel, or an
    exception.

    Args: those of :func:`synthesize_plain` (L even), then
      wasted:     (L,) int32 wasted bits.
      pair_modes: (L // 2,) int32 channel-assignment code of lanes
                  (2p, 2p + 1).

    Returns:
      (L, T) int32 PCM.
    """
    if on_cpu(x, coefs, shifts, orders, lengths, wasted, pair_modes):
        return synthesize_epilogue_plain(x, coefs, shifts, orders, lengths,
                                         wasted, pair_modes)
    dev = require_cuda_int32("synthesize_epilogue", x=x, coefs=coefs,
                             shifts=shifts, orders=orders, lengths=lengths,
                             wasted=wasted, pair_modes=pair_modes)
    L, T = x.shape
    if L % 2 or coefs.shape != (L, ORDER_MAX) or any(
            v.shape != (L,) for v in (shifts, orders, lengths, wasted)) or \
            pair_modes.shape != (L // 2,):
        raise ValueError("synthesize_epilogue: expected L even, coefs "
                         "(L, 32), (L,) shifts/orders/lengths/wasted and "
                         "(L // 2,) pair_modes for x of shape "
                         f"{tuple(x.shape)}")
    lib = _build.load()
    out = torch.empty_like(x)
    _build.check(lib.cxk_synthesize_epilogue(
        x.data_ptr(), coefs.data_ptr(), shifts.data_ptr(), orders.data_ptr(),
        lengths.data_ptr(), wasted.data_ptr(), pair_modes.data_ptr(),
        out.data_ptr(), L, T, _build.stream_handle(dev)),
        "cxk_synthesize_epilogue")
    synthesize_epilogue.launches += 1
    return out


#: kernel launches through each wrapper (CUDA tensors only).
synthesize.launches = 0
synthesize_epilogue.launches = 0
