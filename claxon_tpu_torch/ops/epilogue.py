"""K3: per-frame epilogue, wasted-bits shift + stereo decorrelation, and
K3b: int16-pair transfer packing (counterpart of
``claxon_tpu.ops.epilogue``).

K3 (``apply_epilogue``) is plain elementwise torch ops on either device,
and the plain form of K3 in the fused K1 + K3 kernel
(``ops.predict.synthesize_epilogue``, ``csrc/synth.cu``), which the
decode paths call: XLA fused it into the synthesis program on the TPU,
and the kernel applies it as K1 stores each tile. K3b (``pack_int16_pairs``, ``unpack_int16_pairs``)
is two CUDA kernels (``csrc/pack16.cu``), each beside its plain form:
16-bit audio crosses the host link at half width, word w of a lane
holding sample 2w in its low half and sample 2w+1 in its high half,
which a little-endian host reads as int16 pairs with a zero-copy view.
``interleave_runs`` (``csrc/pack16.cu``, beside its plain form) has no
counterpart in the JAX package, which scatters on the host: it lays a
bucket's lanes out as per-stream interleaved PCM in a device arena,
which ``DeviceDecoded.start_fetch`` copies to pinned host memory in one
piece.

K3 semantics (claxon ``src/subframe.rs``, ``src/frame.rs``):

* wasted bits: wrapping left shift;
* left/side:  right = left - side;
* right/side: left = side + right;
* mid/side:   mid' = mid*2 | (side & 1); left = (mid'+side) >> 1,
              right = (mid'-side) >> 1.

All int32 and wrapping: torch defines int32 ``<<`` as an unsigned shift
(and 0 for amounts >= 32, like XLA), ``>>`` as arithmetic, and adds wrap.
Lanes are pair-aligned: ``pair_modes[p]`` is the channel-assignment code
of lanes (2p, 2p+1) -- 0 independent, 1 left/side, 2 right/side, 3
mid/side (``claxon_tpu.extract.MODE_CODES``).
"""

import numpy as np
import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["apply_epilogue", "pack_int16_pairs", "pack_int16_pairs_plain",
           "unpack_int16_pairs", "unpack_int16_pairs_plain",
           "interleave_runs", "interleave_runs_plain",
           "MODE_LEFT_SIDE", "MODE_RIGHT_SIDE", "MODE_MID_SIDE"]

MODE_LEFT_SIDE = 1
MODE_RIGHT_SIDE = 2
MODE_MID_SIDE = 3


def apply_epilogue(samples, wasted, pair_modes):
    """(L, T) int32 samples, (L,) wasted bits, (L//2,) pair modes ->
    (L, T) int32 with wasted bits applied and stereo pairs decorrelated."""
    samples = samples << wasted[:, None]
    L, T = samples.shape
    pairs = samples.reshape(L // 2, 2, T)
    c0 = pairs[:, 0]
    c1 = pairs[:, 1]
    m = pair_modes[:, None]

    mid2 = (c0 << 1) | (c1 & 1)
    out0 = torch.where(m == MODE_RIGHT_SIDE, c0 + c1,
                       torch.where(m == MODE_MID_SIDE, (mid2 + c1) >> 1, c0))
    out1 = torch.where(m == MODE_LEFT_SIDE, c0 - c1,
                       torch.where(m == MODE_MID_SIDE, (mid2 - c1) >> 1, c1))
    return torch.stack([out0, out1], dim=1).reshape(L, T)


def pack_int16_pairs_plain(out, per_lane=False):
    """The plain PyTorch form of :func:`pack_int16_pairs`."""
    lo = out[:, 0::2] & 0xFFFF
    hi = out[:, 1::2] << 16
    oob = (out > 32767) | (out < -32768)
    overflow = oob.any(dim=1) if per_lane else oob.any()
    return hi | lo, overflow.to(torch.int32)


def _require_aligned(name, **tensors):
    # The kernels move 16-byte vectors; torch allocations are aligned, a
    # view at an odd offset into one may not be.
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def pack_int16_pairs(out, per_lane=False):
    """Pack (L, T) int32 samples, T even, into ((L, T // 2) int32 words,
    overflow flag): word w of a lane is ``out[:, 2w + 1] << 16 |
    out[:, 2w] & 0xFFFF`` (the shift wraps). The flag is a () int32, or
    (L,) with ``per_lane``: 1 when any element, padding included, lies
    outside int16 (only an invalid stream's garbage does; the caller then
    fetches the int32 bucket instead), else 0.

    The plain form for a CPU tensor; for a CUDA tensor the kernel
    (``csrc/pack16.cu``), or an exception."""
    if out.dim() != 2 or out.shape[1] % 2:
        raise ValueError("pack_int16_pairs: expected (L, T) with T even, "
                         f"got {tuple(out.shape)}")
    if on_cpu(out):
        return pack_int16_pairs_plain(out, per_lane)
    dev = require_cuda_int32("pack_int16_pairs", out=out)
    _require_aligned("pack_int16_pairs", out=out)
    L, T = out.shape
    words = torch.empty((L, T // 2), dtype=torch.int32, device=dev)
    flag = torch.empty((L,) if per_lane else (), dtype=torch.int32,
                       device=dev)
    lib = _build.load()
    _build.check(lib.cxk_pack_int16_pairs(
        out.data_ptr(), L, T, int(per_lane), words.data_ptr(),
        flag.data_ptr(), _build.stream_handle(dev)), "cxk_pack_int16_pairs")
    pack_int16_pairs.launches += 1
    return words, flag


def unpack_int16_pairs_plain(w):
    """The plain PyTorch form of :func:`unpack_int16_pairs`."""
    lo = (w << 16) >> 16
    hi = w >> 16
    return torch.stack([lo, hi], dim=-1).reshape(w.shape[0],
                                                 2 * w.shape[1])


def unpack_int16_pairs(w):
    """Inverse of the int16-pair packing: (L, W) int32 words -> (L, 2W)
    int32, each half sign-extended, the low half first.

    The plain form for a CPU tensor; for a CUDA tensor the kernel
    (``csrc/pack16.cu``), or an exception."""
    if w.dim() != 2:
        raise ValueError("unpack_int16_pairs: expected (L, W) words, got "
                         f"{tuple(w.shape)}")
    if on_cpu(w):
        return unpack_int16_pairs_plain(w)
    dev = require_cuda_int32("unpack_int16_pairs", w=w)
    _require_aligned("unpack_int16_pairs", w=w)
    L, W = w.shape
    out = torch.empty((L, 2 * W), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.cxk_unpack_int16_pairs(
        w.data_ptr(), L * W, out.data_ptr(), _build.stream_handle(dev)),
        "cxk_unpack_int16_pairs")
    unpack_int16_pairs.launches += 1
    return out


def _run_table(runs, bucket, arena):
    """``runs`` as an (R, 5) int64 array of (dst, nf, bs, nch, lane0),
    checked to lie inside the (L, T) ``bucket`` and the flat ``arena``."""
    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 5)
    L, T = bucket.shape
    dst, nf, bs, nch, lane0 = runs.T
    if ((runs < 0).any() or (nch < 1).any() or (bs > T).any()
            or (lane0 + nf * nch > L).any()
            or (dst + nf * bs * nch > arena.numel()).any()):
        raise ValueError("interleave_runs: a run lies outside the bucket "
                         f"{(L, T)} or the arena ({arena.numel()} words)")
    return runs


def interleave_runs_plain(bucket, runs, arena):
    """The plain PyTorch form of :func:`interleave_runs`."""
    for dst, nf, bs, nch, lane0 in _run_table(runs, bucket, arena).tolist():
        lanes = bucket[lane0:lane0 + nf * nch, :bs].reshape(nf, nch, bs)
        arena[dst:dst + nf * bs * nch] = lanes.transpose(1, 2).reshape(-1)
    return arena


def interleave_runs(bucket, runs, arena):
    """Lay the (L, T) int32 ``bucket``'s lane runs out in ``arena``, a flat
    int32 tensor on its device, in place, and return it. ``runs`` holds
    rows ``(dst, n_frames, block_size, n_channels, first_lane)``: for f <
    n_frames, s < block_size and c < n_channels, ``arena[dst + (f *
    block_size + s) * n_channels + c] = bucket[first_lane + f * n_channels
    + c, s]`` (a lane-plan run of ``DeviceDecoded.lane_plans()``, its
    stream's PCM starting at ``dst - out0 * n_channels``). Words no run
    names keep their value. A run outside the bucket or the arena raises.

    The plain form for CPU tensors; for CUDA tensors the kernel
    (``csrc/pack16.cu``), its run table uploaded from pinned memory
    without blocking, or an exception."""
    if bucket.dim() != 2 or arena.dim() != 1:
        raise ValueError("interleave_runs: expected an (L, T) bucket and a "
                         f"flat arena, got {tuple(bucket.shape)} and "
                         f"{tuple(arena.shape)}")
    if on_cpu(bucket, arena):
        return interleave_runs_plain(bucket, runs, arena)
    dev = require_cuda_int32("interleave_runs", bucket=bucket, arena=arena)
    _require_aligned("interleave_runs", bucket=bucket, arena=arena)
    runs = _run_table(runs, bucket, arena)
    nf, bs = runs[:, 1], runs[:, 2]
    # The kernel's table: each run with its first frame, then each
    # frame's run.
    table = torch.from_numpy(np.concatenate([
        np.concatenate([runs, (np.cumsum(nf) - nf)[:, None]], 1).ravel(),
        np.repeat(np.arange(len(runs), dtype=np.int64), nf)]))
    table = table.pin_memory().to(dev, non_blocking=True)
    lib = _build.load()
    _build.check(lib.cxk_interleave_runs(
        bucket.data_ptr(), bucket.shape[1], table.data_ptr(), len(runs),
        int(nf.sum()), int(bs.max(initial=0)), arena.data_ptr(),
        _build.stream_handle(dev)), "cxk_interleave_runs")
    interleave_runs.launches += 1
    return arena


#: kernel launches through each wrapper (CUDA tensors only).
pack_int16_pairs.launches = 0
unpack_int16_pairs.launches = 0
interleave_runs.launches = 0
