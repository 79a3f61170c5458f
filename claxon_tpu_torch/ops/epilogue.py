"""K3: per-frame epilogue, wasted-bits shift + stereo decorrelation
(counterpart of ``claxon_tpu.ops.epilogue.apply_epilogue``).

Plain elementwise torch ops on either device: XLA fused this into the
synthesis program on the TPU; fusing it into K1's store is later work.
Semantics (claxon ``src/subframe.rs``, ``src/frame.rs``):

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

import torch

__all__ = ["apply_epilogue", "MODE_LEFT_SIDE", "MODE_RIGHT_SIDE",
           "MODE_MID_SIDE"]

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
