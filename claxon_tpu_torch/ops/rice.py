"""Rice decode of one partition a lane over a shared packed bit buffer
(counterpart of ``claxon_tpu.ops.rice``: ``rice_decode``, its program
``_rice_prog`` and the host helper ``pack_bits_be``).

No decode route calls it, in either package: the stream entropy kernel
(K2, ``ops/entropy.py``) decodes the pipelines' residuals. Its callers
are its tests and ``chip_smoke.py``.

Lane l reads ``counts[l]`` codes of Rice parameter ``params[l]`` from bit
``start_bits[l]`` of ``words`` (stream bit i is bit 31 - (i & 31) of word
i >> 5, the big-endian packing of :func:`pack_bits_be`): a unary quotient
ended by the next set bit, a k-bit remainder, the u32-wrapping fold
``(q << k) | r`` and the zig-zag sign. It returns the (L, T) int32
residuals, 0 past each lane's count, and each lane's end cursor.

Exact on garbage, as the JAX program defines it: cursors are int32 and
wrap, word reads are clipped to [0, W-1], shifts by 32 or more (k as
unsigned) give 0, and inactive steps leave the cursor. The JAX search for
the next set bit is one ``while_loop`` over all lanes, whose condition is
global: a lane that runs off the end of the buffer (its masked word 0 at
word W) moves on by one word for every iteration that any other lane
still needs, inactive lanes included. Both forms here reproduce that,
with work bounded by W a search where the JAX loop steps one word an
iteration (2^26 iterations from a cursor near -2^31 over a zero word 0).
"""

import numpy as np
import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32
from .entropy import _M32, _clz32, _shl, _shr, _wrap32

__all__ = ["rice_decode", "rice_decode_plain", "pack_bits_be",
           "MAX_WORDS"]

#: the int32 cursor covers 2^31 bits: 2^26 words.
MAX_WORDS = 1 << 26


def pack_bits_be(data):
    """Host helper: bytes -> int32 words in the kernel's bit order, plus an
    all-ones guard word: straddling reads may touch one word past the end,
    and a cursor that drifts past its partition (inactive lanes between
    scan steps) must terminate its next-set-bit search immediately."""
    pad = (-len(data)) % 4
    buf = bytes(data) + b"\x00" * pad + b"\xff" * 4
    return np.frombuffer(buf, dtype=">u4").astype(np.int64).astype(np.int32)


def rice_decode_plain(words, start_bits, params, counts, max_count):
    """The plain PyTorch form: the JAX program's T steps as a Python loop
    over vectorised ops on int64 tensors that hold int32 and u32 values.

    The next-set-bit search gives what the JAX ``while_loop`` gives, in
    closed form: lane l keeps that loop going for c_l iterations (until
    its set bit, or until its word index reaches W), the loop runs N =
    max(c_l) times, and a lane that finds no bit ends at word index
    (pos >> 5) + N. The first set word at or after an index comes from a
    suffix minimum over the nonzero words. Returns ((L, T) int32
    residuals, (L,) int32 end cursors)."""
    W = words.shape[0]
    T = int(max_count)
    dev = words.device
    w = words.to(torch.int64) & _M32
    at = torch.arange(W, dtype=torch.int64, device=dev)
    first = torch.where(w != 0, at, W).flip(0).cummin(0).values.flip(0)
    first = torch.cat([first, first.new_full((1,), W)])  # first[W] = W

    def word(i):
        return w[i.clamp(0, W - 1)]

    pos = start_bits.to(torch.int64)
    k = params.to(torch.int64)
    cnt = counts.to(torch.int64)
    out = torch.zeros((pos.shape[0], T), dtype=torch.int32, device=dev)
    for j in range(T):
        wi0 = pos >> 5
        masked = word(wi0) & (_M32 >> (pos & 31))
        nxt = wi0 + 1  # a negative word index reads word 0
        cand = torch.where(nxt <= 0,
                           torch.where(w[0] != 0, nxt, first[min(1, W)]),
                           first[nxt.clamp(0, W)])
        searching = (masked == 0) & (wi0 < W)
        found = searching & (cand < W)
        c = torch.where(searching, torch.where(found, cand, W) - wi0, 0)
        n_iter = c.max() if c.numel() else c.new_zeros(())
        wi = torch.where(found, cand, torch.where(masked == 0, wi0 + n_iter,
                                                  wi0))
        masked = torch.where(found, word(cand), masked)
        one = _wrap32((wi << 5) + _clz32(masked))
        q = (one - pos) & _M32
        p = _wrap32(one + 1)
        off = p & 31
        window = ((word(p >> 5) << off) & _M32) | torch.where(
            off == 0, 0, word((p >> 5) + 1) >> torch.where(off == 0, 1,
                                                           32 - off))
        r = torch.where(k == 0, 0, _shr(window, 32 - k))
        v = _shl(q, k) | r
        sample = _wrap32(torch.where(v & 1 != 0, ~(v >> 1) & _M32, v >> 1))
        active = j < cnt
        pos = torch.where(active, _wrap32(one + 1 + k), pos)
        out[:, j] = torch.where(active, sample, 0).to(torch.int32)
    return out, pos.to(torch.int32)


def _lane_arg(x, device):
    """A per-lane argument as an int32 tensor on ``device``: a tensor is
    moved, anything else goes through ``np.asarray(x, dtype=np.int32)`` as
    in the JAX function."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.asarray(x, dtype=np.int32).copy()).to(device)


def rice_decode(words, start_bits, params, counts, max_count=None):
    """Decode one Rice partition per lane: the plain form for a CPU
    ``words``; for a CUDA one the hand-written kernel (``csrc/rice.cu``),
    or an exception.

    Args:
      words:      (W,) int32 tensor of packed bits (:func:`pack_bits_be`).
      start_bits: (L,) absolute bit offset of each lane's first code.
      params:     (L,) Rice parameter k per lane.
      counts:     (L,) samples per lane.
      max_count:  sample-axis width T (default: max(counts), at least 0,
                  which waits for the card when counts lie there).

    ``start_bits``, ``params`` and ``counts`` may be tensors, arrays or
    lists; they go to ``words``' device. On the card a call is two kernel
    launches (every lane alone, then an exact pass that returns at once
    unless a lane ran off the buffer), counted once in ``.launches``.

    Returns:
      (residuals (L, T) int32, 0 past counts[l];
       end_bits (L,) int32 cursor after each lane's last code).
    """
    if int(words.shape[0]) > MAX_WORDS:  # 2^31 bits / 32
        raise ValueError("packed bit buffer exceeds the int32 cursor "
                         "range (2^31 bits, 256 MiB); split the input")
    dev = words.device
    counts = _lane_arg(counts, dev)
    start_bits = _lane_arg(start_bits, dev)
    params = _lane_arg(params, dev)
    if max_count is None:
        max_count = max(int(counts.max()), 0) if counts.numel() else 0
    T = int(max_count)
    if words.shape[0] == 0:
        raise TypeError("rice_decode: words is empty (the clipped reads "
                        "need a word)")
    if on_cpu(words, start_bits, params, counts):
        return rice_decode_plain(words, start_bits, params, counts, T)
    require_cuda_int32("rice_decode", words=words, start_bits=start_bits,
                       params=params, counts=counts)
    L = start_bits.shape[0]
    if words.dim() != 1 or start_bits.dim() != 1 or \
            params.shape != start_bits.shape or \
            counts.shape != start_bits.shape:
        raise ValueError("rice_decode: expected (W,) words and (L,) "
                         "start_bits, params and counts")
    if not 0 <= T < 1 << 31:
        raise ValueError(f"rice_decode: max_count {T} out of range")
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    end = torch.empty((L,), dtype=torch.int32, device=dev)
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = _build.load()
    _build.check(lib.cxk_rice_decode(
        words.data_ptr(), words.shape[0], start_bits.data_ptr(),
        params.data_ptr(), counts.data_ptr(), L, T, out.data_ptr(),
        end.data_ptr(), flag.data_ptr(), _build.stream_handle(dev)),
        "cxk_rice_decode")
    rice_decode.launches += 1
    return out, end


#: kernel launches through the wrapper (CUDA tensors only).
rice_decode.launches = 0

