"""K2: stream-gather Rice decoding (counterpart of ``claxon_tpu.ops.
entropy.decode_residual_bits_stream``).

The raw frame-section words are uploaded once; each 32-sample chunk of a
lane starts at a known absolute bit position (``bases``), and its 32
codes are decoded in order from there. The host walk guarantees every
code with its Rice parameter fits a 64-bit window (larger codes take the
fallback-frame path).

The plain form mirrors the JAX program operation for operation, in int64
holding u32 values (torch on the CPU has no unsigned 32-bit shifts), so
it, the JAX program and the CUDA kernel agree on every input, fuzzed
ones included: the same index clamps, and shifts by 32 or more give 0.
"""

import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["decode_residual_bits_stream",
           "decode_residual_bits_stream_plain"]

_M32 = 0xFFFFFFFF


def _wrap32(v):
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def _shl(v, s):
    """u32 ``v << s`` with XLA semantics (0 when s, as u32, is >= 32)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (v << s.clamp(0, 31)) & _M32, 0)


def _shr(v, s):
    """u32 ``v >> s`` with XLA semantics (0 when s, as u32, is >= 32)."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, v >> s.clamp(0, 31), 0)


def _clz32(v):
    """Leading zeros of u32 values held in int64 (32 for 0)."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return 32 - (((v * 0x01010101) & _M32) >> 24)


def decode_residual_bits_stream_plain(stream, bases, ks, ps, orders, pbits,
                                      flags, warm, lengths, n_parts_max=1,
                                      sa=8, chunk=32):
    """The plain PyTorch form: 32 vectorized steps over (L, NC) chunks.

    Args:
      stream:  (W,) int32 big-endian-packed frame-section bits, W >= 1.
      bases:   (L, NC) int32 absolute bit position of each chunk's first
               code (before the Rice parameter if the chunk opens a
               partition).
      ks:      (L, KP) int32 per-partition Rice parameters, KP >=
               n_parts_max.
      ps:      (L,) samples per partition; orders: (L,) predictor orders;
      pbits:   (L,) Rice parameter width; flags: (L,) bit0 verbatim, bit1
               no residual codes; warm: (L, WM) warm-up samples;
      lengths: (L,) block size.
      sa:      words gathered per chunk.

    Returns:
      (L, NC*chunk) int32: warm-up ++ residuals, zeros at padding.
    """
    L, NC = bases.shape
    T = NC * chunk
    W = stream.shape[0]
    dev = bases.device
    i64 = torch.int64

    s64 = stream.to(i64) & _M32
    b64 = bases.to(i64)
    idx = (b64 >> 5)[:, :, None] + torch.arange(sa, dtype=i64, device=dev)
    slots = s64[idx.clamp(0, W - 1)]                       # (L, NC, SA)
    cursor = b64 & 31                                      # (L, NC)

    c_col = torch.arange(NC, dtype=i64, device=dev)[None, :]
    order_b = orders.to(i64)[:, None]
    ps_b = ps.to(i64).clamp(min=1)[:, None]
    k_all = ks.to(i64)
    pb_b = pbits.to(i64)[:, None]
    fl = flags.to(i64)[:, None]
    verb = (fl & 1) != 0
    has_codes = (fl & 2) == 0
    len_b = lengths.to(i64)[:, None]

    out = torch.zeros((L, NC, chunk), dtype=i64, device=dev)
    for j in range(chunk):
        t = c_col * chunk + j
        active = (t >= order_b) & (t < len_b) & has_codes
        p = torch.zeros((L, NC), dtype=i64, device=dev)
        for m in range(1, n_parts_max):
            p = p + (t >= _wrap32(m * ps_b)).to(i64)
        k = torch.gather(k_all, 1, p)
        first = t == torch.where(p == 0, order_b, _wrap32(p * ps_b))
        pos = _wrap32(cursor + torch.where(first & ~verb, pb_b, 0))

        wi = (pos >> 5).clamp(0, sa - 1)
        off = pos & 31
        w0 = torch.gather(slots, 2, wi[:, :, None])[:, :, 0]
        w1 = torch.where(wi + 1 <= sa - 1, torch.gather(
            slots, 2, (wi + 1).clamp(max=sa - 1)[:, :, None])[:, :, 0], 0)
        w2 = torch.where(wi + 2 <= sa - 1, torch.gather(
            slots, 2, (wi + 2).clamp(max=sa - 1)[:, :, None])[:, :, 0], 0)
        sh = torch.where(off == 0, 1, 32 - off)
        hi = ((w0 << off) & _M32) | torch.where(off == 0, 0, w1 >> sh)
        lo = ((w1 << off) & _M32) | torch.where(off == 0, 0, w2 >> sh)

        # Rice: quotient = leading zeros of the 64-bit window.
        z = torch.where(hi != 0, _clz32(hi), 32 + _clz32(lo))
        s1 = z + 1
        rhi = torch.where(
            s1 < 32,
            ((hi << s1.clamp(max=31)) & _M32)
            | (lo >> (32 - s1).clamp(1, 31)),
            (lo << (s1 - 32).clamp(0, 31)) & _M32)
        r = torch.where(k == 0, 0, _shr(rhi, torch.where(k == 0, 1, 32 - k)))
        v = _shl(z, k) | r
        rice = torch.where((v & 1) != 0, (~(v >> 1)) & _M32, v >> 1)

        # Verbatim: sign-extend the k-bit field at the window start.
        rv = torch.where(k == 0, 0, _shr(hi, torch.where(k == 0, 1, 32 - k)))
        sbit = _shl(torch.ones_like(k), (k - 1).clamp(min=0))
        vb = _wrap32((rv ^ sbit) - sbit)

        res = torch.where(verb, vb, _wrap32(rice))
        adv = torch.where(verb, k, s1 + k)
        cursor = torch.where(active, _wrap32(pos + adv), cursor)
        out[:, :, j] = torch.where(active, res, 0)

    x = out.reshape(L, T)
    t = torch.arange(T, dtype=i64, device=dev)[None, :]
    WM = warm.shape[1]
    warm_t = torch.zeros((L, T), dtype=i64, device=dev)
    warm_t[:, :min(WM, T)] = warm[:, :min(WM, T)].to(i64)
    return torch.where(t < order_b, warm_t, x).to(torch.int32)


def decode_residual_bits_stream(stream, bases, ks, ps, orders, pbits, flags,
                                warm, lengths, n_parts_max=1, sa=8,
                                chunk=32):
    """K2 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/entropy.cu``), or an exception. Same
    arguments as :func:`decode_residual_bits_stream_plain`."""
    args = (stream, bases, ks, ps, orders, pbits, flags, warm, lengths)
    if on_cpu(*args):
        return decode_residual_bits_stream_plain(
            *args, n_parts_max=n_parts_max, sa=sa, chunk=chunk)
    dev = require_cuda_int32(
        "decode_residual_bits_stream", stream=stream, bases=bases, ks=ks,
        ps=ps, orders=orders, pbits=pbits, flags=flags, warm=warm,
        lengths=lengths)
    L, NC = bases.shape
    W = stream.shape[0]
    if chunk != 32:
        raise ValueError("decode_residual_bits_stream: the kernel decodes "
                         "32-sample chunks")
    if stream.dim() != 1 or W < 1 or sa < 1:
        raise ValueError("decode_residual_bits_stream: stream must be a "
                         "nonempty (W,) tensor and sa >= 1")
    if ks.dim() != 2 or ks.shape[0] != L or ks.shape[1] < n_parts_max \
            or n_parts_max < 1:
        raise ValueError("decode_residual_bits_stream: ks must be (L, KP) "
                         "with KP >= n_parts_max >= 1")
    if warm.dim() != 2 or warm.shape[0] != L or any(
            v.shape != (L,) for v in (ps, orders, pbits, flags, lengths)):
        raise ValueError("decode_residual_bits_stream: per-lane arguments "
                         "must have L rows")
    lib = _build.load()
    out = torch.empty((L, NC * 32), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_entropy_stream(
        stream.data_ptr(), W, bases.data_ptr(), ks.data_ptr(), ks.shape[1],
        n_parts_max, ps.data_ptr(), orders.data_ptr(), pbits.data_ptr(),
        flags.data_ptr(), warm.data_ptr(), warm.shape[1],
        lengths.data_ptr(), out.data_ptr(), L, NC, sa,
        _build.stream_handle(dev)), "cxk_entropy_stream")
    decode_residual_bits_stream.launches += 1
    return out


#: kernel launches through the wrapper (CUDA tensors only).
decode_residual_bits_stream.launches = 0
