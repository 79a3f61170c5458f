"""Rice decoding of the residuals (counterparts of ``claxon_tpu.ops.
entropy``): K2, and the two delta-fed kernels K9 and K10.

K2 (``decode_residual_bits_stream``) decodes from the raw frame-section
words: they are uploaded once; each 32-sample chunk of a lane starts at a
known absolute bit position (``bases``), and its 32 codes are decoded in
order from there. The host walk guarantees every code with its Rice
parameter fits a 64-bit window (larger codes take the fallback-frame
path).

K9 (``decode_residual_bits``, the host-walk path under
``CLAXON_TPU_ENTROPY=delta``) and K10 (``decode_residual_bits_stream_
delta``, the segmented path under ``CLAXON_TPU_SEG_ENTROPY=delta``) are
given each code's bit length (``deltas``: unary, terminator, remainder,
and the Rice parameter before a partition's first code), so every sample
decodes on its own: an in-chunk exclusive sum of the deltas gives each
code's end, the quotient is ``delta - 1 - k - pbits * first`` and the
remainder the k bits before the end. K9 reads the chunk's bits from
host-relocated slots of SA words (one slot per chunk, word-aligned at the
chunk's first code); K10 from the stream words at the chunk's base.

The plain forms mirror the JAX programs operation for operation, in
int64 holding u32 values (torch on the CPU has no unsigned 32-bit
shifts), so they, the JAX programs and the CUDA kernels agree on every
input, fuzzed ones included: the same index clamps, and shifts by 32 or
more give 0.
"""

import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32

__all__ = ["decode_residual_bits_stream",
           "decode_residual_bits_stream_plain", "decode_residual_bits",
           "decode_residual_bits_plain",
           "decode_residual_bits_stream_delta",
           "decode_residual_bits_stream_delta_plain"]

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


def _check_lanes(name, L, ks, n_parts_max, warm, lane_args):
    """Shape checks of the per-lane arguments K2, K9 and K10 share."""
    if ks.dim() != 2 or ks.shape[0] != L or ks.shape[1] < n_parts_max \
            or n_parts_max < 1:
        raise ValueError(f"{name}: ks must be (L, KP) with KP >= "
                         "n_parts_max >= 1")
    if warm.dim() != 2 or warm.shape[0] != L or any(
            v.shape != (L,) for v in lane_args):
        raise ValueError(f"{name}: per-lane arguments must have L rows")


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
    _check_lanes("decode_residual_bits_stream", L, ks, n_parts_max, warm,
                 (ps, orders, pbits, flags, lengths))
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


# ---- K9 and K10: every sample decoded on its own from the deltas --------

def _partitions(t, ks, ps_b, orders, n_parts_max):
    """(k, first) per sample: the partition index counts the j in [1, P)
    with t >= j * ps (int32 products, as in the JAX programs; not
    t // ps), k is that partition's Rice parameter, and ``first`` marks
    a partition's first code (t == order in partition 0, p * ps after)."""
    i64 = torch.int64
    p = torch.zeros((ks.shape[0], t.shape[1]), dtype=i64, device=t.device)
    for j in range(1, n_parts_max):
        p = p + (t >= _wrap32(j * ps_b)).to(i64)
    k = torch.gather(ks.to(i64)[:, :n_parts_max], 1, p)
    first = t == torch.where(p == 0, orders.to(i64)[:, None],
                             _wrap32(p * ps_b))
    return k, first


def _values_at(words, d, k, first, pbits, verb, rbase):
    """Each sample's value from its chunk's words.

    ``words`` (L, NC, SA) u32 in int64; ``d``, ``k`` and ``first`` (L, T);
    ``pbits`` (L,); ``verb`` (L, 1) or (L, T) bool; ``rbase`` the bit
    offset of each chunk's first code in its words, (L, NC) or 0. The
    remainder's first bit is rbase + (the in-chunk exclusive sum of d) +
    d - k, read through a 32-bit window of two words (the word index
    clipped to [0, SA - 1], the word after SA - 1 read as 0)."""
    L, NC, SA = words.shape
    T = NC * 32
    d3 = d.reshape(L, NC, 32)
    ol = torch.cumsum(d3, dim=2) - d3
    rbase = rbase[:, :, None] if torch.is_tensor(rbase) else rbase
    rpos = _wrap32(rbase + ol + d3 - k.reshape(L, NC, 32))
    wi = (rpos >> 5).clamp(0, SA - 1)
    off = rpos & 31
    w0 = torch.gather(words, 2, wi)
    w1 = torch.where(wi + 1 <= SA - 1,
                     torch.gather(words, 2, (wi + 1).clamp(max=SA - 1)), 0)
    win = ((w0 << off) & _M32) | torch.where(
        off == 0, 0, w1 >> torch.where(off == 0, 1, 32 - off))
    win = win.reshape(L, T)
    r = torch.where(k == 0, 0,
                    _shr(win, torch.where(k == 0, 1, _wrap32(32 - k))))
    q = _wrap32(d - 1 - k - torch.where(first, pbits.to(torch.int64)[:, None],
                                        0)) & _M32
    v = _shl(q, torch.minimum(k, torch.full_like(k, 31))) | r
    rice = torch.where((v & 1) != 0, (~(v >> 1)) & _M32, v >> 1)
    sbit = _shl(torch.ones_like(k), _wrap32(k - 1).clamp(min=0))
    vb = _wrap32((r ^ sbit) - sbit)
    return torch.where(verb, vb, _wrap32(rice))


def _with_warm(x, d, t, orders, warm):
    """Warm-up samples at t < order (zero past the stored ones), the
    decoded values where d > 0, zero elsewhere; as int32."""
    L, T = x.shape
    WM = warm.shape[1]
    warm_t = torch.zeros((L, T), dtype=torch.int64, device=x.device)
    warm_t[:, :min(WM, T)] = warm[:, :min(WM, T)].to(torch.int64)
    return torch.where(t < orders.to(torch.int64)[:, None], warm_t,
                       torch.where(d > 0, x, 0)).to(torch.int32)


def decode_residual_bits_plain(slots, deltas, ks, ps, orders, pbits, vflags,
                               warm, n_parts_max=1, sa=None):
    """K9's plain PyTorch form (``claxon_tpu.ops.entropy.
    decode_residual_bits``).

    Args:
      slots:  (L, NC * SA) int32 with ``sa=SA``, or (L, NC, SA): each
              chunk's codes, MSB-first from bit 0 of its slot.
      deltas: (L, T) uint8 (zero-extended) or int32 code lengths, T =
              NC * 32; 0 at warm-up and padding positions.
      ks:     (L, KP) int32 Rice parameters, KP >= n_parts_max.
      ps, orders, pbits, vflags: (L,) int32 samples per partition (taken
              as given, even 0 or negative), predictor orders, Rice
              parameter widths, 1 for verbatim lanes.
      warm:   (L, WM) int32 warm-up samples.

    Returns:
      (L, T) int32: warm-up samples at t < order, decoded residuals where
      the delta is above 0, zeros elsewhere.
    """
    i64 = torch.int64
    L = slots.shape[0]
    if slots.dim() == 2:
        slots = slots.reshape(L, -1, sa)
    NC = slots.shape[1]
    T = NC * 32
    dev = slots.device
    d = deltas.to(i64)
    t = torch.arange(T, dtype=i64, device=dev)[None, :]
    k, first = _partitions(t, ks, ps.to(i64)[:, None], orders, n_parts_max)
    verb = (vflags != 0)[:, None]
    x = _values_at(slots.to(i64) & _M32, d, k, first, pbits, verb, 0)
    return _with_warm(x, d, t, orders, warm)


def decode_residual_bits_stream_delta_plain(stream, bases, deltas, ks, ps,
                                            orders, pbits, flags, warm,
                                            lengths, n_parts_max=1, sa=8,
                                            chunk=32):
    """K10's plain PyTorch form (``claxon_tpu.ops.entropy.
    decode_residual_bits_stream_delta``).

    Args:
      stream:  (W,) int32 big-endian-packed stream words, W >= 1.
      bases:   (L, NC) int32 bit position of each chunk's first code.
      deltas:  (L, NC * 32) int8 code lengths (sign-extended), as the
               walk emits them; verbatim lanes ignore them and take k at
               their active positions.
      ks:      (L, KP) int32, KP >= n_parts_max; ps (taken as at least 1),
               orders, pbits, flags (bit 0 verbatim, bit 1 no codes),
               lengths: (L,) int32; warm: (L, WM) int32.
      sa:      stream words gathered per chunk, from word bases >> 5
               (clipped to the stream).

    Returns:
      (L, NC * 32) int32, as :func:`decode_residual_bits_plain`.
    """
    if chunk != 32:
        raise ValueError("decode_residual_bits_stream_delta: 32-sample "
                         "chunks only")
    i64 = torch.int64
    L, NC = bases.shape
    T = NC * 32
    W = stream.shape[0]
    dev = bases.device
    b64 = bases.to(i64)
    idx = (b64 >> 5)[:, :, None] + torch.arange(sa, dtype=i64, device=dev)
    words = (stream.to(i64) & _M32)[idx.clamp(0, W - 1)]   # (L, NC, sa)
    t = torch.arange(T, dtype=i64, device=dev)[None, :]
    k, first = _partitions(t, ks, ps.to(i64).clamp(min=1)[:, None], orders,
                           n_parts_max)
    fl = flags.to(i64)[:, None]
    verb = (fl & 1) != 0
    act = (t >= orders.to(i64)[:, None]) & (t < lengths.to(i64)[:, None]) \
        & ((fl & 2) == 0)
    d = torch.where(verb, torch.where(act, k, 0), deltas.to(i64))
    x = _values_at(words, d, k, first, pbits, verb, b64 & 31)
    return _with_warm(x, d, t, orders, warm)


def _check_deltas(name, deltas, dtype, shape, dev):
    if deltas.device != dev or deltas.dtype != dtype or \
            tuple(deltas.shape) != shape or not deltas.is_contiguous():
        raise ValueError(f"{name}: deltas must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {dev}")


def decode_residual_bits(slots, deltas, ks, ps, orders, pbits, vflags, warm,
                         n_parts_max=1, sa=None):
    """K9 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/entropy_delta.cu``), or an exception. Same
    arguments as :func:`decode_residual_bits_plain`; on the card slots
    are flat (L, NC * sa) int32 and deltas (L, NC * 32) uint8."""
    args = (slots, deltas, ks, ps, orders, pbits, vflags, warm)
    if on_cpu(*args):
        return decode_residual_bits_plain(*args, n_parts_max=n_parts_max,
                                          sa=sa)
    name = "decode_residual_bits"
    dev = require_cuda_int32(name, slots=slots, ks=ks, ps=ps, orders=orders,
                             pbits=pbits, vflags=vflags, warm=warm)
    L = slots.shape[0]
    if slots.dim() != 2 or sa is None or sa < 1 or slots.shape[1] % sa:
        raise ValueError(f"{name}: slots must be (L, NC * sa) with sa >= 1")
    NC = slots.shape[1] // sa
    _check_deltas(name, deltas, torch.uint8, (L, NC * 32), dev)
    _check_lanes(name, L, ks, n_parts_max, warm, (ps, orders, pbits, vflags))
    lib = _build.load()
    out = torch.empty((L, NC * 32), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_entropy_delta_slots(
        slots.data_ptr(), deltas.data_ptr(), ks.data_ptr(), ks.shape[1],
        n_parts_max, ps.data_ptr(), orders.data_ptr(), pbits.data_ptr(),
        vflags.data_ptr(), warm.data_ptr(), warm.shape[1], out.data_ptr(),
        L, NC, sa, _build.stream_handle(dev)), "cxk_entropy_delta_slots")
    decode_residual_bits.launches += 1
    return out


def decode_residual_bits_stream_delta(stream, bases, deltas, ks, ps, orders,
                                      pbits, flags, warm, lengths,
                                      n_parts_max=1, sa=8, chunk=32):
    """K10 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/entropy_delta.cu``), or an exception. Same
    arguments as :func:`decode_residual_bits_stream_delta_plain`."""
    args = (stream, bases, deltas, ks, ps, orders, pbits, flags, warm,
            lengths)
    if on_cpu(*args):
        return decode_residual_bits_stream_delta_plain(
            *args, n_parts_max=n_parts_max, sa=sa, chunk=chunk)
    name = "decode_residual_bits_stream_delta"
    dev = require_cuda_int32(name, stream=stream, bases=bases, ks=ks, ps=ps,
                             orders=orders, pbits=pbits, flags=flags,
                             warm=warm, lengths=lengths)
    if chunk != 32:
        raise ValueError(f"{name}: the kernel decodes 32-sample chunks")
    if stream.dim() != 1 or stream.shape[0] < 1 or sa < 1 or \
            bases.dim() != 2:
        raise ValueError(f"{name}: stream must be a nonempty (W,) tensor, "
                         "bases (L, NC), sa >= 1")
    L, NC = bases.shape
    _check_deltas(name, deltas, torch.int8, (L, NC * 32), dev)
    _check_lanes(name, L, ks, n_parts_max, warm,
                 (ps, orders, pbits, flags, lengths))
    lib = _build.load()
    out = torch.empty((L, NC * 32), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_entropy_delta_stream(
        stream.data_ptr(), stream.shape[0], bases.data_ptr(),
        deltas.data_ptr(), ks.data_ptr(), ks.shape[1], n_parts_max,
        ps.data_ptr(), orders.data_ptr(), pbits.data_ptr(), flags.data_ptr(),
        warm.data_ptr(), warm.shape[1], lengths.data_ptr(), out.data_ptr(),
        L, NC, sa, _build.stream_handle(dev)), "cxk_entropy_delta_stream")
    decode_residual_bits_stream_delta.launches += 1
    return out


#: kernel launches through the wrappers (CUDA tensors only).
decode_residual_bits.launches = 0
decode_residual_bits_stream_delta.launches = 0

