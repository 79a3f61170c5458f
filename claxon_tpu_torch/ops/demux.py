"""K7: the subframe walk (counterpart of ``claxon_tpu.ops.demux.
walk_frames``).

For each frame, starting at the bit just past its header, the walk parses
every subframe in turn -- header and wasted bits, warm-up samples, LPC
parameters, residual header -- and then every residual code, decoding its
value as it goes, so the decode needs no entropy pass afterwards. Channel
c + 1 starts where channel c ends. The grammar is the reference reader's
(claxon ``src/subframe.rs:29-91,184-228,651-721``).

``ok`` is the JAX walk's accept set, and it decides which streams leave
the device path: it is false for a reserved subframe type, an escape code
or a code longer than 32 bits (the device cap), more than 64 partitions, a
block size not divisible by the partition count, an order not below the
partition size, an LPC precision code of 15 or a negative QLP shift, wasted
bits >= bps or a subframe bps above 32, and a chunk spanning more than 64
words. On ok frames every output equals the JAX walk's. Reads past the
stream end give zero bits. The per-code bit advances (``deltas``, int8)
that the JAX walk always emits come out only when asked for
(``deltas=True``): the segmented delta decode (K10) reads them, the
default values decode does not.

The plain form walks all frames at once, one code position per step, in
int64 holding u32 values (the CPU torch has no u32 shifts).
"""

import torch

from . import _build
from ._checks import on_cpu, require_cuda_int32
from .entropy import _clz32

__all__ = ["walk_frames", "walk_frames_plain", "WALK_KEYS", "P_CAP"]

#: partition capacity; frames with more partitions leave the device path.
P_CAP = 64

#: per-lane outputs, in the order the kernel writes them.
WALK_KEYS = ("order", "shift", "wasted", "n_parts", "ps", "pbits", "flags",
             "warm", "coefs", "ks", "bases", "sa_words", "values")

_M32 = 0xFFFFFFFF

#: fixed-predictor coefficients of order o, oldest tap first (claxon
#: src/subframe.rs:524-583); they fill slots 32 - o .. 31.
_FIXED = ([], [1], [-1, 2], [1, -3, 3], [-1, 4, -6, 4])


def _lane_shapes(n_lanes, T):
    nc = (T + 31) // 32
    widths = {"warm": 32, "coefs": 32, "ks": P_CAP, "bases": nc,
              "values": nc * 32}
    return {k: (n_lanes, widths[k]) if k in widths else (n_lanes,)
            for k in WALK_KEYS}


def _sext(v, n):
    """Sign-extend the n-bit values v (n >= 1) into int64."""
    sbit = torch.ones_like(n) << (n - 1).clamp(min=0)
    return (v ^ sbit) - sbit


def _top(h, n):
    """The top n bits of u32 window h (n in [0, 32])."""
    return torch.where(n == 0, 0, h >> (32 - n).clamp(0, 31))


class _Reader:
    """u32 windows at arbitrary bit positions; zero bits off the stream."""

    def __init__(self, stream):
        self.u = stream.to(torch.int64) & _M32
        self.W = self.u.shape[0]

    def word(self, q):
        if self.W == 0:
            return torch.zeros_like(q)
        ok = (q >= 0) & (q < self.W)
        return torch.where(ok, self.u[q.clamp(0, self.W - 1)], 0)

    def peek(self, pos):
        q = pos >> 5
        off = pos & 31
        w0, w1 = self.word(q), self.word(q + 1)
        return ((w0 << off) & _M32) | (w1 >> (32 - off))


def _walk_subframe(rd, out, pos, bs, ch_bps, T, ok):
    """Walk one subframe per frame from bit ``pos`` (F,) int64; fills this
    channel's rows of ``out`` and returns (end, ok)."""
    dev = pos.device
    F = pos.shape[0]
    NC = (T + 31) // 32
    i64 = torch.int64
    i32v = torch.arange(32, dtype=i64, device=dev)[None, :]

    hi = rd.peek(pos)
    okc = (hi >> 31) == 0
    ty = (hi >> 25) & 63
    wflag = ((hi >> 24) & 1) != 0
    rel = pos + 8
    is_const, is_verb = ty == 0, ty == 1
    is_fixed, is_lpc = (ty & 0x38) == 0x08, ty >= 32
    f_ord = ty & 7
    order = torch.where(is_const, 1, torch.where(
        is_fixed, f_ord, torch.where(is_lpc, (ty & 31) + 1, 0)))
    okc &= is_const | is_verb | (is_fixed & (f_ord <= 4)) | is_lpc

    whi, wlo = rd.peek(rel), rd.peek(rel + 32)
    z = torch.where(whi != 0, _clz32(whi), 32 + _clz32(wlo))
    wasted = torch.where(wflag, z + 1, 0)
    rel = rel + wasted
    okc &= wasted < ch_bps
    sf_bps = ch_bps - wasted
    okc &= sf_bps <= 32
    sf_r = sf_bps.clamp(1, 32)

    warm_order = torch.where(is_verb, 0, order.clamp(max=32))
    act_w = i32v < warm_order[:, None]
    h_w = rd.peek(rel[:, None] + i32v * sf_r[:, None])
    warm = torch.where(act_w, _sext(_top(h_w, sf_r[:, None]), sf_r[:, None]),
                       0)
    rel = rel + warm_order * sf_r

    hi = rd.peek(rel)
    prec = ((hi >> 28) & 15) + 1
    okc &= ~is_lpc | (prec != 16)
    shift5 = _sext((hi >> 23) & 31, torch.full_like(hi, 5))
    okc &= ~is_lpc | (shift5 >= 0)
    rel = rel + torch.where(is_lpc, 9, 0)
    act_c = is_lpc[:, None] & (i32v < order[:, None])
    h_c = rd.peek(rel[:, None] + i32v * prec[:, None])
    coef_v = torch.where(act_c, _sext(_top(h_c, prec[:, None]),
                                      prec[:, None]), 0)
    coefs = torch.flip(coef_v, dims=[1])
    fixed = torch.zeros((5, 32), dtype=i64, device=dev)
    for o, c in enumerate(_FIXED):
        if c:
            fixed[o, 32 - o:] = torch.tensor(c, dtype=i64)
    coefs = torch.where(is_fixed[:, None], fixed[f_ord.clamp(0, 4)], coefs)
    coefs[:, 31] = torch.where(is_const, 1, coefs[:, 31])
    rel = rel + torch.where(is_lpc, order * prec, 0)

    resd = is_fixed | is_lpc
    hi = rd.peek(rel)
    meth = hi >> 30
    okc &= ~resd | (meth <= 1)
    po = (hi >> 26) & 15
    rel = rel + torch.where(resd, 6, 0)
    pbits = torch.where(resd, 4 + meth, 0)
    n_parts = torch.where(resd, torch.ones_like(po) << po, 1)
    okc &= ~resd | (n_parts <= P_CAP)
    ps = torch.where(resd & (n_parts <= P_CAP), (bs & _M32) >> po, bs)
    okc &= ~resd | ((bs & (n_parts - 1)) == 0)
    okc &= ~resd | (order < ps.clamp(min=1))

    out["order"].append(torch.where(is_verb, 0, order))
    out["shift"].append(torch.where(is_lpc, shift5, 0))
    out["wasted"].append(wasted)
    out["n_parts"].append(n_parts)
    out["ps"].append(ps)
    out["pbits"].append(pbits)
    out["flags"].append(torch.where(is_const, 2, torch.where(is_verb, 1, 0)))
    out["warm"].append(warm)
    out["coefs"].append(coefs)

    # The residual walk, one code position of every frame per step.
    ps_s = ps.clamp(min=1)
    resd_l, verb_l = resd & okc, is_verb & okc
    order_l = torch.where(is_verb, 0, order)
    cur = rel
    k = torch.zeros(F, dtype=i64, device=dev)
    nb = order_l.clone()
    bad = torch.zeros(F, dtype=torch.bool, device=dev)
    bases = torch.zeros((F, NC), dtype=i64, device=dev)
    values = torch.zeros((F, NC * 32), dtype=i64, device=dev)
    advance = torch.zeros((F, NC * 32), dtype=i64, device=dev)
    k_emit = torch.zeros((F, NC * 32), dtype=i64, device=dev)
    full = (torch.ones_like(pbits) << pbits) - 1
    for t in range(NC * 32):
        if t % 32 == 0:
            bases[:, t // 32] = cur
        act_r = resd_l & (t >= order_l) & (t < bs)
        act_v = verb_l & (t < bs)
        h = rd.peek(cur)
        first = act_r & (t == nb)
        kr = _top(h, pbits)
        k = torch.where(first, kr, k)
        sh = torch.where(first, pbits, 0)
        h2 = (h << sh) & _M32
        zz = _clz32(h2)
        adv = sh + zz + 1 + k
        bad |= act_r & ((first & (kr == full)) | (adv > 32))
        kc = k.clamp(max=31)
        rsh = (32 - zz - 1 - k).clamp(0, 31)
        r = (h2 >> rsh) & torch.where(k == 0, 0, (torch.ones_like(kc) << kc) - 1)
        v = ((zz << kc) & _M32) | r
        rice = torch.where((v & 1) != 0, (~(v >> 1)) & _M32, v >> 1)
        vb = _sext(_top(h, sf_r), sf_r)
        val = torch.where(act_r, rice, torch.where(act_v, vb, 0))
        values[:, t] = val
        advance[:, t] = torch.where(act_r, adv.clamp(max=32),
                                    torch.where(act_v, sf_r, 0))
        cur = cur + advance[:, t]
        nb = torch.where(first, torch.where(t == order_l, ps_s, t + ps_s), nb)
        k_emit[:, t] = k
    okc &= ~bad

    # ks[p]: k after position t_p (t_0 = order, t_p = p * ps), clipped to
    # T - 1, for p below the partition count.
    p = torch.arange(P_CAP, dtype=i64, device=dev)[None, :]
    t_p = torch.where(p == 0, order[:, None], p * ps_s[:, None]).clamp(0, T - 1)
    ks = torch.gather(k_emit, 1, t_p)
    ks = torch.where(p < n_parts[:, None], ks, 0)
    ks = torch.where(is_verb[:, None] & (p == 0), sf_bps[:, None], ks)
    ks = torch.where(is_const[:, None], 0, ks)
    out["ks"].append(ks)
    out["bases"].append(bases)
    out["values"].append(((values + (1 << 31)) & _M32) - (1 << 31))
    out["deltas"].append(advance)

    # Largest chunk span in bits, from the int32 chunk bases.
    b32 = ((bases + (1 << 31)) & _M32) - (1 << 31)
    end32 = ((cur + (1 << 31)) & _M32) - (1 << 31)
    ncl = (bs + 31) >> 5
    c = torch.arange(NC, dtype=i64, device=dev)[None, :]
    nxt = torch.where(c + 1 < ncl[:, None],
                      torch.cat([b32[:, 1:], b32[:, -1:]], dim=1),
                      end32[:, None])
    span = torch.where(c < ncl[:, None], nxt - b32, 0)
    span_max = span.max(dim=1).values.clamp(min=0)
    out["sa_words"].append(torch.where(is_const, 0, (span_max >> 5) + 2))
    okc &= is_const | (span_max <= 64 * 32)
    return cur, ok & okc


def walk_frames_plain(stream, start_bits, bs, modes, bps0, T, nch,
                      deltas=False):
    """The plain PyTorch form.

    Args:
      stream:     (W,) int32 big-endian words.
      start_bits: (F,) int32 bit position of each frame's first subframe.
      bs:         (F,) int32 block sizes (padding frames: 0).
      modes:      (F,) int32 channel assignment (0 independent, 1 left/side,
                  2 right/side, 3 mid/side).
      bps0:       (F,) int32 bits per sample from the header.
      T, nch:     block-size bucket and channel count.
      deltas:     also return each code's bit advance, ``out["deltas"]``
                  ((F * nch, NC * 32) int8: the cursor step, with the Rice
                  parameter at a partition's first code; 0 at warm-up,
                  padding and constant lanes).

    Returns:
      (out, end_bits, ok): ``out`` maps each of ``WALK_KEYS`` to an int32
      tensor with F * nch rows (row f * nch + c is frame f, channel c);
      ``end_bits`` (F,) int32 is each frame's byte-aligned end bit (before
      the CRC-16); ``ok`` (F,) bool.
    """
    i64 = torch.int64
    rd = _Reader(stream)
    F = start_bits.shape[0]
    pos = start_bits.to(i64)
    b = bs.to(i64)
    m = modes.to(i64)
    ok = (b >= 1) & (b <= T)
    out = {k: [] for k in WALK_KEYS + ("deltas",)}
    for ch in range(nch):
        if nch == 2:
            side = torch.where(((ch == 1) & ((m == 1) | (m == 3)))
                               | ((ch == 0) & (m == 2)), 1, 0)
        else:
            side = torch.zeros_like(m)
        pos, ok = _walk_subframe(rd, out, pos, b, bps0.to(i64) + side, T, ok)
    shapes = _lane_shapes(F * nch, T)
    merged = {k: torch.stack(out[k], dim=1).reshape(shapes[k])
              .to(torch.int32) for k in WALK_KEYS}
    if deltas:
        merged["deltas"] = torch.stack(out["deltas"], dim=1).reshape(
            shapes["values"]).to(torch.int8)
    end_bits = ((pos + 7) & ~7).to(torch.int32)
    return merged, end_bits, ok


def walk_frames(stream, start_bits, bs, modes, bps0, T, nch, deltas=False):
    """K7 wrapper: the plain form for CPU tensors; for CUDA tensors the
    hand-written kernel (``csrc/demux.cu``), or an exception. Same
    arguments and results as :func:`walk_frames_plain`."""
    args = (stream, start_bits, bs, modes, bps0)
    if on_cpu(*args):
        return walk_frames_plain(*args, T, nch, deltas)
    dev = require_cuda_int32("walk_frames", stream=stream,
                             start_bits=start_bits, bs=bs, modes=modes,
                             bps0=bps0)
    F = start_bits.shape[0]
    if stream.dim() != 1 or any(a.shape != (F,) for a in args[1:]):
        raise ValueError("walk_frames: expected a (W,) stream and (F,) "
                         "start_bits/bs/modes/bps0")
    if not 1 <= T <= 65535 or nch < 1:
        raise ValueError("walk_frames: T must be in [1, 65535], nch >= 1")
    lib = _build.load()
    shapes = _lane_shapes(F * nch, T)
    out = {k: torch.empty(s, dtype=torch.int32, device=dev)
           for k, s in shapes.items()}
    if deltas:
        out["deltas"] = torch.empty(shapes["values"], dtype=torch.int8,
                                    device=dev)
    end_bits = torch.empty((F,), dtype=torch.int32, device=dev)
    ok = torch.empty((F,), dtype=torch.bool, device=dev)
    # Scratch: each chunk's cursor and Rice parameter, each lane's shape.
    state = torch.empty((F * nch * ((T + 31) // 32),), dtype=torch.int64,
                        device=dev)
    desc = torch.empty((F * nch, 4), dtype=torch.int32, device=dev)
    _build.check(lib.cxk_walk_frames(
        stream.data_ptr(), stream.shape[0], start_bits.data_ptr(),
        bs.data_ptr(), modes.data_ptr(), bps0.data_ptr(), F, T, nch,
        *(out[k].data_ptr() for k in WALK_KEYS),
        out["deltas"].data_ptr() if deltas else None, end_bits.data_ptr(),
        ok.data_ptr(), state.data_ptr(), desc.data_ptr(),
        _build.stream_handle(dev)), "cxk_walk_frames")
    walk_frames.launches += 1
    walk_frames.delta_launches += int(bool(deltas))
    return out, end_bits, ok


#: launches through the wrapper (CUDA tensors only); each is one call of
#: ``cxk_walk_frames``, which runs the walk kernel, then the values kernel
#: (its delta-writing form when ``deltas=True``, also counted in
#: ``delta_launches``).
walk_frames.launches = 0
walk_frames.delta_launches = 0
