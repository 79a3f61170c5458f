"""The port's device operators (claxon_tpu_torch.ops) against the JAX
package's, on the CPU: the same numpy inputs, made from seeds, go through
both, and every output must be equal (tolerance 0: all values are
integers). On the CPU each wrapper takes its plain PyTorch form; the CUDA
kernels are held to those forms on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from claxon_tpu import native
from claxon_tpu.crc import crc16
from claxon_tpu.ops.crc import crc16_ranges_device
from claxon_tpu.ops.entropy import (decode_residual_bits,
                                    decode_residual_bits_stream,
                                    decode_residual_bits_stream_delta,
                                    decode_residual_bits_stream_reference)
from claxon_tpu.ops.epilogue import (apply_epilogue, pack_int16_pairs,
                                     unpack_int16_pairs)
from claxon_tpu.ops.pallas_synth import synthesize_pallas
from claxon_tpu.ops.predict import synthesize, synthesize_reference
from claxon_tpu.testing import encode_flac, synth_music

from claxon_tpu_torch import crc as thost_crc
from claxon_tpu_torch.ops import crc as tcrc
from claxon_tpu_torch.ops import entropy as tentropy
from claxon_tpu_torch.ops import epilogue as tepilogue
from claxon_tpu_torch.ops import predict as tpredict

ORDER_MAX = 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# Golden vectors of tests/test_ops.py (the reference's own test cases):
# (coefs oldest-first, x = warm-up ++ residuals, shift, expected output).
_GOLDEN = [
    ([-75, 166, 121, -269, -75, -399, 1042],
     [-796, -547, -285, -32, 199, 443, 670, -2, -23, 14, 6, 3, -4, 12, -2,
      10], 9,
     [-796, -547, -285, -32, 199, 443, 670, 875, 1046, 1208, 1343, 1454,
      1541, 1616, 1663, 1701]),
    ([119, -255, 555, -836, 879, -1199, 1757],
     [-21363, -21951, -22649, -24364, -27297, -26870, -30017, 3157], 10,
     [-21363, -21951, -22649, -24364, -27297, -26870, -30017, -29718]),
    ([709, -2589, 4600, -4612, 1350, 4220, -9743, 12671, -12129, 8586,
      -3775, -645, 3904, -5543, 4373, 182, -6873, 13265, -15417, 11550],
     [213238, 210830, 234493, 209515, 235139, 201836, 208151, 186277,
      157720, 148176, 115037, 104836, 60794, 54523, 412, 17943, -6025,
      -3713, 8373, 11764, 30094], 12, None),  # last output 33931
    ([1, -3, 3],
     [-729, -722, -667, -19, -16, 17, -23, -7, 16, -16, -5, 3, -8, -13, -15,
      -1], 0,
     [-729, -722, -667, -583, -486, -359, -225, -91, 59, 209, 354, 497, 630,
      740, 812, 845]),
    ([-1, 2], [21877, 27482, -6513], 0, [21877, 27482, 26574]),
    ([], [5, -3, 100, -(1 << 30)], 0, [5, -3, 100, -(1 << 30)]),
]


def _synth_batch():
    """One (L, T) batch: the golden lanes, then random lanes at the
    edges -- order 32, shift 15, |c| = 2^15 - 1, samples over the whole
    int32 range (so the add wraps) -- with random valid lengths."""
    rng = np.random.default_rng(11)
    L, T = 32, 64
    x = np.zeros((L, T), np.int32)
    coefs = np.zeros((L, ORDER_MAX), np.int32)
    shifts = np.zeros(L, np.int32)
    orders = np.zeros(L, np.int32)
    lengths = np.full(L, T, np.int32)
    for l, (c, xs, sh, _want) in enumerate(_GOLDEN):
        x[l, :len(xs)] = xs
        if c:
            coefs[l, ORDER_MAX - len(c):] = c
        shifts[l], orders[l], lengths[l] = sh, len(c), len(xs)
    n = len(_GOLDEN)
    r = L - n
    x[n:] = rng.integers(-(1 << 31), 1 << 31, (r, T), dtype=np.int64)
    orders[n:] = rng.integers(0, ORDER_MAX + 1, r)
    orders[n:n + 8] = ORDER_MAX
    shifts[n:] = rng.integers(0, 16, r)
    shifts[n:n + 4] = 15
    lengths[n:] = rng.integers(T // 2, T + 1, r)
    lim = (1 << 15) - 1
    for l in range(n, L):
        o = int(orders[l])
        if o:
            coefs[l, ORDER_MAX - o:] = rng.integers(-lim, lim + 1, o)
    coefs[n:n + 2, :] = np.where(rng.integers(0, 2, (2, ORDER_MAX)) == 1,
                                 lim, -lim)
    return x, coefs, shifts, orders, lengths


def test_synthesize_matches_jax_pallas_reference_and_golden():
    x, coefs, shifts, orders, lengths = _synth_batch()
    got = tpredict.synthesize(_t(x), _t(coefs), _t(shifts), _t(orders),
                              _t(lengths)).numpy()
    args = [jnp.asarray(a) for a in (x, coefs, shifts, orders, lengths)]
    assert np.array_equal(got, np.asarray(synthesize(*args)))
    # The Pallas kernel runs in interpret mode off the TPU.
    assert np.array_equal(got, np.asarray(synthesize_pallas(*args,
                                                            chunk=64)))
    ref = synthesize_reference(x, coefs, shifts, orders)
    t = np.arange(x.shape[1])[None, :]
    assert np.array_equal(np.where(t < lengths[:, None], ref, 0), got)
    for l, (_c, xs, _sh, want) in enumerate(_GOLDEN):
        out = got[l, :len(xs)].tolist()
        assert out == want if want is not None else out[-1] == 33931


def test_ops_exports_match_jax():
    """``claxon_tpu_torch.ops`` exports the JAX package's names but ``i64``
    (its 32-bit limb arithmetic; CUDA has int64): ``synthesize_reference``
    with JAX's signature gives JAX's oracle's output, ``synthesize_best``
    is the device's pick (the plain form on the CPU), ``apply_epilogue``
    is K3's plain form."""
    import claxon_tpu.ops as jops

    import claxon_tpu_torch.ops as tops

    assert sorted(tops.__all__) == sorted(set(jops.__all__) - {"i64"})
    assert all(hasattr(tops, name) for name in tops.__all__)
    x, coefs, shifts, orders, lengths = _synth_batch()
    want = synthesize_reference(x, coefs, shifts, orders)
    got = tops.synthesize_reference(x, coefs, shifts, orders)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    best = tops.synthesize_best(_t(x), _t(coefs), _t(shifts), _t(orders),
                                _t(lengths))
    assert torch.equal(best, tpredict.synthesize(
        _t(x), _t(coefs), _t(shifts), _t(orders), _t(lengths)))
    assert tops.apply_epilogue is tepilogue.apply_epilogue


def test_synthesize_wrapper_refuses_non_cpu_tensors():
    """For a tensor that is not on the CPU the wrapper launches its kernel
    or raises; it never falls back to the plain form."""
    meta = [torch.empty(s, dtype=torch.int32, device="meta")
            for s in ((4, 8), (4, ORDER_MAX), (4,), (4,), (4,))]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpredict.synthesize(*meta)
    assert tpredict.synthesize.launches == 0
    with pytest.raises(ValueError, match="several devices"):
        tpredict.synthesize(torch.zeros((4, 8), dtype=torch.int32),
                            *meta[1:])


def test_synthesize_epilogue_plain_matches_jax():
    """K1 + K3, the fused kernel's plain form (the CPU route), against the
    JAX package's synthesis followed by its epilogue: every mode code 0-7
    (4-7 pass through), wasted bits 0, 1, 15 and 31 on both lanes of a
    pair, samples over the whole int32 range."""
    x, coefs, shifts, orders, lengths = _synth_batch()
    L = x.shape[0]
    wasted = np.array([0, 1, 15, 31], np.int32)[(np.arange(L) + np.arange(L)
                                                 // 16) % 4]
    pair_modes = np.tile(np.arange(8, dtype=np.int32), L // 16)
    args = (x, coefs, shifts, orders, lengths, wasted, pair_modes)
    got = tpredict.synthesize_epilogue(*(_t(a) for a in args)).numpy()
    want = np.asarray(apply_epilogue(
        synthesize(*(jnp.asarray(a) for a in args[:5])),
        jnp.asarray(wasted), jnp.asarray(pair_modes)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tpredict.synthesize_epilogue_plain(
        *(_t(a) for a in args)).numpy())
    meta = [torch.empty(a.shape, dtype=torch.int32, device="meta")
            for a in args]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpredict.synthesize_epilogue(*meta)
    assert tpredict.synthesize_epilogue.launches == 0


def test_epilogue_matches_jax_all_modes():
    rng = np.random.default_rng(12)
    L, T = 16, 32
    samples = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64) \
        .astype(np.int32)
    samples[:L // 2] >>= rng.integers(0, 20, (L // 2, 1)).astype(np.int32)
    samples[0, :4] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, -1, 1]
    samples[1, :4] = [np.iinfo(np.int32).max, 1, np.iinfo(np.int32).min, -1]
    wasted = rng.integers(0, 8, L).astype(np.int32)
    wasted[2] = 31
    pair_modes = np.tile(np.arange(4, dtype=np.int32), L // 8)
    got = tepilogue.apply_epilogue(_t(samples), _t(wasted),
                                   _t(pair_modes)).numpy()
    want = np.asarray(apply_epilogue(jnp.asarray(samples),
                                     jnp.asarray(wasted),
                                     jnp.asarray(pair_modes)))
    assert np.array_equal(got, want)


def test_epilogue_golden():
    # tests/test_ops.py's golden triples (reference `src/frame.rs`).
    samples = np.array([[-2, -14, 12, -6], [7, 38, 142, 238],
                        [2, 5, 83, 113], [7, 38, 142, 238],
                        [7, 38, 142, 238], [-5, -33, -59, -125],
                        [1, -2, 3, -4], [0, 0, 0, 0]], np.int32)
    wasted = np.array([0, 0, 0, 0, 0, 0, 4, 0], np.int32)
    out = tepilogue.apply_epilogue(_t(samples), _t(wasted),
                                   _t(np.array([3, 1, 2, 0], np.int32)))
    assert out.tolist() == [[2, 5, 83, 113], [-5, -33, -59, -125],
                            [2, 5, 83, 113], [-5, -33, -59, -125],
                            [2, 5, 83, 113], [-5, -33, -59, -125],
                            [16, -32, 48, -64], [0, 0, 0, 0]]


def _pack_case(case):
    """(L, T) int32 inputs for K3b, made from a seed."""
    rng = np.random.default_rng(51)
    i32 = np.iinfo(np.int32)
    if case == "in_range":
        return rng.integers(-32768, 32768, (6, 64)).astype(np.int32)
    if case == "boundary":  # the last values inside int16, nothing outside
        x = np.zeros((4, 8), np.int32)
        x[0, :4] = [32767, -32768, -1, 1]
        x[3, -2:] = [-32768, 32767]
        return x
    if case == "just_outside":  # one lane each of 32768 and -32769
        x = rng.integers(-32768, 32768, (4, 8)).astype(np.int32)
        x[1, 3] = 32768
        x[2, 0] = -32769
        return x
    if case == "last_element":  # only the last column of the last lane
        x = np.zeros((5, 6), np.int32)
        x[-1, -1] = 40000
        return x
    if case == "int32_extremes":
        x = rng.integers(-32768, 32768, (4, 4)).astype(np.int32)
        x[0, :2] = [i32.max, i32.min]
        x[2, 2:] = [i32.min, i32.max]
        return x
    if case == "garbage":
        return rng.integers(i32.min, i32.max + 1, (8, 32),
                            dtype=np.int64).astype(np.int32)
    if case == "T2":
        return np.array([[5, -7], [-32768, 32767], [0, 70000]], np.int32)
    raise AssertionError(case)


PACK_CASES = ["in_range", "boundary", "just_outside", "last_element",
              "int32_extremes", "garbage", "T2"]


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["scalar_flag", "per_lane"])
@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_int16_pairs_matches_jax(case, per_lane):
    x = _pack_case(case)
    words, flag = tepilogue.pack_int16_pairs(_t(x), per_lane=per_lane)
    j_words, j_flag = pack_int16_pairs(jnp.asarray(x), per_lane=per_lane)
    assert words.dtype == flag.dtype == torch.int32
    assert words.shape == (x.shape[0], x.shape[1] // 2)
    assert flag.shape == ((x.shape[0],) if per_lane else ())
    assert np.array_equal(words.numpy(), np.asarray(j_words))
    assert np.array_equal(flag.numpy(), np.asarray(j_flag))
    oob = (x > 32767) | (x < -32768)
    assert np.array_equal(flag.numpy() != 0,
                          oob.any(axis=1) if per_lane else oob.any())
    if not oob.any():
        # A little-endian host reads the words back as the int16 samples.
        assert np.array_equal(words.numpy().view(np.int16), x)
        assert np.array_equal(
            tepilogue.unpack_int16_pairs(words).numpy(), x)


@pytest.mark.parametrize("case", PACK_CASES)
def test_unpack_int16_pairs_matches_jax(case):
    """Any int32 words unpack as the JAX function unpacks them: each half
    sign-extended, the low half first."""
    w = _pack_case(case)
    got = tepilogue.unpack_int16_pairs(_t(w)).numpy()
    assert got.shape == (w.shape[0], 2 * w.shape[1])
    assert np.array_equal(got, np.asarray(unpack_int16_pairs(
        jnp.asarray(w))))
    assert np.array_equal(got, w.view(np.int16).astype(np.int32))


@pytest.mark.parametrize("name", ["pack_int16_pairs", "unpack_int16_pairs"])
def test_pack16_wrappers_check_their_input(name):
    """An odd T or a tensor that is not 2-D raises; for a tensor that is
    not on the CPU the wrapper launches its kernel or raises, and never
    takes the plain form."""
    fn = getattr(tepilogue, name)
    with pytest.raises(ValueError, match="expected"):
        fn(torch.zeros(8, dtype=torch.int32))
    if name == "pack_int16_pairs":
        with pytest.raises(ValueError, match="T even"):
            fn(torch.zeros((2, 3), dtype=torch.int32))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(torch.empty((4, 8), dtype=torch.int32, device="meta"))
    assert fn.launches == before


def _captured_datas():
    """Streams with eight partitions, verbatim subframes and constant
    subframes, all at block size 1024 stereo."""
    pcm = synth_music(2048, channels=2, bps=16, seed=3)
    const = np.zeros_like(pcm)
    const[:, 0] = 77
    return [encode_flac(pcm, 44100, 16, block_size=1024, partition_order=3),
            encode_flac(pcm, 44100, 16, block_size=1024,
                        force_subframe="verbatim"),
            encode_flac(const, 44100, 16, block_size=1024)]


def _captured_bucket():
    """A real stream-mode bucket from the port's planner: the streams of
    :func:`_captured_datas` share one (T, nch) bucket."""
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits, unpack_mb

    datas = _captured_datas()
    bp = plan_raw_bits(extract_streams_bits(datas, native), 128)
    assert len(bp.bits) == 1 and not bp.samples
    b = bp.bits[0]
    u = {k: v.numpy() for k, v in
         unpack_mb(_t(b.mb), b.n_parts_max, b.nc).items()}
    flags = u["flags"][u["lengths"] > 0]
    assert (flags & 1).any() and (flags & 2).any()
    assert b.n_parts_max == 8
    return bp.stream, u, b.n_parts_max, b.sa


def test_entropy_matches_jax_and_reference_on_captured_bucket():
    stream, u, P, SA = _captured_bucket()
    args = (stream, u["bases"], u["ks"], u["ps"], u["orders"], u["pbits"],
            u["flags"], u["warm"], u["lengths"])
    got = tentropy.decode_residual_bits_stream(
        *(_t(a) for a in args), n_parts_max=P, sa=SA).numpy()
    want = np.asarray(decode_residual_bits_stream(
        *(jnp.asarray(a) for a in args), n_parts_max=P, sa=SA))
    assert np.array_equal(got, want)
    ref = decode_residual_bits_stream_reference(*args, n_parts_max=P)
    assert np.array_equal(got, ref)


def test_entropy_matches_jax_on_garbage():
    """Fuzzed inputs -- bases past either end of the stream, Rice
    parameters outside [0, 32], garbage partition sizes and orders --
    must give the JAX program's exact output (the same index clamps and
    the same shift-by->=32 results), never a fault."""
    rng = np.random.default_rng(13)
    L, NC, P, SA, W = 8, 2, 4, 5, 64
    stream = rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64) \
        .astype(np.int32)
    stream[::7] = 0  # long zero runs: empty 64-bit windows
    bases = rng.integers(-4096, 32 * W + 4096, (L, NC)).astype(np.int32)
    ks = rng.integers(-40, 40, (L, P)).astype(np.int32)
    ps = rng.integers(-3, 40, L).astype(np.int32)
    orders = rng.integers(0, 40, L).astype(np.int32)
    pbits = rng.integers(0, 8, L).astype(np.int32)
    flags = rng.integers(0, 8, L).astype(np.int32)
    warm = rng.integers(-1000, 1000, (L, 32)).astype(np.int32)
    lengths = rng.integers(0, NC * 32 + 8, L).astype(np.int32)
    args = (stream, bases, ks, ps, orders, pbits, flags, warm, lengths)
    got = tentropy.decode_residual_bits_stream(
        *(_t(a) for a in args), n_parts_max=P, sa=SA).numpy()
    want = np.asarray(decode_residual_bits_stream(
        *(jnp.asarray(a) for a in args), n_parts_max=P, sa=SA))
    assert np.array_equal(got, want)


def _k2_model(stream, bases, ks, ps, orders, pbits, flags, warm, lengths,
              P, SA):
    """numpy model of the K2 kernel (csrc/entropy.cu), one row per thread:
    warps of 32 consecutive chunks, the slot words staged per warp in rows
    of stride SA | 1 (the kernel's item loop and shuffle), the partition
    index counted incrementally where its thresholds cannot wrap, the
    values written to a tile of row stride 33 and stored from it as
    16-byte items."""
    M, IMAX = 0xFFFFFFFF, (1 << 31) - 1
    i64 = np.int64
    L, NC = bases.shape
    n, W, WM = L * NC, stream.size, warm.shape[1]
    sap = SA | 1
    s = stream.astype(i64) & M
    base = bases.reshape(-1).astype(i64)
    wi0 = base >> 5
    out = np.zeros(n * 32, i64)

    def wrap(v):
        return ((v + (1 << 31)) & M) - (1 << 31)

    def funnel_l(lo, hi, sh):  # __funnelshift_l: (hi:lo << sh) >> 32
        sh = sh & 31
        return np.where(sh == 0, hi, ((hi << sh) & M) | (lo >> (32 - sh)))

    def shl(v, sh):
        return np.where((sh >= 0) & (sh < 32), (v << np.clip(sh, 0, 31)) & M,
                        0)

    def shr(v, sh):
        return np.where((sh >= 0) & (sh < 32), v >> np.clip(sh, 0, 31), 0)

    def clz32(v):
        return np.where(v == 0, 32, 31 - np.floor(np.log2(
            np.maximum(v, 1).astype(np.float64))).astype(i64))

    for i0 in range(0, n, 32):
        nv = min(32, n - i0)
        lane = np.arange(nv)
        words = np.zeros(32 * sap, i64)
        total = nv * SA
        e = np.arange((total + 31) & ~31)
        c = e // SA
        src = c & 31
        w = np.where(src < nv, wi0[i0 + np.minimum(src, nv - 1)], 0)
        ok = e < total
        words[(c * sap + e - c * SA)[ok]] = s[np.clip(
            w + e - c * SA, 0, W - 1)[ok]]
        i = i0 + lane
        ln, ch = i // NC, i % NC
        order, ps_b = orders[ln].astype(i64), np.maximum(ps[ln], 1).astype(i64)
        pb, fl, length = pbits[ln].astype(i64), flags[ln], lengths[ln]
        verb, has_codes = (fl & 1) != 0, (fl & 2) == 0
        t0 = ch * 32
        mono = (P - 1) * ps_b < (1 << 31)
        p = np.where(mono, np.minimum(t0 // ps_b, P - 1), 0)
        nxt = np.where(mono & (p + 1 < P), (p + 1) * ps_b, IMAX)
        k = ks[ln, p].astype(i64)
        cursor = base[i] & 31
        tile = np.zeros((32, 33), i64)
        m = np.arange(1, P)[None, :]
        for j in range(32):
            t = t0 + j
            q = (t[:, None] >= wrap(m * ps_b[:, None])).sum(1)
            step = mono & (t >= nxt)
            p = np.where(mono, p + step, q)
            nxt = np.where(step, np.where(p + 1 < P, nxt + ps_b, IMAX), nxt)
            k = ks[ln, p].astype(i64)
            active = (t >= order) & (t < length) & has_codes
            pstart = np.where(p == 0, order, wrap(p * ps_b))
            pos = wrap(cursor + np.where((t == pstart) & ~verb, pb, 0))
            wi = np.clip(pos >> 5, 0, SA - 1)
            off = pos & 31
            row = lane * sap
            w0 = words[row + wi]
            w1 = np.where(wi + 1 <= SA - 1, words[row + np.minimum(
                wi + 1, SA - 1)], 0)
            w2 = np.where(wi + 2 <= SA - 1, words[row + np.minimum(
                wi + 2, SA - 1)], 0)
            hi, lo = funnel_l(w1, w0, off), funnel_l(w2, w1, off)
            z = np.where(hi != 0, clz32(hi), 32 + clz32(lo))
            s1 = z + 1
            rhi = np.where(s1 < 32, funnel_l(lo, hi, s1),
                           (lo << np.minimum(s1 - 32, 31)) & M)
            r = np.where(k == 0, 0, shr(rhi, 32 - k))
            v = shl(z, k) | r
            rice = np.where(v & 1, ~(v >> 1) & M, v >> 1)
            rv = np.where(k == 0, 0, shr(hi, 32 - k))
            sbit = shl(np.ones_like(k), np.maximum(k - 1, 0))
            vb = (rv ^ sbit) - sbit
            res = wrap(np.where(verb, vb, rice))
            adv = np.where(verb, k, s1 + k)
            cursor = np.where(active, wrap(pos + adv), cursor)
            val = np.where(active, res, 0)
            warm_t = warm[ln, np.minimum(t, WM - 1)] if WM else 0
            val = np.where(t < order, np.where(t < WM, warm_t, 0), val)
            tile[lane, j] = val
        v = np.arange(nv * 8)
        for q4 in range(4):
            out[i0 * 32 + 4 * v + q4] = tile[v >> 3, 4 * (v & 7) + q4]
    return out.reshape(L, NC * 32).astype(np.int32)


@pytest.mark.parametrize("case", ["captured", "garbage", "fuzzed_ps",
                                  "ragged"])
def test_k2_model_matches_plain(case):
    """The numpy model of the K2 kernel's warp layout, staging, partition
    count and tile store equals the plain form (held to the JAX program
    by the tests above) on a captured bucket, fuzzed inputs, partition
    sizes whose thresholds wrap and a chunk count that fills no warp."""
    rng = np.random.default_rng(25)
    if case == "captured":
        stream, u, P, SA = _captured_bucket()
        args = [stream] + [u[k] for k in ("bases", "ks", "ps", "orders",
                                          "pbits", "flags", "warm",
                                          "lengths")]
        sas = (SA, 5, 66)
    else:
        L, NC, P, W = {"garbage": (8, 4, 4, 64), "fuzzed_ps": (8, 4, 64, 64),
                       "ragged": (7, 3, 2, 40)}[case]
        stream = rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64)
        stream[::7] = 0
        args = [stream, rng.integers(-4096, 32 * W + 4096, (L, NC)),
                rng.integers(-40, 40, (L, P)), rng.integers(-3, 40, L),
                rng.integers(0, 40, L), rng.integers(0, 8, L),
                rng.integers(0, 8, L), rng.integers(-1000, 1000, (L, 32)),
                rng.integers(0, NC * 32 + 8, L)]
        if case == "fuzzed_ps":
            args[3] = np.resize(np.array([-5, 1, (1 << 31) - 1, (1 << 30) + 1,
                                          3 << 29, (1 << 31) // 63, 2, 100]),
                                L)
        sas = (1, 17, 40)
    args = [np.asarray(a).astype(np.int32) for a in args]
    for sa in sas:
        want = tentropy.decode_residual_bits_stream_plain(
            *(_t(a) for a in args), n_parts_max=P, sa=sa).numpy()
        assert np.array_equal(_k2_model(*args, P=P, SA=sa), want), sa


def _delta_args(b):
    """K9's arguments for a delta-mode bucket, as ``delta_step`` takes them
    from its ``meta`` columns."""
    m = b.meta
    return (b.slots, b.deltas, b.ks, m[:, 3], m[:, 0], m[:, 4], m[:, 5] & 1,
            m[:, 8:40])


def test_k9_matches_jax_on_delta_buckets():
    """K9's plain form equals the JAX package's decode_residual_bits on
    the port's delta-mode buckets (eight partitions, verbatim and
    constant subframes), and decodes the residuals K2 decodes from the
    same streams in stream mode."""
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits

    datas = _captured_datas()
    bp = plan_raw_bits(extract_streams_bits(datas, native, "delta"), 128,
                       "delta")
    assert bp.stream is None and bp.se is None and not bp.samples
    assert len(bp.bits) >= 2  # one bucket per slot class
    stream, u, P, SA = _captured_bucket()
    want_k2 = tentropy.decode_residual_bits_stream(
        *(_t(u[k]) if k != "stream" else _t(stream) for k in (
            "stream", "bases", "ks", "ps", "orders", "pbits", "flags",
            "warm", "lengths")), n_parts_max=P, sa=SA).numpy()
    lanes = 0
    for b in bp.bits:
        args = _delta_args(b)
        got = tentropy.decode_residual_bits(
            *(_t(a) for a in args), n_parts_max=b.n_parts_max,
            sa=b.sa).numpy()
        want = np.asarray(decode_residual_bits(
            *(jnp.asarray(a) for a in args), n_parts_max=b.n_parts_max,
            sa=b.sa))
        assert np.array_equal(got, want)
        # The same subframes' residuals as K2's (stream-mode lane order is
        # stream, then frame, then channel, as a run's lanes are here).
        for si, out0, nf, bs, nch, lane0 in b.plan:
            for f in range(nf):
                for c in range(nch):
                    row = lane0 + f * nch + c
                    k2_row = (sum(len(_frames(d)) for d in datas[:si]) * 2
                              + out0 // 1024 * 2 + f * nch + c)
                    assert np.array_equal(got[row, :bs],
                                          want_k2[k2_row, :bs])
                    lanes += 1
    assert lanes == sum(len(_frames(d)) for d in datas) * 2


def _frames(data):
    return native.extract_stream_bits(data, emit_slots=False,
                                      defer_crc=True)[1].bframes


def test_k10_matches_jax_on_walk_inputs(monkeypatch):
    """K10's plain form equals the JAX package's decode_residual_bits_
    stream_delta on the inputs the segmented delta decode gives it: the
    walk's int8 deltas and chunk bases of two stereo streams."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import entropy

    calls = []
    fn = entropy.decode_residual_bits_stream_delta

    def spy(*args, **kw):
        calls.append(([a.numpy() for a in args], kw))
        return fn(*args, **kw)

    monkeypatch.setattr(entropy, "decode_residual_bits_stream_delta", spy)
    monkeypatch.setenv("CLAXON_TPU_SEG_ENTROPY", "delta")
    datas = _captured_datas()[:2]
    out = ct.decode_streams_device(datas, segmentation="device",
                                   device="cpu").to_host()
    for d, r in zip(datas, out):
        assert np.array_equal(r.pcm, native.decode_stream_scalar(d)[1])
    assert calls
    for args, kw in calls:
        assert args[2].dtype == np.int8 and (args[2] > 0).any()
        got = fn(*(_t(a) for a in args), **kw).numpy()
        want = np.asarray(decode_residual_bits_stream_delta(
            *(jnp.asarray(a) for a in args), **kw))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("P, SA", [(1, 1), (4, 5)])
def test_delta_entropy_matches_jax_on_garbage(kernel, P, SA):
    """Fuzzed inputs (``test_torch_cuda.delta_garbage``): uint8 deltas up to
    255 and int8 deltas below 0, k of 0, 31, 32 and 40, partition sizes
    0 and negative, orders above 32, remainders before the chunk's first
    bit, bases outside the stream -- K9's and K10's plain forms give the
    JAX programs' exact output."""
    from test_torch_cuda import delta_garbage

    args = delta_garbage(kernel, 12, 3, P, SA, W=64, seed=P + SA)
    assert (args[1 if kernel == "K9" else 2] > 31).any()
    if kernel == "K9":
        assert args[1].max() == 255 and (args[4] > 32).any()
        assert (args[3] <= 0).any()
        fn, jfn = tentropy.decode_residual_bits, decode_residual_bits
    else:
        assert (args[2] < 0).any() and (args[1] < 0).any()
        fn, jfn = (tentropy.decode_residual_bits_stream_delta,
                   decode_residual_bits_stream_delta)
    assert set(np.unique(args[2 if kernel == "K9" else 3])) >= {0, 31, 32,
                                                                 40}
    got = fn(*(_t(a) for a in args), n_parts_max=P, sa=SA).numpy()
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args), n_parts_max=P,
                          sa=SA))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["decode_residual_bits",
                                  "decode_residual_bits_stream_delta"])
def test_delta_wrappers_refuse_non_cpu_tensors(name):
    """Given tensors that are not on the CPU, K9's and K10's wrappers
    launch their kernel or raise; they never fall back."""
    fn = getattr(tentropy, name)
    meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype,
                                                     device="meta")
    lane = [meta(4) for _ in range(4)]
    if name == "decode_residual_bits":
        args = (meta(4, 10), meta(4, 64, dtype=torch.uint8), meta(4, 1),
                *lane, meta(4, 32))
    else:
        args = (meta(40), meta(4, 2), meta(4, 64, dtype=torch.int8),
                meta(4, 1), *lane, meta(4, 32), meta(4))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args, n_parts_max=1, sa=5)
    assert fn.launches == before


#: csrc/entropy_delta.cu's staged limits (kMaxStagedSA, kMaxStagedKs).
_DELTA_MAX_STAGED_SA, _DELTA_MAX_STAGED_KS = 128, 2048
_M32 = 0xFFFFFFFF


def _wrap(v):
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def _shl(v, sh):
    return np.where((sh >= 0) & (sh < 32), (v << np.clip(sh, 0, 31)) & _M32,
                    0)


def _delta_inputs(kernel, args, SA):
    """(L, NC, flat words, flags, ps as the kernel takes it, lengths) of
    K9's or K10's arguments."""
    i64 = np.int64
    if kernel == "K9":
        slots, _deltas, _ks, ps, _orders, _pbits, vflags, _warm = args
        return (slots.shape[0], slots.shape[1] // SA,
                slots.reshape(-1).astype(i64) & _M32,
                (vflags != 0).astype(i64), ps.astype(i64), None)
    stream, bases, _deltas, _ks, ps, _orders, _pbits, flags, _warm, \
        lengths = args
    return (bases.shape[0], bases.shape[1], stream.astype(i64) & _M32,
            flags.astype(i64), np.maximum(ps, 1).astype(i64), lengths)


def _delta_walk_model(kernel, args, P, SA):
    """numpy model of the walk kernels of K9 (``kernel`` "K9") and K10
    ("K10") in csrc/entropy_delta.cu, every thread at once (rows: warps,
    columns: their 32 threads). Warp w takes chunks i0 = 32 w to i0 + nv -
    1 of the flat (L, NC) chunk grid (nv < 32 in the last warp; a warp may
    straddle lanes), thread j chunk i0 + j of lane l, first sample t0.
    Staged: the warp's words to rows of odd stride sp = (SA + 1) | 1 whose
    word SA is a zero, element e = r * SA + jj (K9: slot word i0 * SA +
    e; K10: stream word clip((bases >> 5) + jj, 0, W - 1), the base
    shuffled from thread r), (r, jj) moved 32 elements a step without a
    division; the Rice parameters of the warp's lanes l0 .. to rows of P.
    Warm-up samples go to the tile first (all 32 of a lane's first chunk,
    the walk then overwriting t >= order). Each thread walks its 32
    samples with a running sum of the deltas, the Rice parameter's shifts
    and masks set once a partition; where no thread of the warp meets a
    partition threshold or a warm-up sample the partition is not stepped.
    The values go to a tile of row stride 33 and leave as 16-byte items v
    = (chunk v // 8, values 4 * (v % 8) ...)."""
    M, IMAX, i64 = _M32, (1 << 31) - 1, np.int64
    deltas, ks, orders, pbits, warm = (
        (args[1], args[2], args[4], args[5], args[7]) if kernel == "K9"
        else (args[2], args[3], args[5], args[6], args[8]))
    L, NC, src, fl, ps_l, lengths = _delta_inputs(kernel, args, SA)
    WM = warm.shape[1]
    lanes = 2 if NC >= 32 else min(32, 31 // NC + 2)
    staged = SA <= _DELTA_MAX_STAGED_SA and lanes * P <= _DELTA_MAX_STAGED_KS
    sp = (SA + 1) | 1
    n = L * NC
    nw = -(-n // 32)
    lane = np.arange(32)[None, :]
    wrows = np.broadcast_to(np.arange(nw)[:, None], (nw, 32))
    i0 = np.arange(nw)[:, None] * 32
    nv = np.minimum(32, n - i0)
    live = lane < nv
    i = i0 + np.where(live, lane, 0)
    l, l0 = i // NC, i0 // NC
    t0 = (i - l * NC) * 32
    dflat = deltas.reshape(-1).astype(i64)  # int8 sign-extends
    if kernel == "K10":
        base = np.where(live, args[1].reshape(-1)[i], 0).astype(i64)

    def grid(nrows, ncols, source):
        """stage_grid's (row, column) walk over each warp's elements."""
        got = []
        step_r, step_c = divmod(32, ncols)
        r, cc = np.broadcast_to(lane // ncols, (nw, 32)), lane % ncols
        for it in range(ncols):
            ok = np.broadcast_to(it * 32 + lane < nrows * ncols, (nw, 32))
            got.append((r[ok], np.broadcast_to(cc, r.shape)[ok], wrows[ok],
                        source(r, cc)[ok]))
            r, cc = r + step_r, cc + step_c
            r, cc = r + (cc >= ncols), np.where(cc >= ncols, cc - ncols, cc)
        return [np.concatenate(x) for x in zip(*got)]

    rows = np.zeros((nw, 32 * sp), i64)
    ksm = np.zeros((nw, lanes * P), i64)
    if staged:
        if kernel == "K9":
            r, cc, w, v = grid(nv, SA, lambda r, cc: src[np.minimum(
                i0 * SA + r * SA + cc, src.size - 1)])
        else:
            r, cc, w, v = grid(nv, SA, lambda r, cc: src[np.clip(
                (np.take_along_axis(base, r & 31, axis=1) >> 5) + cc, 0,
                src.size - 1)])
        rows[w, r * sp + cc] = v
        nl = (i0 + nv - 1) // NC - l0 + 1
        r, cc, w, v = grid(nl, P, lambda r, cc: ks[np.minimum(l0 + r, L - 1),
                                                   cc])
        ksm[w, r * P + cc] = v

    def word(wi):
        if staged:
            return np.take_along_axis(rows, lane * sp + wi, axis=1)
        if kernel == "K9":
            return src[np.minimum(i * SA + wi, src.size - 1)]
        return src[np.clip((base >> 5) + wi, 0, src.size - 1)]

    def k_of(p):
        if staged:
            return np.take_along_axis(ksm, (l - l0) * P + p, axis=1)
        return ks[l, p].astype(i64)

    order, pb = orders[l].astype(i64), pbits[l].astype(i64)
    verb = (fl[l] & 1) != 0
    psv = ps_l[l]
    if kernel == "K10":
        active_end = np.where(fl[l] & 2, 0, lengths[l])

    def count(t):
        m = np.arange(1, P)[None, None, :]
        return (t[:, :, None] >= _wrap(m * psv[:, :, None])).sum(2)

    mono = (P <= 1) | ((psv >= 1) & ((P - 1) * psv < (1 << 31)))
    p = np.where(mono, 0 if P <= 1 else np.minimum(
        t0 // np.maximum(psv, 1), P - 1), count(t0))
    nxt = np.where(mono & (p + 1 < P), (p + 1) * psv, IMAX)
    fast = (~live | (mono & (nxt > t0 + 31) & (t0 >= order))).all(
        axis=1, keepdims=True)
    cur = (base & 31) if kernel == "K10" else np.zeros_like(t0)

    tile = np.zeros((nw, 32, 33), i64)
    for s_ in range(32):  # warm-up samples: a lane's first chunk whole,
        t = t0 + s_       # the chunks further on where t < order
        first = live & ((t0 == 0) | (t < order))
        wv = np.where(t < WM, warm[l, np.clip(t, 0, max(WM - 1, 0))]
                      if WM else 0, 0)
        tile[wrows[first], np.broadcast_to(lane, (nw, 32))[first],
             s_] = wv[first]
    for s_ in range(32):
        t = t0 + s_
        moved = t >= nxt
        p2 = np.where(mono, p + moved, count(t))
        nxt = np.where(fast | ~mono | ~moved, nxt,
                       np.where(p2 + 1 < P, nxt + psv, IMAX))
        p = np.where(fast, p, p2)
        k = k_of(p)
        kmin = np.minimum(k, 31)
        rmask = np.where((k >= 1) & (k <= 32), M, 0)
        qmask = np.where(kmin >= 0, M, 0)
        sbit = _shl(np.ones_like(k), np.maximum(_wrap(k - 1), 0))
        pstart = np.where(p == 0, order, _wrap(p * psv))
        d = dflat[np.minimum(i * 32 + s_, dflat.size - 1)]
        if kernel == "K10":
            d = np.where(verb, np.where((t >= order) & (t < active_end), k,
                                        0), d)
        q = (d - (k + 1) - np.where(t == pstart, pb, 0)) & M
        rpos = (cur + d - k) & M
        cur = (cur + d) & M
        wi = np.clip(_wrap(rpos) >> 5, 0, SA - 1)
        w0 = word(wi)
        if staged:
            w1 = word(wi + 1)
        else:
            w1 = np.where(wi + 1 <= SA - 1, word(np.minimum(wi + 1, SA - 1)),
                          0)
        off = rpos & 31
        win = np.where(off == 0, w0,
                       ((w0 << off) & M) | (w1 >> (32 - np.maximum(off, 1))))
        r = (win >> ((32 - k) & 31)) & rmask
        v = ((q << (kmin & 31)) & qmask) | r
        val = np.where(verb, ((r ^ sbit) - sbit) & M,
                       (v >> 1) ^ ((0 - (v & 1)) & M))
        val = np.where(d > 0, _wrap(val), 0)
        put = live & (t >= order)
        tile[wrows[put], np.broadcast_to(lane, (nw, 32))[put], s_] = val[put]

    out = np.zeros(n * 32, i64)
    v = np.arange(256)[None, :]
    ok = np.broadcast_to(v < nv * 8, (nw, 256))
    for q4 in range(4):
        vals = tile[np.arange(nw)[:, None], v >> 3, 4 * (v & 7) + q4]
        out[(i0 * 32 + 4 * v + q4)[ok]] = vals[ok]
    return out.reshape(L, NC * 32).astype(np.int32)


def _delta_sample_model(kernel, args, P, SA):
    """numpy model of the sample kernels of K9 and K10 in
    csrc/entropy_delta.cu: warp g takes chunk g of the flat (L, NC) grid,
    thread j its sample t = c * 32 + j; the chunk's SA words (K10: from
    word clip((bases >> 5) + j, 0, W - 1)) staged at [0, SA); the
    partition index t // ps where the thresholds cannot wrap, the count
    over P where they can; the in-chunk exclusive sum of the deltas by a
    warp scan."""
    M, i64 = _M32, np.int64
    deltas, ks, orders, pbits, warm = (
        (args[1], args[2], args[4], args[5], args[7]) if kernel == "K9"
        else (args[2], args[3], args[5], args[6], args[8]))
    L, NC, src, fl, ps_l, lengths = _delta_inputs(kernel, args, SA)
    WM, n = warm.shape[1], L * NC
    g = np.arange(n)[:, None]
    lane = np.arange(32)[None, :]
    l, c = g // NC, g % NC
    t = c * 32 + lane
    if kernel == "K9":
        words = src.reshape(n, SA)
        rbase = np.zeros_like(g)
    else:
        b = args[1].reshape(-1)[:, None].astype(i64)
        words = src[np.clip((b >> 5) + np.arange(SA)[None, :], 0,
                            src.size - 1)]
        rbase = b & 31
    order, pb, psv = orders[l].astype(i64), pbits[l].astype(i64), ps_l[l]
    verb = (fl[l] & 1) != 0
    mono = (P <= 1) | ((psv >= 1) & ((P - 1) * psv < (1 << 31)))
    m = np.arange(1, P)[None, None, :]
    p = np.where(mono, np.minimum(t // np.maximum(psv, 1), max(P - 1, 0)),
                 (t[:, :, None] >= _wrap(m * psv[:, :, None])).sum(2))
    k = ks[l, p].astype(i64)
    d = deltas.reshape(n, 32).astype(i64)
    if kernel == "K10":
        act = (t >= order) & (t < lengths[l]) & ((fl[l] & 2) == 0)
        d = np.where(verb, np.where(act, k, 0), d)
    ol = _wrap(np.cumsum(d, axis=1) - d)
    rpos = _wrap(rbase + ol + d - k)
    wi = np.clip(rpos >> 5, 0, SA - 1)
    off = rpos & 31
    wa = np.take_along_axis(words, wi, axis=1)
    wb = np.where(wi + 1 <= SA - 1, np.take_along_axis(
        words, np.minimum(wi + 1, SA - 1), axis=1), 0)
    win = np.where(off == 0, wa,
                   ((wa << off) & M) | (wb >> (32 - np.maximum(off, 1))))
    r = np.where(k == 0, 0, np.where((32 - k >= 0) & (32 - k < 32),
                                     win >> np.clip(32 - k, 0, 31), 0))
    pstart = np.where(p == 0, order, _wrap(p * psv))
    q = (d - 1 - k - np.where(t == pstart, pb, 0)) & M
    v = _shl(q, np.minimum(k, 31)) | r
    rice = np.where(v & 1, ~(v >> 1) & M, v >> 1)
    sbit = _shl(np.ones_like(k), np.maximum(_wrap(k - 1), 0))
    val = np.where(d > 0, _wrap(np.where(verb, ((r ^ sbit) - sbit) & M,
                                         rice)), 0)
    warm_t = np.where(t < WM, warm[l, np.clip(t, 0, max(WM - 1, 0))]
                      if WM else 0, 0)
    val = np.where(t < order, warm_t, val)
    return val.reshape(L, NC * 32).astype(np.int32)


#: (L, NC, P, SA) of the models' garbage cases: NC 1, 3, 31, 33 and 67
#: (lanes that straddle the walk's warps, a last warp that is partial); P
#: 1, 4, 64 and 65; SA 1, 5, 17 and 200 (above the staged limit).
_DELTA_MODEL_CASES = [(8, 1, 1, 1), (8, 3, 4, 5), (8, 31, 64, 17),
                      (8, 33, 4, 200), (5, 67, 1, 17), (8, 33, 64, 5),
                      (3, 67, 4, 1), (8, 31, 1, 200), (8, 3, 64, 200),
                      (8, 33, 65, 5), (10, 1, 4, 17)]


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("case", _DELTA_MODEL_CASES,
                         ids=lambda c: "L{}-NC{}-P{}-SA{}".format(*c))
def test_delta_model_matches_plain(kernel, case):
    """The numpy models of K9's and K10's two launches equal the plain
    forms (held to the JAX programs above) on garbage: the walk kernels
    (a chunk a thread, 32 chunks of the flat grid a warp, straddling
    lanes, the last warp partial; the staged rows' offsets and zero word,
    K10's clipped windows, the staged Rice parameters, the partition
    index and the Rice parameter's masks moved a sample at a time, the
    warm-up samples and the tile store) and the sample kernels (a warp a
    chunk, a thread a sample). The garbage has deltas of 0 and
    255 (K9) or negative (K10), k of 0, 31, 32, 40 and -3, partition
    sizes of 0, 1, 3, 37 and ones whose thresholds wrap, orders above 32,
    bases outside the stream."""
    from test_torch_cuda import delta_garbage

    L, NC, P, SA = case
    args = delta_garbage(kernel, L, NC, P, SA, W=64, seed=L + NC + P + SA)
    plain = (tentropy.decode_residual_bits_plain if kernel == "K9" else
             tentropy.decode_residual_bits_stream_delta_plain)
    want = plain(*(_t(a) for a in args), n_parts_max=P, sa=SA).numpy()
    assert np.array_equal(_delta_walk_model(kernel, args, P, SA), want)
    assert np.array_equal(_delta_sample_model(kernel, args, P, SA), want)


def _k10_walk_calls():
    """K10's inputs, as numpy arrays, on each dispatch of a segmented delta
    decode of two captured streams on the CPU (no JAX)."""
    import os

    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import entropy

    calls = []
    fn = entropy.decode_residual_bits_stream_delta

    def spy(*args, **kw):
        calls.append(([a.numpy() for a in args], kw))
        return fn(*args, **kw)

    old = os.environ.get("CLAXON_TPU_SEG_ENTROPY")
    entropy.decode_residual_bits_stream_delta = spy
    os.environ["CLAXON_TPU_SEG_ENTROPY"] = "delta"
    try:
        ct.decode_streams_device(_captured_datas()[:2], segmentation="device",
                                 device="cpu").to_host()
    finally:
        entropy.decode_residual_bits_stream_delta = fn
        if old is None:
            del os.environ["CLAXON_TPU_SEG_ENTROPY"]
        else:
            os.environ["CLAXON_TPU_SEG_ENTROPY"] = old
    return calls


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_delta_model_matches_plain_on_real_buckets(kernel):
    """The models of K9 and K10 equal their plain forms on real inputs:
    every bucket of the port's delta planner for the captured streams
    (eight partitions, verbatim and constant subframes), and every
    dispatch of their segmented delta decode (the walk's int8 deltas and
    chunk bases)."""
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import plan_raw_bits

    if kernel == "K9":
        bp = plan_raw_bits(extract_streams_bits(_captured_datas(), native,
                                                "delta"), 128, "delta")
        calls = [(list(_delta_args(b)), dict(n_parts_max=b.n_parts_max,
                                              sa=b.sa)) for b in bp.bits]
        plain = tentropy.decode_residual_bits_plain
    else:
        calls = _k10_walk_calls()
        plain = tentropy.decode_residual_bits_stream_delta_plain
    assert calls
    for args, kw in calls:
        args = [np.ascontiguousarray(a) for a in args]
        want = plain(*(_t(a) for a in args), **kw).numpy()
        assert (want != 0).any()
        for model in (_delta_walk_model, _delta_sample_model):
            got = model(kernel, args, kw["n_parts_max"], kw["sa"])
            assert np.array_equal(got, want), (kw, model.__name__)


def test_crc16_ranges_matches_jax_and_host():
    rng = np.random.default_rng(22)
    raw = rng.integers(0, 256, 5003, dtype=np.uint8).tobytes()
    buf = np.frombuffer(raw + bytes((-len(raw)) % 4), np.uint8)
    stream = buf.view(">i4").astype(np.int32)
    cases = [(0, 0), (5, 5), (0, 1), (0, 64), (1, 60), (2, 63), (3, 9),
             (7, 70), (13, 77), (100, 101), (5002, 5003), (4950, 5003)]
    cases += [(a, a + int(rng.integers(0, 80)))
              for a in rng.integers(0, 4900, 20)]
    starts = np.array([a for a, _ in cases], np.int32)
    ends = np.array([b for _, b in cases], np.int32)
    got = tcrc.crc16_ranges(_t(stream), _t(starts), _t(ends)).numpy()
    want = np.asarray(crc16_ranges_device(jnp.asarray(stream),
                                          jnp.asarray(starts),
                                          jnp.asarray(ends)))
    assert np.array_equal(got, want)
    host = [native.crc16_bytes(raw[a:b]) if native.available()
            else crc16(raw[a:b]) for a, b in cases]
    assert got.tolist() == host


def _k4_model(stream, starts, ends):
    """K4's kernel (``csrc/crc.cu``) step by step in numpy, with the
    tables it is given (``ops.crc.kernel_tables``): clamp, items of
    ITEM_BYTES aligned to each range's end, 512-byte warp steps of 16
    bytes a lane (slice-by-4, leading bytes before the range masked to
    zero, the lane's state carried with M_9), the 5-level lane tree with
    M_4..M_8, and each item shifted across the items after it (M_12 and
    up) and xored into its range."""
    tab = tcrc.kernel_tables().astype(np.int64)
    T = tab[:1024].reshape(4, 256)
    M = tab[1024:].reshape(tcrc.LEVELS, 2, 256)

    def shift(k, c):
        return M[k, 0][c & 255] ^ M[k, 1][c >> 8]

    W = len(stream)
    u = stream.astype(np.int64) & 0xFFFFFFFF
    lane = np.arange(32)

    def word(w):
        return np.where((w >= 0) & (w < W), u[np.clip(w, 0, W - 1)], 0)

    out = []
    for a, b in zip(starts, ends):
        s = min(max(int(a), 0), 4 * W)
        e = min(max(int(b), s), 4 * W)
        crc = 0
        for j in range(-(-(e - s) // tcrc.ITEM_BYTES)):
            item_end = e - j * tcrc.ITEM_BYTES
            n_steps = -(-(item_end - max(item_end - tcrc.ITEM_BYTES, s))
                        // tcrc.STEP_BYTES)
            r = 8 * (item_end & 3)
            acc = np.zeros(32, np.int64)
            for m in range(n_steps - 1, -1, -1):
                p = item_end - tcrc.STEP_BYTES * (m + 1) + 16 * lane
                wd = [word((p >> 2) + k) for k in range(5)]
                st = np.zeros(32, np.int64)
                for k in range(4):
                    v = ((wd[k] << r) | (wd[k + 1] >> (32 - r))) \
                        & 0xFFFFFFFF if r else wd[k]
                    z = s - (p + 4 * k)
                    v = np.where(z >= 4, 0, np.where(
                        z > 0, v & (0xFFFFFFFF >> (8 * np.clip(z, 0, 3))),
                        v))
                    x = v ^ (st << 16)
                    st = T[3][x >> 24] ^ T[2][(x >> 16) & 255] ^ \
                        T[1][(x >> 8) & 255] ^ T[0][x & 255]
                acc = shift(9, acc) ^ st
            for d in range(5):
                acc = shift(4 + d, acc) ^ np.concatenate(
                    [acc[1 << d:], acc[32 - (1 << d):]])
            c = int(acc[0])
            for bit in range(int(j).bit_length()):
                if (j >> bit) & 1:
                    c = int(shift(12 + bit, np.int64(c)))
            crc ^= c
        out.append(crc)
    return np.array(out, np.int32)


def test_k4_tables_are_the_shift_and_slice_tables():
    """T_k[b] is the CRC of byte b and k zero bytes; M_k carries a state
    across 2^k zero bytes (from the port's copy of the combine
    matrices)."""
    tab = tcrc.kernel_tables()
    assert tab.shape == (1024 + 512 * tcrc.LEVELS,) and tab.dtype == np.int32
    T = tab[:1024].reshape(4, 256)
    for k in range(4):
        assert [thost_crc.crc16(bytes([b]) + bytes(k)) for b in range(256)] \
            == T[k].tolist()
    M = tab[1024:].reshape(tcrc.LEVELS, 2, 256)
    rng = np.random.default_rng(23)
    for k in (0, 1, 4, 9, 12):
        for c in rng.integers(0, 1 << 16, 8):
            c = int(c)
            assert M[k, 0][c & 255] ^ M[k, 1][c >> 8] == \
                thost_crc.crc16(bytes(1 << k), crc=c)


def test_k4_model_matches_crc16():
    """The numpy model of the kernel's item, step, lane and combine math
    equals ``claxon_tpu_torch.crc.crc16`` (and the plain form) on ranges
    whose lengths cross every 2^k boundary up to 2^14, at every byte
    alignment, and on ranges outside the upload (clamped)."""
    rng = np.random.default_rng(24)
    raw = rng.integers(0, 256, 20003, dtype=np.uint8).tobytes()
    buf = raw + bytes(-len(raw) % 4)
    stream = np.frombuffer(buf, ">i4").astype(np.int32)
    cases = []
    for k in range(15):
        for d in (-1, 0, 1):
            n = (1 << k) + d
            a = int(rng.integers(0, len(raw) - n))
            cases.append((a - a % 4 + (k + d) % 4, a - a % 4 + (k + d) % 4
                          + n))
    cases += [(0, len(raw)), (1, 4097), (3, 8195), (-7, 5), (10, 30000),
              (9000, 8000), (len(buf) - 3, len(buf) + 9), (0, 0), (5, 5)]
    starts = np.array([a for a, _ in cases], np.int32)
    ends = np.array([b for _, b in cases], np.int32)
    got = _k4_model(stream, starts, ends)
    want = []
    for a, b in cases:
        s = min(max(a, 0), len(buf))
        want.append(thost_crc.crc16(buf[s:min(max(b, s), len(buf))]))
    assert got.tolist() == want
    short = ends - starts <= 4200
    assert np.array_equal(got[short], tcrc.crc16_ranges(
        _t(stream), _t(starts[short]), _t(ends[short])).numpy())


def test_crc16_ranges_differs_from_jax_only_outside_the_upload():
    """The port clamps ranges to the upload, the JAX function does not:
    the documented difference (ops/crc.py), on ranges no path makes."""
    stream = np.frombuffer(bytes(range(16)), np.uint8).view(">i4") \
        .astype(np.int32)
    starts = np.array([-5, 10, 14, 0, 16], np.int32)
    ends = np.array([3, 99, 12, 16, 16], np.int32)
    got = tcrc.crc16_ranges(_t(stream), _t(starts), _t(ends)).tolist()
    jax_ = np.asarray(crc16_ranges_device(
        jnp.asarray(stream), jnp.asarray(starts), jnp.asarray(ends)))
    assert got[:3] == [1548, 26503, 0]
    assert jax_[:3].tolist() == [10002, 64596, 38786]
    assert got[3:] == jax_[3:].tolist() == [crc16(bytes(range(16))), 0]


def test_crc16_ranges_clamps_to_the_upload():
    stream = np.frombuffer(bytes(range(16)), np.uint8).view(">i4") \
        .astype(np.int32)
    starts = np.array([-5, 10, 14, 20], np.int32)
    ends = np.array([3, 99, 12, 30], np.int32)
    got = tcrc.crc16_ranges(_t(stream), _t(starts), _t(ends)).tolist()
    assert got == [crc16(bytes(range(3))), crc16(bytes(range(10, 16))),
                   0, 0]
