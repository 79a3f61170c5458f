"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Marked ``cuda`` and skipped where no CUDA device is present (the kernels
have no CPU mode). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Equality is exact. The inputs include fuzzed ones: the kernels clamp
every read into their inputs exactly as the plain forms do, so garbage
gives the same garbage and never a fault.
"""

import functools
import pathlib
import zlib

import numpy as np
import pytest
import torch

from claxon_tpu import native

pytestmark = pytest.mark.cuda

GENERATED = pathlib.Path(__file__).resolve().parents[1] / "testsamples" / \
    "generated"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _c(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def test_synthesize_kernel_matches_plain(cuda):
    from claxon_tpu_torch.ops import predict

    rng = np.random.default_rng(1)
    L, T = 100, 333  # ragged: neither a whole block of lanes nor of steps
    x = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64)
    orders = rng.integers(0, 33, L)
    shifts = rng.integers(0, 32, L)
    coefs = rng.integers(-(1 << 15) + 1, 1 << 15, (L, 32))
    coefs[np.arange(32)[None, :] < 32 - orders[:, None]] = 0
    lengths = rng.integers(0, T + 1, L)
    args = [_c(a, cuda) for a in (x, coefs, shifts, orders, lengths)]
    n = predict.synthesize.launches
    got = predict.synthesize(*args)
    assert predict.synthesize.launches == n + 1
    assert torch.equal(got, predict.synthesize_plain(*args))


def _synth_args(rng, L, T, orders, col0=False, short=False):
    x = rng.integers(-(1 << 31), 1 << 31, (L, T), dtype=np.int64)
    coefs = rng.integers(-(1 << 15) + 1, 1 << 15, (L, 32))
    if col0:
        coefs[:, 1:] = 0
    else:
        coefs[np.arange(32)[None, :] < 32 - orders[:, None]] = 0
    lengths = rng.integers(0, T, L) if short else np.full(L, T)
    return x, coefs, rng.integers(0, 32, L), orders, lengths


@pytest.mark.parametrize("case", [
    "mixed_tap_classes", "column0_only", "T1", "T192", "T1152", "T4096",
    "T4608"])
def test_synthesize_kernel_tap_classes(cuda, case):
    """The tap count each warp takes from its coefficients: a warp whose
    lanes need every class (orders 0, 1, 4, 8, 12, 32), coefficients
    nonzero only in column 0 (the warp must take all 32 taps), and T from
    1 to 4608 with L = 100 (not a multiple of 32) and lengths below T."""
    from claxon_tpu_torch.ops import predict

    rng = np.random.default_rng(11)
    if case == "mixed_tap_classes":
        args = _synth_args(rng, 64, 1152,
                           np.resize(np.array([0, 1, 4, 8, 12, 32]), 64))
    elif case == "column0_only":
        args = _synth_args(rng, 100, 576, rng.integers(0, 33, 100),
                           col0=True)
    else:
        args = _synth_args(rng, 100, int(case[1:]),
                           rng.integers(0, 33, 100), short=True)
    args = [_c(a, cuda) for a in args]
    assert torch.equal(predict.synthesize(*args),
                       predict.synthesize_plain(*args))


def test_entropy_kernel_matches_plain_on_garbage(cuda):
    from claxon_tpu_torch.ops import entropy

    rng = np.random.default_rng(2)
    for P, SA, W in ((1, 1, 1), (4, 5, 64), (64, 40, 300)):
        L, NC = 37, 3
        args = [rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64),
                rng.integers(-4096, 32 * W + 4096, (L, NC)),
                rng.integers(-40, 40, (L, P)),
                rng.integers(-3, 200, L), rng.integers(0, 40, L),
                rng.integers(0, 8, L), rng.integers(0, 8, L),
                rng.integers(-1000, 1000, (L, 32)),
                rng.integers(0, NC * 32 + 8, L)]
        args[0][::5] = 0
        args = [_c(a, cuda) for a in args]
        got = entropy.decode_residual_bits_stream(*args, n_parts_max=P,
                                                  sa=SA)
        want = entropy.decode_residual_bits_stream_plain(
            *args, n_parts_max=P, sa=SA)
        assert torch.equal(got, want), (P, SA, W)


_K2_KEYS = ("stream", "bases", "ks", "ps", "orders", "pbits", "flags",
            "warm", "lengths")
#: SA classes the host walk emits (the C++ core's kSClasses plus 1), the
#: card test's 40, 1, and sizes above the kernel's staged limit (65).
_K2_SA = (1, 5, 7, 9, 13, 17, 25, 33, 40, 49, 65, 66, 100)


def _entropy_case(case):
    """(args, P, SA) of a K2 edge case: lanes whose chunk bases rise
    through a random stream as real ones do, then the case's changes."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    kind, _, val = case.partition("=")
    L, NC, P, SA, W = 200, 4, 4, 17, 2000
    if kind == "sa":
        SA = int(val)
    elif kind == "P":
        P, NC = int(val), 8
    elif kind == "NC":
        L, NC = 37, int(val)
    elif kind == "ragged":
        L, NC = 3 * 43 + 1, 5  # L * NC = 650: not a multiple of 32 or 128
    elif kind == "big":
        L, NC, W = 1000, 128, 200000
    T = NC * 32
    step = rng.integers(200, 400, (L, NC))
    start = rng.integers(0, max(1, 32 * W - 400 * NC), L)
    a = dict(stream=rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64),
             bases=start[:, None] + np.cumsum(step, 1) - step,
             ks=rng.integers(0, 15, (L, P)),
             ps=np.full(L, max(T // P, 1)), orders=rng.integers(0, 13, L),
             pbits=rng.choice([4, 5], L), flags=np.zeros(L, np.int64),
             warm=rng.integers(-1000, 1000, (L, 32)),
             lengths=np.full(L, T))
    a["stream"][::7] = 0
    if kind == "W1":
        a["stream"] = a["stream"][:1]
        a["bases"] = rng.integers(-5000, 5000, (L, NC))
    elif kind == "bases_outside":
        a["bases"] = np.concatenate([
            rng.integers(-(1 << 31), 1 << 31, (L // 2, NC), dtype=np.int64),
            rng.integers(32 * W - 600, 32 * W + 5000, (L - L // 2, NC))])
        a["bases"][:20] = -rng.integers(1, 3000, (20, NC))
    elif kind == "lane_kinds":
        a["flags"] = np.resize(np.arange(4), L)  # verbatim, no codes, both
        a["orders"] = np.resize(np.array([0, 32, 40, 5, 31, 1, 2]), L)
        a["lengths"] = np.resize(np.array([0, T + 50, T // 2, T, 33, 31,
                                           T - 1, 1]), L)
        a["ks"] = rng.integers(0, 33, (L, P))  # verbatim widths up to 32
    elif kind == "fuzzed_ps":
        P = 64
        a["ks"] = rng.integers(-3, 40, (L, P))
        a["ps"] = np.resize(np.array([-5, 0, 1, 2, (1 << 31) - 1,
                                      (1 << 30) + 1, 3 << 29, 1 << 27,
                                      (1 << 31) // 63, 100]), L)
        a["orders"] = rng.integers(-3, 200, L)
    return [_c(a[k], "cpu") for k in _K2_KEYS], P, SA


@pytest.mark.parametrize("case", [f"sa={n}" for n in _K2_SA]
                         + [f"P={n}" for n in (1, 4, 64)]
                         + [f"NC={n}" for n in (1, 3, 33, 128)]
                         + ["ragged", "W1", "bases_outside", "lane_kinds",
                            "fuzzed_ps", "big"])
def test_entropy_kernel_edges(cuda, case):
    """K2's edges: every SA the walk emits, 1, 40 and sizes above the
    staged limit (read from global memory); P 1, 4 and 64; NC 1, 3, 33
    and 128, so warps straddle lanes; a chunk count that fills neither a
    warp nor a block; W = 1; bases negative and past the stream; verbatim
    and no-code lanes, orders 0, 32 and 40, lengths 0 and past T; fuzzed
    partition sizes whose thresholds wrap."""
    from claxon_tpu_torch.ops import entropy

    args, P, SA = _entropy_case(case)
    args = [a.to(cuda) for a in args]
    got = entropy.decode_residual_bits_stream(*args, n_parts_max=P, sa=SA)
    want = entropy.decode_residual_bits_stream_plain(*args, n_parts_max=P,
                                                     sa=SA)
    assert torch.equal(got, want), case


def delta_garbage(kernel, L, NC, P, SA, W=300, seed=0):
    """Seeded garbage for K9 (``kernel`` "K9": slots, uint8 deltas) or
    K10 ("K10": stream and chunk bases, int8 deltas), as numpy arrays in
    the wrapper's argument order: code lengths mostly 1-23 bits with some
    of 0 to 255 (K9) or of -128 to 127 (K10), Rice parameters 0, 1, 5,
    13, 31, 32, 40 and -3, partition sizes 0, negative, 1, odd and huge
    (thresholds that wrap), orders up to 44, flags of every kind, K10
    bases before and past the stream. Lane 0 starts with a 5-bit code
    under k = 40, so its remainder starts before the chunk's first bit.
    Shared with the CPU tests (tests/test_torch_ops.py)."""
    rng = np.random.default_rng(seed)
    T = NC * 32
    ks = rng.choice(np.array([0, 1, 5, 13, 31, 32, 40, -3]), (L, P))
    ps = rng.permutation(np.resize(np.array(
        [0, -7, 1, 3, 37, max(T // P, 1), (1 << 31) - 1, -(1 << 31)]), L))
    orders = rng.integers(0, 45, L)
    pbits = rng.integers(0, 8, L)
    warm = rng.integers(-1000, 1000, (L, 32))
    deltas = rng.integers(1, 24, (L, T))
    odd = rng.random((L, T)) < 0.05
    ks[0] = 40
    orders[0] = 0
    if kernel == "K9":
        deltas[odd] = rng.integers(0, 256, int(odd.sum()))
        deltas[0, 0], deltas[1 % L, 3] = 5, 255
        return [rng.integers(-(1 << 31), 1 << 31, (L, NC * SA),
                             dtype=np.int64).astype(np.int32),
                deltas.astype(np.uint8), ks.astype(np.int32),
                ps.astype(np.int32), orders.astype(np.int32),
                pbits.astype(np.int32),
                rng.integers(0, 2, L).astype(np.int32),
                warm.astype(np.int32)]
    deltas[odd] = rng.integers(-128, 128, int(odd.sum()))
    deltas[0, 0] = 5
    stream = rng.integers(-(1 << 31), 1 << 31, W, dtype=np.int64)
    stream[::7] = 0
    flags = rng.integers(0, 4, L)
    flags[0] = 0
    return [stream.astype(np.int32),
            rng.integers(-4096, 32 * W + 4096, (L, NC)).astype(np.int32),
            deltas.astype(np.int8), ks.astype(np.int32), ps.astype(np.int32),
            orders.astype(np.int32), pbits.astype(np.int32),
            flags.astype(np.int32), warm.astype(np.int32),
            rng.integers(0, T + 8, L).astype(np.int32)]


def _t_any(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


#: (L, NC, P, SA) of the K9 / K10 card cases: SA from 4 to 65 (and 1, and
#: above the staged limit of 128), P from 1 to 65. Launches of fewer than
#: 24576 chunks take the sample kernels (a warp a chunk, 4 warps a block),
#: the last six cases the walk kernels (a thread a chunk, 32 chunks a
#: warp): NC 3 to 67 make the walk's warps straddle lanes at every offset,
#: NC 128 spans many blocks, and most cases leave the last warp and block
#: partial.
_DELTA_CASES = [(37, 3, 1, 4), (37, 3, 4, 5), (50, 5, 8, 9), (23, 9, 16, 17),
                (41, 7, 32, 33), (19, 11, 64, 65), (13, 3, 64, 1),
                (11, 5, 2, 200), (7, 33, 4, 25), (301, 1, 1, 13),
                (9, 15, 4, 17), (7, 17, 64, 13), (5, 35, 16, 5),
                (13, 128, 4, 17), (3, 128, 65, 9), (7, 31, 32, 200),
                (11, 47, 64, 33), (6, 33, 4, 13), (4, 67, 8, 17),
                (300, 40, 16, 13), (520, 64, 8, 13), (1100, 33, 16, 17),
                (400, 64, 65, 9), (600, 128, 4, 17), (2200, 33, 64, 5),
                (2100, 33, 65, 200)]


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("case", _DELTA_CASES,
                         ids=lambda c: "L{}-NC{}-P{}-SA{}".format(*c))
def test_delta_entropy_kernels_match_plain(cuda, kernel, case):
    """K9 and K10 equal their plain forms (held to the JAX functions on
    the CPU) on garbage, at every SA and P the paths use."""
    from claxon_tpu_torch.ops import entropy

    L, NC, P, SA = case
    args = [_t_any(a, cuda) for a in delta_garbage(kernel, L, NC, P, SA,
                                                   seed=L * NC + P)]
    if kernel == "K9":
        wrapper, plain = (entropy.decode_residual_bits,
                          entropy.decode_residual_bits_plain)
    else:
        wrapper, plain = (entropy.decode_residual_bits_stream_delta,
                          entropy.decode_residual_bits_stream_delta_plain)
    n0 = wrapper.launches
    got = wrapper(*args, n_parts_max=P, sa=SA)
    assert wrapper.launches == n0 + 1
    assert torch.equal(got, plain(*args, n_parts_max=P, sa=SA)), case
    torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def _headline_x4():
    """chip_smoke.py's headline corpus, four times: 32 streams of 10 s."""
    import chip_smoke

    return chip_smoke.headline_corpus() * 4


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_delta_kernels_match_plain_on_headline(cuda, monkeypatch, kernel):
    """K9 and K10 equal their plain forms on the headline x4 corpus:
    every bucket of the host walk's delta planner (K9; L 6912 and 128, T
    4096) and every dispatch of the segmented delta decode (K10)."""
    from claxon_tpu_torch import native as tnative
    from claxon_tpu_torch import pipeline_seg
    from claxon_tpu_torch.ops import entropy
    from claxon_tpu_torch.pipeline import extract_streams_bits
    from claxon_tpu_torch.pipeline_bits import _to_device, plan_raw_bits

    datas = _headline_x4()
    calls = []
    if kernel == "K9":
        fn, plain = (entropy.decode_residual_bits,
                     entropy.decode_residual_bits_plain)
        bp = plan_raw_bits(extract_streams_bits(datas, tnative, "delta"),
                           128, "delta")
        for b in bp.bits:
            m = _to_device(b.meta, cuda)
            calls.append(((_to_device(b.slots, cuda),
                           torch.from_numpy(b.deltas).to(cuda),
                           _to_device(b.ks, cuda), m[:, 3].contiguous(),
                           m[:, 0].contiguous(), m[:, 4].contiguous(),
                           (m[:, 5] & 1).contiguous(),
                           m[:, 8:40].contiguous()),
                          dict(n_parts_max=b.n_parts_max, sa=b.sa)))
    else:
        fn, plain = (entropy.decode_residual_bits_stream_delta,
                     entropy.decode_residual_bits_stream_delta_plain)

        def spy(*args, **kw):
            calls.append((args, kw))
            return fn(*args, **kw)

        spy.launches = 0  # the wrapper counts on the module's name
        monkeypatch.setattr(entropy, "decode_residual_bits_stream_delta",
                            spy)
        monkeypatch.setenv("CLAXON_TPU_SEG_ENTROPY", "delta")
        pipeline_seg.decode_streams_segmented(datas, device=cuda).sync()
    assert calls
    for args, kw in calls:
        assert torch.equal(fn(*args, **kw), plain(*args, **kw)), kw
    # The largest bucket or dispatch has 6912 lanes (K9's slots, K10's
    # bases).
    assert max(a[kernel == "K10"].shape[0] for a, _ in calls) == 6912
    torch.cuda.synchronize()


def test_crc_kernel_matches_plain_and_host(cuda):
    from claxon_tpu_torch.ops import crc

    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    stream = np.frombuffer(raw, np.uint8).view(">i4").astype(np.int32)
    starts = rng.integers(-10, 4010, 300)
    ends = starts + rng.integers(-5, 900, 300)
    args = [_c(a, cuda) for a in (stream, starts, ends)]
    got = crc.crc16_ranges(*args)
    assert torch.equal(got, crc.crc16_ranges_plain(*args))
    s = np.clip(starts, 0, 4000)
    e = np.clip(np.maximum(np.minimum(ends, 4000), s), 0, 4000)
    assert got.tolist() == [native.crc16_bytes(raw[a:b])
                            for a, b in zip(s, e)]


def _crc_edge_case(case):
    """(stream bytes, starts, ends) of a K4 edge case; the stream's byte
    count is a multiple of 4 unless the case says otherwise (then its last
    word is zero-padded)."""
    rng = np.random.default_rng(31)

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    if case == "no_ranges":
        return data(4000), [], []
    if case == "empty_and_inverted":
        s = rng.integers(0, 4000, 64)
        return data(4000), s, s - rng.integers(0, 3, 64)
    if case == "every_start_byte":
        s = np.arange(200)
        return data(40000), s, s + rng.integers(0, 9000, 200)
    if case == "whole_upload":
        return data(1 << 20), [0, 1, 0], [1 << 20, (1 << 20) - 1, 1 << 19]
    if case == "at_and_past_the_end":
        n = 8192
        return data(n), [n, n, n - 1, n - 5, n + 4, 0, -4], \
            [n, n + 1, n, n + 99, n + 9, n + 1000, 3]
    if case == "many_tiny":
        s = rng.integers(0, 400000, 100000)
        s[:4096] = np.arange(4096)
        return data(400000), s, s + rng.integers(0, 4, 100000)
    if case == "bytes_not_a_multiple_of_the_chunk":
        n = 4 * 1025 - 1  # a word and 3 bytes past 4096
        return data(n), [0, 1, 3, 4090, 2, 511], \
            [n + 1, n, n - 1, n + 1, 4099, 4101]
    if case == "straddling_every_boundary":
        b = np.repeat(np.arange(512, 65536, 512), 3)
        lo = b - rng.integers(1, 600, b.size)
        return data(65536), lo, b + rng.integers(1, 4700, b.size)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "no_ranges", "empty_and_inverted", "every_start_byte", "whole_upload",
    "at_and_past_the_end", "many_tiny", "bytes_not_a_multiple_of_the_chunk",
    "straddling_every_boundary", "misaligned_view"])
def test_crc_kernel_edges(cuda, case):
    """K4's edges against the host's crc16 of the clamped range and, where
    the ranges are short enough for its byte-per-step loop, the plain
    form; the kernel counts one launch."""
    from claxon_tpu_torch.ops import crc

    raw, starts, ends = _crc_edge_case(
        "straddling_every_boundary" if case == "misaligned_view" else case)
    buf = raw + bytes(-len(raw) % 4)
    words = np.frombuffer(buf, ">i4").astype(np.int32)
    stream = _c(words, cuda)
    if case == "misaligned_view":  # 4 bytes off a 16-byte boundary
        base = torch.zeros(words.size + 1, dtype=torch.int32, device=cuda)
        base[1:] = stream
        stream = base[1:]
        assert stream.data_ptr() % 16 == 4
    st, en = _c(np.asarray(starts, np.int64), cuda), \
        _c(np.asarray(ends, np.int64), cuda)
    n = crc.crc16_ranges.launches
    got = crc.crc16_ranges(stream, st, en)
    torch.cuda.synchronize()
    assert crc.crc16_ranges.launches == n + 1
    assert got.shape == (len(starts),) and got.dtype == torch.int32
    want = []
    for a, b in zip(starts, ends):
        a = min(max(int(a), 0), len(buf))
        want.append(native.crc16_bytes(buf[a:min(max(int(b), a), len(buf))]))
    assert got.tolist() == want
    if len(starts) and int((en - st).max()) <= 10000:
        assert torch.equal(got, crc.crc16_ranges_plain(stream, st, en))


def _epilogue_case(case, rng):
    """Inputs of the fused K1 + K3 kernel: (x, coefs, shifts, orders,
    lengths, wasted, pair_modes) as numpy arrays."""
    L, T = {"padding_lanes": (100, 333), "T1": (64, 1), "T31": (64, 31),
            "T33": (64, 33), "L2": (2, 700)}.get(case, (64, 333))
    x, coefs, shifts, orders, lengths = _synth_args(
        rng, L, T, rng.integers(0, 33, L))
    wasted = rng.integers(0, 32, L)
    modes = np.resize(np.arange(8), L // 2)
    if case == "wasted_32_and_up":
        wasted = np.resize(np.array([32, 33, 100, -1, -(1 << 31),
                                     (1 << 31) - 1, 31, 0]), L)
    elif case == "padding_lanes":
        lengths[-36:] = 0  # as the planners pad: length 0, order 0
        orders[-36:] = 0
        coefs[-36:] = 0
    elif case == "pair_lengths_differ":
        lengths = rng.integers(0, T + 1, L)
        lengths[0::4] = 0
        lengths[2::8] = T
    elif case == "int16_unpacked_input":
        # A fallback bucket: residuals uploaded as int16 pairs.
        x = rng.integers(-32768, 32768, (L, T + 1))[:, :T & ~1]
        x = np.ascontiguousarray(x)
        coefs[:, :] = 0
        coefs[:, -2:] = [-1, 2]
        orders[:], shifts[:], lengths[:] = 2, 0, x.shape[1]
    elif case == "int32_extremes":
        x[:, :4] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, -1, 1]
        orders[:] = 0
    return [x, coefs, shifts, orders, lengths, wasted, modes]


@pytest.mark.parametrize("case", [
    "all_modes", "wasted_32_and_up", "padding_lanes", "T1", "T31", "T33",
    "pair_lengths_differ", "int16_unpacked_input", "int32_extremes", "L2"])
def test_synthesize_epilogue_kernel_matches_plain(cuda, case):
    """K1 + K3 fused on the card equals K1 then K3's torch ops on the
    card, and the plain form's result on the CPU: every mode code 0-7,
    wasted bits at and past 32 (and negative: a shift outside [0, 32)
    gives 0), padding lanes, T not a multiple of 32, lanes of one pair
    with different lengths, an input unpacked from int16 pairs, int32
    extremes, and L = 2."""
    from claxon_tpu_torch.ops import epilogue, predict

    args = _epilogue_case(case, np.random.default_rng(13))
    cpu = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in args]
    dev = [t.to(cuda) for t in cpu]
    if case == "int16_unpacked_input":
        x = cpu[0].numpy()
        words = (x[:, 1::2] << 16) | (x[:, 0::2] & 0xFFFF)
        dev[0] = epilogue.unpack_int16_pairs(_c(words, cuda))
        assert torch.equal(dev[0].cpu(), cpu[0])
    n = predict.synthesize_epilogue.launches
    got = predict.synthesize_epilogue(*dev)
    assert predict.synthesize_epilogue.launches == n + 1
    two = epilogue.apply_epilogue(predict.synthesize(*dev[:5]), *dev[5:])
    assert torch.equal(got, two)
    assert torch.equal(got.cpu(), predict.synthesize_epilogue(*cpu))


def test_epilogue_all_modes_through_the_fused_kernel(cuda):
    """The watch-list case ``tests/test_torch_ops.py::
    test_epilogue_matches_jax_all_modes`` on the card: its samples pass
    K1 unchanged (order 0, no coefficients) and the fused epilogue equals
    the CPU's apply_epilogue, which that test holds to the JAX
    package's."""
    from claxon_tpu_torch.ops import epilogue, predict

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
    zeros = np.zeros(L, np.int32)
    got = predict.synthesize_epilogue(
        *(_c(a, cuda) for a in (samples, np.zeros((L, 32)), zeros, zeros,
                                np.full(L, T), wasted, pair_modes)))
    want = epilogue.apply_epilogue(*(torch.from_numpy(a) for a in (
        samples, wasted, pair_modes)))
    assert torch.equal(got.cpu(), want)


def _pack16_case(case):
    rng = np.random.default_rng(8)
    i32 = np.iinfo(np.int32)
    if case == "headline_bucket":
        return rng.integers(-32768, 32768, (6912, 4096))
    if case == "boundary_values":
        x = rng.integers(-32768, 32768, (64, 576))
        x[:4, :4] = [[-32768, 32767, -32769, 32768]] * 4
        return x
    if case == "int32_extremes":
        x = rng.integers(-32768, 32768, (37, 192))
        x[5, 1], x[20, 190] = i32.max, i32.min
        return x
    if case == "last_element_only":
        x = rng.integers(-32768, 32768, (130, 1152))
        x[-1, -1] = 32768
        return x
    if case == "garbage":
        return rng.integers(i32.min, i32.max + 1, (100, 4608),
                            dtype=np.int64)
    if case == "T2":
        return np.array([[5, -7], [-32768, 32767], [0, 70000]])
    if case == "T6_three_lanes":  # T % 4 == 2: the narrow-vector kernels
        return rng.integers(-40000, 40000, (3, 6))
    if case == "no_lanes":
        return np.zeros((0, 64), np.int64)
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "headline_bucket", "boundary_values", "int32_extremes",
    "last_element_only", "garbage", "T2", "T6_three_lanes", "no_lanes"])
def test_pack16_kernels_match_plain(cuda, case):
    """K3b on the card: pack (scalar and per-lane flags) and unpack equal
    their plain forms on every element, and pack -> unpack gives the
    samples back where they fit int16."""
    from claxon_tpu_torch.ops import epilogue

    x = _c(_pack16_case(case), cuda)
    n_pack = epilogue.pack_int16_pairs.launches
    n_unpack = epilogue.unpack_int16_pairs.launches
    for per_lane in (False, True):
        words, flag = epilogue.pack_int16_pairs(x, per_lane=per_lane)
        p_words, p_flag = epilogue.pack_int16_pairs_plain(x, per_lane)
        assert words.dtype == flag.dtype == torch.int32
        assert flag.shape == p_flag.shape
        assert torch.equal(words, p_words) and torch.equal(flag, p_flag)
    back = epilogue.unpack_int16_pairs(words)
    assert torch.equal(back, epilogue.unpack_int16_pairs_plain(words))
    if not bool(flag.any()):
        assert torch.equal(back, x)
    # Any int32 words unpack, an odd count of them too.
    assert torch.equal(epilogue.unpack_int16_pairs(x),
                       epilogue.unpack_int16_pairs_plain(x))
    odd = x[:, :1].contiguous()
    assert torch.equal(epilogue.unpack_int16_pairs(odd),
                       epilogue.unpack_int16_pairs_plain(odd))
    assert epilogue.pack_int16_pairs.launches == n_pack + 2
    assert epilogue.unpack_int16_pairs.launches == n_unpack + 3
    torch.cuda.synchronize()


def test_pack16_wrappers_refuse_misaligned_views(cuda):
    from claxon_tpu_torch.ops import epilogue

    base = torch.zeros(4 * 8 + 1, dtype=torch.int32, device=cuda)
    view = base[1:].reshape(4, 8)  # contiguous, 4 bytes off alignment
    for fn in (epilogue.pack_int16_pairs, epilogue.unpack_int16_pairs):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(view)


def test_to_host_on_the_card_packs_and_refetches(cuda):
    """On the card every bucket is landed: ``to_host()`` launches
    ``interleave_runs`` once a bucket and K3b pack never;
    device_buckets(), lane_plans() and sync() launch neither; every
    result's PCM is a C-contiguous view of one pinned host tensor, equal
    to the scalar decoder's. A bucket whose values leave int16 comes back
    exact, with no flag and no refetch."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import epilogue
    from claxon_tpu_torch.pipeline import (DecodedStream, DeviceDecoded,
                                           _BucketDispatch)

    datas = _small_streams()
    n0 = (epilogue.interleave_runs.launches,
          epilogue.pack_int16_pairs.launches)
    dd = ct.decode_streams_device(datas, device=cuda).sync()
    dd.device_buckets()
    dd.lane_plans()
    assert (epilogue.interleave_runs.launches,
            epilogue.pack_int16_pairs.launches) == n0
    out = dd.to_host()
    assert epilogue.interleave_runs.launches == n0[0] + len(dd.dispatches)
    assert epilogue.pack_int16_pairs.launches == n0[1]
    assert all(d.words is None and d.flag is None and d.host is None
               for d in dd.dispatches)
    host = dd._landed[0]
    assert host.is_pinned() and host.dtype == torch.int32
    for data, dec in zip(datas, out):
        assert dec.pcm.flags.c_contiguous
        assert np.shares_memory(dec.pcm, host.numpy())
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])
    assert dd.to_host()[0].pcm is out[0].pcm

    vals = np.arange(8 * 64, dtype=np.int32).reshape(8, 64) * 300 - 70000
    pcm = np.zeros((3 * 50 + 7, 2), np.int32)
    d = _BucketDispatch(2, _c(vals, cuda), True)
    dd = DeviceDecoded([DecodedStream(None, pcm, [0, 50, 100], [50] * 3)],
                       [d], [[(0, 0, 3, 50, 2, 0)]], [pcm])
    got = dd.to_host()[0].pcm
    assert d.flag is None and d.host is None
    assert np.array_equal(got[:150].reshape(3, 50, 2),
                          vals[:6, :50].reshape(3, 2, 50).transpose(0, 2, 1))
    assert not got[150:].any()  # no run lands there
    assert dd.trace.counters["fetch_landed_buckets"] == 1


def test_interleave_runs_matches_plain(cuda):
    """The kernel against its plain form, exactly: every random plan of
    ``interleave_cases`` (mono, stereo, six channels, tail frames, odd
    block sizes and T = 65535, which take the scalar path, padding lanes
    of garbage, frames that land nowhere), and a CD track and a mono
    speech batch at their decode shapes."""
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch.ops import epilogue
    from claxon_tpu_torch.testing.interleave_cases import (CASE_SEEDS,
                                                           headline_case,
                                                           plan_case)

    cases = [plan_case(seed) for seed in CASE_SEEDS]
    cases += [headline_case(1, 2588, 4096, 2), headline_case(64, 49, 4096, 1),
              headline_case(3, 5, 1023, 2, T=1024)]
    for buckets, plans, shapes in cases:
        offsets, total = tp.arena_offsets([np.zeros(s) for s in shapes])
        got = torch.zeros(total, dtype=torch.int32, device=cuda)
        want = torch.zeros(total, dtype=torch.int32)
        n = epilogue.interleave_runs.launches
        for b, plan in zip(buckets, plans):
            runs = tp.arena_runs(plan, offsets)
            epilogue.interleave_runs(_c(b, cuda), runs, got)
            epilogue.interleave_runs_plain(torch.from_numpy(b), runs, want)
        assert epilogue.interleave_runs.launches == n + len(buckets)
        assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="outside"):
        epilogue.interleave_runs(_c(np.zeros((4, 64)), cuda),
                                 [(0, 1, 64, 2, 3)], got)
    with pytest.raises(ValueError, match="16-byte aligned"):
        epilogue.interleave_runs(_c(np.zeros((4, 64)), cuda),
                                 [(0, 1, 64, 1, 0)], got[1:])
    torch.cuda.synchronize()


def test_same_size_calls_reuse_pinned_memory(cuda, capsys):
    """Two same-size decodes to host, the first's results dropped before
    the second: both bit-exact. The second's arena is logged: the caching
    host allocator hands back the first's block once its views are
    gone."""
    import claxon_tpu_torch as ct

    datas = _headline_x4()[:1]
    ptrs = []
    for _ in range(2):
        dd = ct.decode_streams_device(datas, device=cuda)
        _assert_scalar_and_md5(datas, dd.to_host())
        ptrs.append(dd._landed[0].data_ptr())
        del dd
    with capsys.disabled():
        print(f"\npinned arenas of two same-size calls: {ptrs[0]:#x}, "
              f"{ptrs[1]:#x} (same block: {ptrs[0] == ptrs[1]})")
    torch.cuda.synchronize()


def fuzzed_streams(n=24, seed=7):
    """``n`` small valid streams with seeded damage in their frame
    sections: 1-4 flipped bytes, or a truncation. Shared with the CPU
    tests (tests/test_torch_pipeline.py)."""
    from claxon_tpu.native.binding import _read_metadata
    from claxon_tpu.testing import encode_flac, synth_music

    rng = np.random.default_rng(seed)
    pcm = synth_music(1800, channels=2, bps=16, seed=seed)
    bases = [encode_flac(pcm, 44100, 16, block_size=576, partition_order=2),
             encode_flac(pcm, 44100, 16, block_size=576,
                         force_subframe="verbatim"),
             encode_flac(pcm[:, :1], 44100, 16, block_size=576,
                         max_lpc_order=12)]
    out = []
    for i in range(n):
        data = bytearray(bases[i % len(bases)])
        pos = _read_metadata(bytes(data))[1]
        if i % 4 == 3:
            del data[int(rng.integers(pos, len(data))):]
        else:
            for at in rng.integers(pos, len(data), int(rng.integers(1, 5))):
                data[at] ^= int(rng.integers(1, 256))
        out.append(bytes(data))
    return out


def assert_decodes_like_scalar(datas, device, segmentation=None):
    """Each stream decodes to the scalar decoder's PCM, or raises the
    port's Error where the JAX package's scalar decoder raises its own;
    nothing else."""
    import claxon_tpu_torch as ct
    from claxon_tpu.error import Error as RefError

    def decode(data):
        return ct.decode_streams_device([data], segmentation=segmentation,
                                        device=device).to_host()[0].pcm

    for data in datas:
        try:
            want = native.decode_stream_scalar(data)[1]
        except RefError:
            want = None
        if want is None:
            with pytest.raises(ct.Error):
                decode(data)
        else:
            assert np.array_equal(decode(data), want)


def test_fuzzed_streams_on_the_card(cuda):
    assert_decodes_like_scalar(fuzzed_streams(), cuda)
    torch.cuda.synchronize()


def test_generated_corpus_on_the_card(cuda):
    import claxon_tpu_torch as ct

    datas = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    dd = ct.decode_streams_device(datas, device=cuda).sync()
    assert all(b[2].is_cuda for b in dd.device_buckets())
    for data, dec in zip(datas, dd.to_host()):
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])


@pytest.mark.parametrize("route", ["ENTROPY=delta", "SEG_ENTROPY=delta",
                                   "SEG_ENTROPY=scan", "HOST_CRC=1"])
def test_entropy_routes_on_the_card(cuda, monkeypatch, route):
    """The delta and scan routes, and the host CRC check, decode the
    generated corpus and the seeded damaged streams on the card like the
    scalar decoder, through K9, K10 or K2 as the route says."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import crc, entropy

    name, value = route.split("=")
    monkeypatch.setenv("CLAXON_TPU_" + name, value)
    seg = "device" if name == "SEG_ENTROPY" else "host"
    kernel = {"ENTROPY=delta": entropy.decode_residual_bits,
              "SEG_ENTROPY=delta": entropy.decode_residual_bits_stream_delta,
              "SEG_ENTROPY=scan": entropy.decode_residual_bits_stream,
              "HOST_CRC=1": entropy.decode_residual_bits_stream}[route]
    datas = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    n0, k4 = kernel.launches, crc.crc16_ranges.launches
    dd = ct.decode_streams_device(datas, segmentation=seg, device=cuda)
    assert kernel.launches > n0
    if seg == "host":  # the walk checked every frame CRC itself
        assert crc.crc16_ranges.launches == k4 and dd.crc_check is None
    for data, dec in zip(datas, dd.to_host()):
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])
    assert_decodes_like_scalar(fuzzed_streams(), cuda, seg)
    torch.cuda.synchronize()


def _payload_words(data):
    """Big-endian int32 words of a stream's frame section."""
    from claxon_tpu.native.binding import _read_metadata

    payload = np.frombuffer(data, np.uint8)[_read_metadata(data)[1]:]
    pad = np.zeros((-len(payload)) % 4, np.uint8)
    return np.concatenate([payload, pad]).view(">i4").astype(np.int32), \
        len(payload)


def _small_streams():
    from claxon_tpu.testing import encode_flac, synth_music

    pcm = synth_music(4000, channels=2, bps=16, seed=11)
    return [encode_flac(pcm, 44100, 16, block_size=1024),
            encode_flac(pcm, 44100, 16, block_size=576, stereo="left_side",
                        partition_order=3),
            encode_flac(pcm, 44100, 16, block_size=1024,
                        force_subframe="verbatim")]


def _assert_front_matches(*args):
    """The fused front's kernel equals its plain form on every output, and
    launched once."""
    from claxon_tpu_torch.ops import seg_parse

    n = seg_parse.demux_front.launches
    got = seg_parse.demux_front(*args)
    assert seg_parse.demux_front.launches == n + 1
    want = seg_parse.demux_front_plain(*args)
    got = got[:7] + got[7] + got[8:]
    want = want[:7] + want[7] + want[8:]
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), (k, args[1:])
    torch.cuda.synchronize()
    return got


def test_sync_scan_kernel_matches_plain(cuda):
    """K5's kernels, and the fused front, equal their plain forms on a
    real stream, dense sync runs and noise, with capacities below the
    count and n_bytes below the upload."""
    from claxon_tpu_torch.ops import segment

    rng = np.random.default_rng(4)
    words, n = _payload_words(_small_streams()[0])
    saturated = np.frombuffer(bytes(np.where(
        rng.random(6000) < 0.5, 0xFF, 0xF8).astype(np.uint8)), ">i4") \
        .astype(np.int32)
    noise = rng.integers(-(1 << 31), 1 << 31, 3000, dtype=np.int64)
    cases = [(words, n, 64), (words, n, 3), (words, n - 5, 64),
             (saturated, 4 * len(saturated), 4096),
             (saturated, 4 * len(saturated), 100), (noise, 4 * 3000, 256),
             (noise[:1], 3, 8), (noise[:1], 1, 8)]
    for w, nb, C in cases:
        s = _c(w, cuda)
        got = segment.find_frame_headers(s, nb, C)
        want = segment.find_frame_headers_plain(s, nb, C)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (len(w), nb, C)
        # The fused front on the same bytes (its upload is little-endian).
        le = _c(np.asarray(w).astype(np.int32).byteswap(), cuda)
        _assert_front_matches(le, nb, _c(np.full(8, nb), cuda),
                              _c(np.full(8, 16), cuda), 1024, 2, C, 64)


def _walk_inputs(rng, n_frames, W, T):
    """Fuzzed walk lanes: start bits anywhere in (and past) the stream,
    block sizes around T, every channel mode, and bits per sample."""
    return (rng.integers(0, 32 * W + 2048, n_frames),
            rng.integers(0, T + 40, n_frames), rng.integers(0, 4, n_frames),
            rng.integers(1, 34, n_frames))


def test_walk_kernel_matches_plain_everywhere(cuda):
    """Every output of every lane equals the plain form's, rejected lanes
    included, on real frames and on fuzzed cursors and streams (reads
    past the stream end are zero bits in both)."""
    from claxon_tpu.pipeline_seg import host_header_fields
    from claxon_tpu_torch.ops import demux

    rng = np.random.default_rng(5)
    data = _small_streams()[1]
    words, n = _payload_words(data)
    _si, bb = native.extract_stream_bits(data, emit_slots=False,
                                         defer_crc=True)
    bf = bb.bframes
    payload = words.astype(">i4").tobytes()[:n]
    hlen = host_header_fields(np.frombuffer(payload, np.uint8),
                              bf["byte0"])["hlen"]
    real = ((bf["byte0"] + hlen) * 8, bf["block_size"], bf["mode"],
            bf["bps"])
    noise = rng.integers(-(1 << 31), 1 << 31, 700, dtype=np.int64)
    noise[::3] &= 0x00FFFFFF  # long zero runs: wasted-bit and unary edges
    for stream, lanes, T, nch in (
            (words, real, 576, 2), (words, real, 1024, 2),
            (words, _walk_inputs(rng, 100, len(words), 576), 576, 2),
            (noise, _walk_inputs(rng, 150, 700, 256), 256, 2),
            (noise, _walk_inputs(rng, 60, 700, 64), 64, 1),
            (noise[:3], _walk_inputs(rng, 20, 3, 192), 192, 2)):
        args = [_c(stream, cuda)] + [_c(a, cuda) for a in lanes]
        n0 = demux.walk_frames.launches
        out, end, ok = demux.walk_frames(*args, T, nch, deltas=True)
        assert demux.walk_frames.launches == n0 + 1
        p_out, p_end, p_ok = demux.walk_frames_plain(*args, T, nch,
                                                     deltas=True)
        assert torch.equal(ok, p_ok) and torch.equal(end, p_end)
        for k in demux.WALK_KEYS + ("deltas",):
            assert torch.equal(out[k], p_out[k]), (k, T, nch)
        # Without deltas the values kernel is the other instantiation.
        bare = demux.walk_frames(*args, T, nch)[0]
        assert "deltas" not in bare
        for k in demux.WALK_KEYS:
            assert torch.equal(bare[k], out[k]), (k, T, nch)
        if lanes is real:
            assert bool(ok.all())


def _generated_groups(device):
    """begin_segmented's group arguments for the fused demux on the
    generated corpus (uploaded to ``device``), without running it."""
    import claxon_tpu_torch.pipeline_seg as tseg
    from claxon_tpu_torch.ops import seg_parse

    datas = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    calls = []
    real = seg_parse.fused_demux_async
    seg_parse.fused_demux_async = lambda *a, **kw: calls.append(a)
    try:
        tseg.begin_segmented(datas, device=device)
    finally:
        seg_parse.fused_demux_async = real
    out = []
    for words_le, n_bytes, T, nch, ends_abs, bps, frames_est in calls:
        ends = np.full(8 * -(-len(ends_abs) // 8), n_bytes)
        ends[:len(ends_abs)] = ends_abs
        si_bps = np.ones(len(ends))
        si_bps[:len(bps)] = bps
        out.append((words_le, n_bytes, _c(ends, device), _c(si_bps, device),
                    T, nch, seg_parse.pick_cap(n_bytes, frames_est),
                    seg_parse.pick_wcap(n_bytes, frames_est)))
    return out


def test_fused_demux_kernels_match_plain(cuda):
    """The fused front (K6's bswap, K5, K6's field parse and compaction)
    and K6's summary kernel equal their plain forms on a real group and on
    noise, and
    the whole fused run equals the plain run on the CPU. The fused front
    also on the edge cases of its CPU model test (tests/front_cases.py:
    header copies at every offset around tile boundaries, dense sync runs
    cut at C mid-tile, more than 256 streams, W below 4, n_bytes below the
    upload), on an upload that is not 16-byte aligned and on every group
    of the generated corpus."""
    from claxon_tpu_torch.ops import seg_parse
    from claxon_tpu_torch.ops.demux import walk_frames

    from front_cases import FRONT_CASES, front_case

    for case in FRONT_CASES:
        words, n_bytes, ends, si_bps, T, nch, C, wcap = front_case(case)
        _assert_front_matches(_c(words, cuda), n_bytes, _c(ends, cuda),
                              _c(si_bps, cuda), T, nch, C, wcap)
    groups = _generated_groups(cuda)
    assert len(groups) >= 3
    for args in groups:
        counts = _assert_front_matches(*args)[-1]
        assert int(counts[1]) >= 1

    rng = np.random.default_rng(6)
    streams = _small_streams()
    raw = b"".join(streams)
    le = np.frombuffer(raw + b"\0" * ((-len(raw)) % 4), "<i4") \
        .astype(np.int32)
    ends = np.cumsum([len(s) for s in streams]).astype(np.int32)
    noise = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64) \
        .astype(np.int32)
    noise[::7] = np.int32(-0x00070001)  # 0xFFF8FFFF: sync-like words
    for words_le, T, nch, wcap in ((le, 1024, 2, 256), (noise, 4096, 2, 8),
                                   (noise, 256, 1, 256)):
        n_bytes = 4 * len(words_le)
        ends_p = np.full(8, n_bytes, np.int32)
        ends_p[:len(ends)] = ends
        bps = np.full(8, 16, np.int32)
        w_t, ends_t, bps_t = (_c(a, cuda) for a in (words_le, ends_p, bps))
        front = _assert_front_matches(w_t, n_bytes, ends_t, bps_t, T, nch,
                                      512, wcap)
        stream, pos, _valid, _count, _win, fields, lane_of = front[:7]
        assert torch.equal(stream, seg_parse.bswap_words_plain(w_t))
        walk, end_bits, ok = walk_frames(stream, *front[7:11], T, nch)
        sargs = (pos, fields, lane_of, end_bits, ok, walk["n_parts"],
                 walk["sa_words"], nch)
        assert torch.equal(seg_parse.pack_summary(*sargs),
                           seg_parse.pack_summary_plain(*sargs))
        # An upload that is not 16-byte aligned takes the kernels' word
        # loads.
        _assert_front_matches(w_t[1:], n_bytes - 4, ends_t, bps_t, T, nch,
                              512, wcap)
        dev_run = seg_parse.fused_demux_run(w_t, n_bytes, T, nch, ends_t,
                                            bps_t, 512, wcap)
        cpu_run = seg_parse.fused_demux_run(w_t.cpu(), n_bytes, T, nch,
                                            ends_t.cpu(), bps_t.cpu(), 512,
                                            wcap)
        assert torch.equal(dev_run[0].cpu(), cpu_run[0])
        for k in dev_run[1]:
            assert torch.equal(dev_run[1][k].cpu(), cpu_run[1][k]), k
        assert torch.equal(dev_run[2].cpu(), cpu_run[2])
        assert torch.equal(dev_run[3].cpu(), cpu_run[3])


def test_gather_kernel_matches_plain(cuda):
    from claxon_tpu_torch.ops import seg_gather

    rng = np.random.default_rng(7)
    R, NC = 50, 6
    values = rng.integers(-(1 << 31), 1 << 31, (R, NC * 32), dtype=np.int64)
    warm = rng.integers(-(1 << 31), 1 << 31, (R, 32), dtype=np.int64)
    order = rng.integers(0, 45, R)
    rows = rng.integers(-3, R + 3, 77)
    args = [_c(a, cuda) for a in (values, warm, order, rows)]
    for tb32 in (32, 64, NC * 32):
        got = seg_gather.gather_values(*args, tb32)
        assert torch.equal(got, seg_gather.gather_values_plain(*args, tb32))


def test_segmented_decode_on_the_card(cuda):
    """The segmented path on the card: bit-exact against the scalar
    decoder and the stored MD5s, through the fused front, the summary, K7
    and K8 (K5's own launches, segment.find_frame_headers, run 0
    times)."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import demux, seg_gather, seg_parse, segment

    datas = _small_streams() + [p.read_bytes()
                                for p in sorted(GENERATED.glob("*.flac"))]
    wrappers = (seg_parse.demux_front, seg_parse.pack_summary,
                demux.walk_frames, seg_gather.gather_values)
    before = [w.launches for w in wrappers]
    k5_alone = segment.find_frame_headers.launches
    dd = ct.decode_streams_device(datas, segmentation="device", device=cuda)
    after = [w.launches for w in wrappers]
    assert all(a > b for a, b in zip(after, before))
    assert segment.find_frame_headers.launches == k5_alone
    assert dd.segmented
    _assert_scalar_and_md5(datas, dd.to_host())
    assert_decodes_like_scalar(fuzzed_streams(), cuda, "device")


def _assert_scalar_and_md5(datas, results):
    """Each decode equals the scalar decoder's PCM and, where STREAMINFO
    stores one, its MD5."""
    from claxon_tpu_torch.testing import pcm_md5

    md5s = 0
    for data, dec in zip(datas, results):
        si, want = native.decode_stream_scalar(data)
        assert np.array_equal(dec.pcm, want)
        if any(si.md5sum):
            assert pcm_md5(dec.pcm, si.bits_per_sample) == si.md5sum
            md5s += 1
    assert md5s >= 1


def _staging_streams(lengths, seed):
    """Stereo 16-bit streams at block size 4096 (one segmented group),
    their payloads of assorted lengths mod 4."""
    from claxon_tpu_torch.testing import encode_flac, synth_music

    return [encode_flac(synth_music(n, channels=2, bps=16, seed=seed + k),
                        44100, 16, block_size=4096)
            for k, n in enumerate(lengths)]


def test_segmented_staging_buffer_is_reused(cuda, monkeypatch):
    """The segmented path stages each group's words in the card's pinned
    buffer: a large batch, a smaller one (the buffer holds the large
    one's bytes past its words), the large one again and a damaged copy
    of the small one decode as the scalar decoder does, with its CRC
    verdicts; the buffer grows once and is reused by every later group."""
    import claxon_tpu_torch as ct
    from claxon_tpu.error import Error as RefError
    from claxon_tpu_torch import pipeline_seg as ps
    from claxon_tpu_torch.error import FormatError

    monkeypatch.setattr(ps, "_STAGING", {})
    big = _staging_streams([90001, 70002, 80003, 60004], 31)
    small = _staging_streams([20001, 30003], 41)
    assert {len(d) % 4 for d in big + small} != {len(big[0]) % 4}
    bad = bytearray(small[0])
    bad[-1] ^= 0xFF  # a CRC-16 byte of the last frame
    bad = [bytes(bad)] + small[1:]
    with pytest.raises(RefError):
        native.decode_stream_scalar(bad[0])
    counts = []
    for datas in (big, small, big, bad):
        dd = ct.decode_streams_device(datas, segmentation="device",
                                      device=cuda)
        assert dd.segmented and dd.fallback_streams == []
        counts.append((dd.trace.counters["upload_staged"],
                       dd.trace.counters.get("upload_stage_grow", 0)))
        if datas is bad:
            with pytest.raises(FormatError, match="frame CRC mismatch"):
                dd.sync()
        else:
            dd.sync()
            _assert_scalar_and_md5(datas, dd.to_host())
    assert counts == [(1, 1), (1, 0), (1, 0), (1, 0)]
    assert list(ps._STAGING) == [torch.device("cuda",
                                              torch.cuda.current_device())]
    host = ps._STAGING[list(ps._STAGING)[0]].host
    assert host.is_pinned() and host.numel() >= sum(map(len, big))
    torch.cuda.synchronize()


def test_two_async_batches_in_flight(cuda):
    """Two ``decode_streams_device_async`` batches begun before either
    finishes (both groups staged in the one pinned buffer) decode as the
    scalar decoder does."""
    import claxon_tpu_torch as ct

    batches = [_staging_streams([50001, 40002], 51),
               _staging_streams([30003, 45004, 20005], 61)]
    handles = [ct.decode_streams_device_async(b, segmentation="device",
                                              device=cuda)
               for b in batches]
    for datas, h in zip(batches, handles):
        dd = h.finish()
        assert dd.segmented and dd.fallback_streams == []
        assert dd.trace.counters["upload_staged"] == 1
        _assert_scalar_and_md5(datas, dd.sync().to_host())
    torch.cuda.synchronize()


@functools.lru_cache(maxsize=1)
def _speech_streams():
    """256 mono 16 kHz 16-bit streams of 0.3-1.2 s (block 4096, LPC order
    8, partition orders 0-5), each ending in a short last frame, and their
    sample counts."""
    from claxon_tpu_torch.testing import encode_flac, synth_music

    lens = [int(round(s * 16000)) for s in np.linspace(0.3, 1.2, 256)]
    lens = [n + 1 if n % 4096 == 0 else n for n in lens]
    datas = [encode_flac(synth_music(n, channels=1, bps=16, seed=700 + k,
                                     sample_rate=16000),
                         16000, 16, block_size=4096, max_lpc_order=8,
                         partition_order=k % 6)
             for k, n in enumerate(lens)]
    return tuple(datas), tuple(lens)


def test_many_short_mono_streams_on_the_card(cuda, monkeypatch):
    """256 mono 16 kHz 16-bit streams of 0.3-1.2 s (block 4096, LPC order
    8, partition orders 0-5), each ending in a short last frame, as
    speech corpora ship their utterances: through the default route (its
    calibration on this batch, whichever path it keeps) and through the
    segmented path (one mono group, no stream on the host walk), both
    equal to the scalar decoder and the stored MD5s."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch import pipeline as tp

    datas, lens = _speech_streams()
    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setattr(tp, "_SEG_AUTO", {})
    dd = ct.decode_streams_device(datas, device=cuda)
    assert tp._SEG_AUTO["cuda"]["choice"] in ("device", "host")
    _assert_scalar_and_md5(datas, dd.sync().to_host())
    dd = ct.decode_streams_device(datas, segmentation="device", device=cuda)
    assert dd.segmented and dd.fallback_streams == []
    counters = dd.trace.counters
    assert counters["seg_streams"] == 256
    assert counters["seg_frames"] == sum(-(-n // 4096) for n in lens)
    assert counters["seg_fallback_streams"] == 0
    got = dd.sync().to_host()
    _assert_scalar_and_md5(datas, got)
    assert all(g.frame_sizes[-1] == n % 4096 for g, n in zip(got, lens))
    torch.cuda.synchronize()


def test_speech_batch_shares_one_pcm_allocation_on_the_card(cuda,
                                                           monkeypatch):
    """The 256 short mono streams through the default route, given the
    segmented path that its calibration keeps in the benchmark's speech
    cell: one PCM allocation for the batch's one group, zero until
    ``to_host()``; ``sync()`` gives the CRC verdict and ``to_host()`` is
    bit-exact. With one stream's last CRC-16 byte damaged, ``sync()``
    raises the frame CRC mismatch, and ``to_host()`` again after it."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch.error import FormatError

    datas, lens = _speech_streams()
    datas = list(datas)
    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setitem(tp._SEG_AUTO, "cuda", {"choice": "device",
                                               "seconds": None})
    dd = ct.decode_streams_device(datas, device=cuda)
    assert dd.segmented and dd.fallback_streams == []
    counters = dd.trace.counters
    assert counters["seg_streams"] == 256
    assert counters["seg_pcm_allocs"] == 1
    assert counters["seg_pcm_bytes"] == 4 * sum(lens)
    assert not any(r.pcm.any() for r in dd.results)
    _assert_scalar_and_md5(datas, dd.sync().to_host())
    bad = bytearray(datas[100])
    bad[-1] ^= 0xFF  # a CRC-16 byte of the last frame
    datas[100] = bytes(bad)
    dd = ct.decode_streams_device(datas, device=cuda)
    assert dd.segmented and dd.fallback_streams == []
    assert dd.trace.counters["seg_pcm_allocs"] == 1
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.sync()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    torch.cuda.synchronize()


def test_surround_track_past_the_batch_limit_on_the_card(cuda, monkeypatch):
    """One 5.1 hi-res track at the benchmark configuration's widths (six
    independent channels, 24 bits, 96 kHz, block 4096, LPC order 12,
    RICE2), 2,500 frames of a 16-frame pool and past 2^27 bytes, through
    the default route: the host walk in chunks, each run planned and
    uploaded apart, bit-exact against the plain reference's PCM of the
    pool and the stored MD5, with the walk counters of the track."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch import pipeline_bits as tpb
    from claxon_tpu_torch.native.binding import _read_metadata
    from claxon_tpu_torch.testing import pcm_md5
    from flacbench.gen import assemble, pool
    from flacbench.harness import Bench
    from flacbench.reference import check

    config = dict(Bench().config("surround51-flac8"), pool_frames=16,
                  pool_segment_frames=8)
    frames = pool.Pool(pool.build_pool(config, workers=1), config)
    order = np.random.default_rng(51).integers(0, 16, 2500)
    track = assemble.assemble_track(frames, order)
    data = track.data
    assert len(data) > tpb.MAX_BATCH_BYTES
    si, pos = _read_metadata(data)
    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setattr(tp, "_SEG_AUTO", {})
    dd = ct.decode_streams_device([data], device=cuda)
    assert not dd.seg_engaged
    counters = dd.trace.counters
    plans = [s for s in dd.trace.spans if s[0] == "claxon.walk.plan"]
    units = -(-2500 // ((tpb.MAX_BATCH_BYTES - 5) // si.max_frame_size))
    assert (counters["walk_streams"], counters["walk_units"],
            counters["walk_frames"], counters["walk_bytes"]) == \
        (1, units, 2500, len(data) - pos)
    assert units > 1 and 1 < counters["walk_runs"] == len(plans) <= units
    dd.sync()
    assert check.compare_device(dd, [track], frames) == {
        "mismatched_samples": 0, "uncovered_samples": 0,
        "overlapping_samples": 0}
    (got,) = dd.to_host()
    assert np.array_equal(got.pcm, check.expected(frames, track))
    assert pcm_md5(got.pcm, 24) == bytes(si.md5sum)
    torch.cuda.synchronize()


def test_front_regrows_on_the_card(cuda, monkeypatch):
    """test_torch_seg_pipeline.py::test_capacity_overflow_regrows on the
    card: capacities of 8 re-dispatch the fused demux with larger classes,
    the fused front equals its plain form at every capacity, and the
    decode stays bit-exact."""
    import claxon_tpu_torch as ct
    from claxon_tpu.testing import encode_flac, synth_music
    from claxon_tpu_torch.ops import seg_parse

    data = encode_flac(synth_music(6000, channels=2, bps=16, seed=11),
                       44100, 16, block_size=576)
    calls = []
    front = seg_parse.demux_front
    monkeypatch.setattr(seg_parse, "pick_cap", lambda *a: 8)
    monkeypatch.setattr(seg_parse, "pick_wcap", lambda *a: 8)

    def recording(*args):
        calls.append(args)
        return front(*args)

    # The wrapper counts its launches on the module's name.
    recording.launches = 0
    monkeypatch.setattr(seg_parse, "demux_front", recording)
    dd = ct.decode_streams_device([data], segmentation="device",
                                  device=cuda)
    assert dd.segmented and dd.fallback_streams == []
    _assert_scalar_and_md5([data], dd.to_host())
    caps = [(a[6], a[7]) for a in calls]
    assert caps[0] == (8, 8) and len(caps) >= 2
    assert caps[-1][0] > 8 and caps[-1][1] > 8
    monkeypatch.undo()
    for a in calls:
        _assert_front_matches(*a)


def test_segmented_65535_bucket_on_the_card(cuda):
    """A STREAMINFO block size in the 65535 bucket (the one T that is not
    a multiple of 32) rides the segmented path bit-exactly."""
    import claxon_tpu_torch as ct
    from claxon_tpu.testing import encode_flac, synth_music

    data = encode_flac(synth_music(80000, channels=1, bps=16, seed=65),
                       44100, 16, block_size=40000)
    dd = ct.decode_streams_device([data], segmentation="device", device=cuda)
    assert dd.segmented and dd.fallback_streams == []
    assert np.array_equal(dd.to_host()[0].pcm,
                          native.decode_stream_scalar(data)[1])


class _BitWriter:
    """Big-endian bit writer for hand-made subframes."""

    def __init__(self, n_bits=0):
        self.bits = [0] * n_bits

    def put(self, v, n):
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def rice(self, v, k):
        u = (v << 1) ^ (v >> 63)  # zig-zag
        self.bits.extend([0] * (u >> k) + [1])
        self.put(u & ((1 << k) - 1), k)

    def words(self, n_words=None):
        bits = self.bits + [0] * ((-len(self.bits)) % 32)
        w = np.packbits(np.array(bits, np.uint8)).view(">u4")
        if n_words is not None:
            w = np.concatenate([w, np.zeros(max(0, n_words - len(w)),
                                            ">u4")])[:n_words]
        return w.astype(np.int64).astype(np.uint32).view(np.int32)


def _subframe(bw, rng, kind, bs, bps, porder=0, k=None, code_bits=None):
    """Append one subframe: ("fixed", order) with a Rice residual (each
    partition's k given, or random small residuals; ``code_bits`` makes
    every code that long), ("verbatim",) or ("constant",)."""
    if kind[0] == "constant":
        bw.put(0, 8)
        bw.put(int(rng.integers(0, 1 << bps)), bps)
        return
    if kind[0] == "verbatim":
        bw.put(1 << 1, 8)
        for _ in range(bs):
            bw.put(int(rng.integers(0, 1 << bps)), bps)
        return
    order = kind[1]
    bw.put((8 + order) << 1, 8)
    for _ in range(order):
        bw.put(int(rng.integers(0, 1 << bps)), bps)
    bw.put(0, 2)
    bw.put(porder, 4)
    ps = bs >> porder
    for p in range(1 << porder):
        kp = int(rng.integers(0, 15)) if k is None else k
        bw.put(kp, 4)
        for _ in range(ps - (order if p == 0 else 0)):
            if code_bits is not None:  # unary 0, then code_bits - 1 bits
                bw.put(1, 1)
                bw.put(int(rng.integers(0, 1 << kp)) if kp else 0, kp)
            else:
                bw.rice(int(rng.integers(-(1 << kp) * 3, (1 << kp) * 3 + 1)),
                        kp)


def _synthetic_group(rng, frames, nch, lead_bits=0, n_words=None):
    """One stream of back-to-back hand-made frames (no frame headers: each
    walk starts at its first subframe) and their walk lanes. ``frames`` is
    a list of (bs, mode, bps, [per-channel subframe kwargs]) or None for a
    padding lane (bs 0, start 0, bps 1)."""
    bw = _BitWriter(lead_bits)
    lanes = []
    for fr in frames:
        if fr is None:
            lanes.append((0, 0, 0, 1))
            continue
        bs, mode, bps, chans = fr
        lanes.append((len(bw.bits), bs, mode, bps))
        for ch, kw in enumerate(chans):
            side = nch == 2 and ((ch == 1 and mode in (1, 3)) or
                                 (ch == 0 and mode == 2))
            _subframe(bw, rng, bps=bps + side, bs=bs, **kw)
        bw.put(0, (-len(bw.bits)) % 8)
    return bw.words(n_words), tuple(np.array(c) for c in zip(*lanes))


def _walk_edge_cases(rng):
    """(name, stream words, (start_bits, bs, modes, bps), T, nch): the
    redesigned walk's edges (ring refills, 32-bit verbatim lanes, block
    sizes 1, 31, 33 and T, padding lanes, 8 channels, T = 65535, streams
    whose word count is not a multiple of 4)."""
    fx = dict(kind=("fixed", 0), porder=4, k=3, code_bits=4)
    # 16 partitions of 255 4-bit codes: 1024 bits each, so every partition
    # starts on a 16-byte unit once the residual does (lead bits 114 put
    # the residual start at bit 128), or half a unit later (lead 50).
    refill = [(4080, 0, 16, [fx, fx])]
    cases = [(f"refills, lead {lead}", lead, refill * 3, 4096, 2)
             for lead in (114, 50, 3)]
    cases.append(("random Rice partitions", 0, [
        (4096, m, 16, [dict(kind=("fixed", o), porder=po)] * 2)
        for m, o, po in ((0, 2, 5), (1, 4, 6), (3, 1, 0), (2, 0, 3))],
        4096, 2))
    cases.append(("32-bit verbatim", 0, [
        (256, 0, 32, [dict(kind=("verbatim",))] * 2),
        (256, 0, 32, [dict(kind=("verbatim",)),
                      dict(kind=("fixed", 2), porder=2)]),
        (256, 1, 31, [dict(kind=("verbatim",))] * 2)], 256, 2))
    for T in (32, 64, 256):
        cases.append((f"block sizes 1, 31, 33, T at T={T}", 0, [
            (bs, 0, 16, [dict(kind=kind)] * 2)
            for bs in (1, 31, 33, T) if bs <= T
            for kind in (("fixed", 0), ("verbatim",), ("constant",),
                         ("fixed", 1))], T, 2))
    real = (512, 3, 16, [dict(kind=("fixed", 2), porder=3)] * 2)
    cases.append(("padding lanes between real lanes", 0,
                  [real, None, real, None, None, real, None], 512, 2))
    cases.append(("8 channels", 0, [
        (1024, 0, 24, [dict(kind=("fixed", c % 5), porder=c % 4)
                       for c in range(8)])] * 3, 1024, 8))
    cases.append(("T = 65535", 0, [
        (65535, 0, 16, [dict(kind=("fixed", 1), porder=0, k=2)]),
        (40000, 0, 16, [dict(kind=("fixed", 3), porder=6)])], 65535, 1))
    out = []
    for name, lead, frames, T, nch in cases:
        words, lanes = _synthetic_group(rng, frames, nch, lead)
        out.append((name, words, lanes, T, nch))
        if name == "random Rice partitions":
            # The stream cut to word counts 4n + 1, 4n + 2, 4n + 3 inside
            # the last frame: the last copies are partial, the rest reads
            # as zero bits.
            n = (len(words) - 40) // 4 * 4
            for r in (1, 2, 3):
                out.append((f"{name}, {n + r} words", words[:n + r], lanes,
                            T, nch))
    return out


def _assert_walk_equal(got, want, label):
    out, end, ok = got
    p_out, p_end, p_ok = want
    assert torch.equal(ok, p_ok) and torch.equal(end, p_end), label
    for k in p_out:
        assert torch.equal(out[k], p_out[k]), (label, k)


@pytest.mark.parametrize("case", range(14))
def test_walk_kernel_edges(cuda, case):
    """Every output of the redesigned walk equals the plain form's on the
    cases it was designed around (``_walk_edge_cases``)."""
    from claxon_tpu_torch.ops import demux

    name, words, lanes, T, nch = _walk_edge_cases(
        np.random.default_rng(9))[case]
    args = [_c(words, cuda)] + [_c(a, cuda) for a in lanes]
    got = demux.walk_frames(*args, T, nch, deltas=True)
    _assert_walk_equal(got, demux.walk_frames_plain(*args, T, nch,
                                                    deltas=True), name)
    if name.startswith(("refills", "8 channels", "T = ", "padding")) or \
            name == "random Rice partitions":
        real = torch.from_numpy(lanes[1] > 0)
        assert bool(got[2].cpu()[real].all()), name


def test_walk_kernel_misaligned_stream(cuda):
    """A stream view that is not 16-byte aligned: the walk copies 4 bytes
    at a time and gives the plain form's outputs."""
    from claxon_tpu_torch.ops import demux

    _name, words, lanes, T, nch = _walk_edge_cases(
        np.random.default_rng(9))[3]
    big = _c(np.concatenate([[0], words]), cuda)
    stream = big[1:]
    assert stream.data_ptr() % 16 != 0
    args = [stream] + [_c(a, cuda) for a in lanes]
    _assert_walk_equal(demux.walk_frames(*args, T, nch),
                       demux.walk_frames_plain(*args, T, nch), "misaligned")
    _assert_walk_equal(demux.walk_frames(*args, T, nch),
                       demux.walk_frames(stream.clone(), *args[1:], T, nch),
                       "misaligned vs aligned")


# rice_decode, crc16_device and crc16_frames_device: the JAX package's
# device functions that no decode route calls (csrc/rice.cu,
# csrc/crc_lanes.cu), on the CPU tests' garbage cases and at the headline
# x4 shapes.

def _rice_case_count():
    from claxon_tpu_torch.testing import rice_crc_cases

    return len(rice_crc_cases.rice_calls())


@pytest.mark.parametrize("i", range(_rice_case_count()))
def test_rice_kernel_matches_plain_on_garbage(cuda, i):
    """Calls 1 and 2 run searches off the buffer: the kernel flags them
    and its one-block exact pass decodes the input again."""
    from claxon_tpu_torch.ops import rice
    from claxon_tpu_torch.testing import rice_crc_cases

    call = rice_crc_cases.rice_calls()[i]
    words, sb, ks, cs, T = call["args"]
    T = max(int(cs.max()), 0) if T is None else T
    args = [_c(a, cuda) for a in (words, sb, ks, cs)]
    n = rice.rice_decode.launches
    got = rice.rice_decode(*args, max_count=T)
    assert rice.rice_decode.launches == n + 1
    want = rice.rice_decode_plain(*args, T)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cpu = rice.rice_decode(*[a.cpu() for a in args], max_count=T)
    assert torch.equal(got[0].cpu(), cpu[0])
    if "values" in call:
        v = call["values"]
        assert np.array_equal(got[0].cpu().numpy()[:, :v.shape[1]], v)


@pytest.mark.parametrize("lanes, codes", [(27648, 1024), (100, 4097),
                                          (33, 1)])
def test_rice_kernel_at_headline_shapes(cuda, lanes, codes):
    """27,648 partitions of 1,024 codes (the headline x4 bucket's, L x P),
    and ragged shapes: the values that made the buffer, and the plain
    form."""
    from claxon_tpu_torch.ops import rice
    from claxon_tpu_torch.testing import rice_crc_cases

    st = rice_crc_cases.rice_stream(np.full(lanes, codes), seed=lanes)
    args = [_c(st[k], cuda) for k in ("words", "start_bits", "params",
                                      "counts")]
    out, end = rice.rice_decode(*args)
    assert np.array_equal(out.cpu().numpy(), st["values"])
    assert np.array_equal(end.cpu().numpy()[:-1], st["start_bits"][1:])
    want = rice.rice_decode_plain(*args, codes)
    assert torch.equal(out, want[0]) and torch.equal(end, want[1])


def test_crc16_rows_kernel_matches_plain(cuda):
    """The CPU tests' rows (seed 12, lengths outside [0, B], values outside
    0..255) and random ragged shapes (B not a multiple of 4, lengths
    everywhere)."""
    from claxon_tpu_torch.ops import crc
    from claxon_tpu_torch.testing import rice_crc_cases

    rng = np.random.default_rng(17)
    cases = [c["args"] for c in rice_crc_cases.crc16_rows_calls()]
    for L, B in ((1, 1), (7, 129), (300, 1023), (1000, 4097)):
        data = rng.integers(-(1 << 31), 1 << 31, (L, B), dtype=np.int64)
        cases.append((data, rng.integers(-5, B + 6, L)))
    for data, lengths in cases:
        args = [_c(data, cuda), _c(lengths, cuda)]
        n = crc.crc16_device.launches
        got = crc.crc16_device(*args)
        assert crc.crc16_device.launches == n + 1
        assert torch.equal(got, crc.crc16_device_plain(*args))


@pytest.mark.parametrize("n_words", [1, 2, 32, 64, 1024, 4096])
def test_crc16_windows_kernel_matches_plain(cuda, n_words):
    """The CPU tests' ranges (seed 21: starts > ends, negative starts,
    ends past the upload, int32 extremes) at every window size, and
    random ranges on a larger upload; a range inside its window equals
    K4 (crc16_ranges), which clamps only outside the upload."""
    from claxon_tpu_torch.ops import crc
    from claxon_tpu_torch.testing import rice_crc_cases

    stream, starts, ends, _ = rice_crc_cases.crc16_windows_calls()[0]["args"]
    rng = np.random.default_rng(n_words)
    big = rng.integers(-(1 << 31), 1 << 31, 50000, dtype=np.int64)
    a = rng.integers(0, 200000 - 4 * n_words, 3000)
    b = a + rng.integers(0, 4 * n_words + 1, a.size)  # inside the upload
    for s, st, en in ((stream, starts, ends), (big, a, b)):
        args = [_c(x, cuda) for x in (s, st, en)]
        n = crc.crc16_frames_device.launches
        got = crc.crc16_frames_device(*args, n_words)
        assert crc.crc16_frames_device.launches == n + 1
        assert torch.equal(got, crc.crc16_frames_device_plain(*args,
                                                              n_words))
    assert torch.equal(got, crc.crc16_ranges(*args))


def _rice_edge_count():
    from claxon_tpu_torch.testing import rice_crc_cases

    return len(rice_crc_cases.rice_edge_calls())


@pytest.mark.parametrize("i", range(_rice_edge_count()))
def test_rice_kernel_edges_match_plain(cuda, i):
    """The ring's edges (rice_crc_cases.rice_edge_calls: a zero run
    longer than a lane's ring, cursors that enter the buffer from below
    or leave it mid-partition, codes that outrun the landed words, lanes
    that start inside a zero run): the kernel equals the plain form."""
    from claxon_tpu_torch.ops import rice
    from claxon_tpu_torch.testing import rice_crc_cases

    call = rice_crc_cases.rice_edge_calls()[i]
    words, sb, ks, cs, T = call["args"]
    args = [_c(a, cuda) for a in (words, sb, ks, cs)]
    n = rice.rice_decode.launches
    got = rice.rice_decode(*args, max_count=T)
    assert rice.rice_decode.launches == n + 1
    want = rice.rice_decode_plain(*args, T)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if "values" in call:
        v = call["values"]
        assert np.array_equal(got[0].cpu().numpy()[:v.shape[0], :v.shape[1]],
                              v)


@pytest.mark.parametrize("lanes, codes, long_share",
                         [(27648, 1024, 0.01), (100, 4097, 0.3),
                          (33, 1, 0.01)])
def test_rice_kernel_matches_plain(cuda, lanes, codes, long_share):
    """The headline x4 shapes and ragged ones, with the generator's long
    unary runs at 1% and 30% of the codes: the kernel equals its plain
    form and the values that made the buffer, and on the garbage calls of
    rice_calls its plain form too."""
    from claxon_tpu_torch.ops import rice
    from claxon_tpu_torch.testing import rice_crc_cases

    st = rice_crc_cases.rice_stream(np.full(lanes, codes), seed=lanes + 1,
                                    long_share=long_share)
    calls = [(st["words"], st["start_bits"], st["params"], st["counts"],
              codes)]
    calls += [c["args"] for c in rice_crc_cases.rice_calls()]
    for words, sb, ks, cs, T in calls:
        T = max(int(cs.max()), 0) if T is None else T
        args = [_c(a, cuda) for a in (words, sb, ks, cs)]
        got = rice.rice_decode(*args, max_count=T)
        want = rice.rice_decode_plain(*args, T)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out = rice.rice_decode(*[_c(st[k], cuda) for k in (
        "words", "start_bits", "params", "counts")], max_count=codes)[0]
    assert np.array_equal(out.cpu().numpy(), st["values"])


def _windows_edge_calls():
    from claxon_tpu_torch.testing import rice_crc_cases

    calls = rice_crc_cases.crc16_windows_edge_calls()
    seed21 = rice_crc_cases.crc16_windows_calls()[0]["args"][:3]
    return calls + [{"args": (*seed21, n_words), "labels": {}}
                    for n_words in (2, 4096)]


@pytest.mark.parametrize("i", range(8))
def test_crc16_windows_kernel_edges_match_plain(cuda, i):
    """The word skip, the loads and the items at their edges
    (rice_crc_cases.crc16_windows_edge_calls: ends - 4 n_words wrapping,
    kept suffixes of every length mod 4 at every ends mod 4, the upload's
    edges, ranges of several 4 KB items; the seed-21 ranges at n_words 2
    and 4096), from a 16-byte-aligned stream and from one that is not
    (its 4-byte clipped loads): the kernel equals the plain form."""
    from claxon_tpu_torch.ops import crc

    calls = _windows_edge_calls()
    assert len(calls) == 8
    stream, starts, ends, n_words = calls[i]["args"]
    st, en = _c(starts, cuda), _c(ends, cuda)
    padded = _c(np.concatenate([[7], stream]), cuda)
    for s in (_c(stream, cuda), padded[1:]):
        n = crc.crc16_frames_device.launches
        got = crc.crc16_frames_device(s, st, en, n_words)
        assert crc.crc16_frames_device.launches == n + 1
        assert torch.equal(got, crc.crc16_frames_device_plain(s, st, en,
                                                              n_words))


def test_new_wrappers_launch_or_raise(cuda):
    """CUDA tensors of another dtype, or on two devices, raise; nothing
    falls back to the plain forms."""
    from claxon_tpu_torch.ops import crc, rice

    w = torch.ones(8, dtype=torch.int64, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rice.rice_decode(w, one, one, one)
    with pytest.raises(TypeError):
        crc.crc16_device(w.view(2, 4), one.repeat(2))
    with pytest.raises(TypeError):
        crc.crc16_frames_device(w, one, one, 2)
    with pytest.raises(ValueError):
        crc.crc16_frames_device(w.to(torch.int32), one.cpu(), one, 2)


def test_framedesc_route_headline_bucket_matches_plain(cuda):
    """The FrameDesc route at full width: headline x4 through
    native.extract_stream and decode_batches_device is one bucket (L 6912,
    T 4096) whose residuals go up as int16 pairs. K3b unpack, then K1 + K3,
    one launch each, equal to their plain forms on the same upload; the
    landed fetch (one interleave_runs launch, no K3b pack) gives the
    scalar decoder's PCM."""
    from claxon_tpu_torch import native as tnative
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch.ops import epilogue, predict
    from claxon_tpu_torch.pipeline_bits import _pack_input_i16

    datas = _headline_x4()
    batches = [tnative.extract_stream(d) for d in datas]
    wrappers = (predict.synthesize_epilogue, epilogue.unpack_int16_pairs,
                epilogue.pack_int16_pairs, predict.synthesize)
    before = [w.launches for w in wrappers]
    dd = tp.decode_batches_device(batches, device=cuda)
    assert [w.launches for w in wrappers] == [before[0] + 1, before[1] + 1,
                                              before[2], before[3]]
    (d,) = dd.dispatches
    assert tuple(d.out_full.shape) == (6912, 4096) and d.packed
    x, coefs, shifts, orders, wasted, pair_modes, lengths = tp.pack_bucket(
        dd.frames, d.frame_idx, 2, 4096)
    x16 = _c(_pack_input_i16(x), cuda)
    unpacked = epilogue.unpack_int16_pairs(x16)
    assert torch.equal(unpacked, epilogue.unpack_int16_pairs_plain(x16))
    assert torch.equal(unpacked, _c(x, cuda))
    args = [_c(a, cuda) for a in (coefs, shifts, orders, lengths, wasted,
                                  pair_modes)]
    plain = predict.synthesize_epilogue_plain(unpacked, *args)
    assert torch.equal(d.out_full, plain)
    n = epilogue.interleave_runs.launches
    out = dd.to_host()
    assert epilogue.pack_int16_pairs.launches == before[2]
    assert epilogue.interleave_runs.launches == n + 1 and d.flag is None
    _assert_scalar_and_md5(datas, out)
    torch.cuda.synchronize()


def test_framedesc_route_24bit_bucket_does_not_pack(cuda):
    """use_native=False on the generated corpus, on the card: every bucket
    packs its output exactly when all its frames are 16-bit or narrower
    (the 24-bit and 20-bit streams' buckets do not); every bucket is
    landed, one ``interleave_runs`` launch each and no K3b pack, and the
    PCM is the scalar decoder's."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.ops import epilogue

    datas = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    dd = ct.decode_streams_device(datas, False, device=cuda)
    want = [all(dd.frames[fi].bps <= 16 for fi in d.frame_idx)
            for d in dd.dispatches]
    assert [d.packed for d in dd.dispatches] == want
    assert not all(want) and any(want)
    n = (epilogue.pack_int16_pairs.launches,
         epilogue.interleave_runs.launches)
    _assert_scalar_and_md5(datas, dd.to_host())
    assert (epilogue.pack_int16_pairs.launches,
            epilogue.interleave_runs.launches) == \
        (n[0], n[1] + len(dd.dispatches))
    torch.cuda.synchronize()


@pytest.mark.parametrize("segmentation", ["host", "device"])
def test_two_shards_on_one_card(cuda, segmentation):
    """A mesh of two shards on the one card (``make_mesh(devices=[cuda,
    cuda])``) on two headline streams, one bucket: each per-lane kernel
    launches once a shard and the group kernels once; both shards lie on
    the card, (L / 2, T) each, and stacked equal the unsharded bucket; the
    per-shard CRC pairs count the batch's frames; the PCM is the scalar
    decoder's."""
    import chip_smoke
    from claxon_tpu_torch import pipeline as tp
    from claxon_tpu_torch import pipeline_seg as ps
    from claxon_tpu_torch.ops import (crc, entropy, epilogue, predict,
                                      seg_gather, seg_parse)
    from claxon_tpu_torch.parallel import lane_quantum, make_mesh

    datas = chip_smoke.headline_corpus()[:2]
    mesh = make_mesh(devices=[cuda, cuda])
    assert mesh.size == 2 and lane_quantum(mesh) == 128
    per_lane = [predict.synthesize_epilogue, crc.crc16_ranges,
                entropy.decode_residual_bits_stream if segmentation == "host"
                else seg_gather.gather_values]
    group = [seg_parse.demux_front] if segmentation == "device" else []

    def decode(mesh=None):
        if segmentation == "host":
            return tp._decode_host_walk(datas, 128, cuda, mesh=mesh)
        return ps.decode_streams_segmented(datas, device=cuda, mesh=mesh)

    one = decode()
    before = [w.launches for w in per_lane + group]
    dd = decode(mesh)
    torch.cuda.synchronize()
    after = [w.launches for w in per_lane + group]
    assert after == [b + 2 for b in before[:len(per_lane)]] + \
        [b + 1 for b in before[len(per_lane):]]
    assert dd.fallback_streams == one.fallback_streams == []
    (_fi, _nch, shards), = dd.device_buckets()
    (_fi, _nch, whole), = one.device_buckets()
    L, T = whole.shape
    assert [(tuple(s.shape), s.device.type) for s in shards] == \
        [((L // 2, T), "cuda")] * 2
    assert torch.equal(torch.cat(shards), whole)
    assert sum(n for _v, n in dd.crc_check) == \
        sum(n for _v, n in one.crc_check)
    n = (epilogue.pack_int16_pairs.launches,
         epilogue.interleave_runs.launches)
    _assert_scalar_and_md5(datas, dd.to_host())
    # Sharded buckets keep the host scatter: K3b pack a shard.
    assert (epilogue.pack_int16_pairs.launches,
            epilogue.interleave_runs.launches) == (n[0] + 2, n[1])
    assert dd.trace.counters["fetch_scattered_buckets"] == 1
    assert dd.trace.counters["fetch_landed_buckets"] == 0
    torch.cuda.synchronize()


def test_sample_shipping_route_on_the_card(cuda, monkeypatch):
    """CLAXON_TPU_NO_BITS on the card: headline x4 is one raw bucket (L
    6912, T 4096) uploaded as int16 pairs; K3b unpack and K1 + K3 launch
    once each, equal to their plain forms on the same upload, and no
    entropy, CRC or segmented kernel runs; the landed fetch (one
    interleave_runs launch, no K3b pack) gives the scalar decoder's PCM. The generated corpus, two headline
    streams over two shards of the card, and the Ogg and MP4 calls decode
    bit-exactly too."""
    import claxon_tpu_torch as ct
    import claxon_tpu_torch.pipeline_bits as tbits
    from claxon_tpu_torch.ops import (crc, demux, entropy, epilogue,
                                      predict, seg_gather, seg_parse)
    from claxon_tpu_torch.parallel import lane_quantum, make_mesh
    from claxon_tpu_torch.testing import mux_mp4_flac, mux_ogg_flac

    monkeypatch.setenv("CLAXON_TPU_NO_BITS", "1")
    datas = _headline_x4()
    uploads = []
    shards = tbits._decode_sample_shards
    monkeypatch.setattr(tbits, "_decode_sample_shards",
                        lambda *a: uploads.append(a) or shards(*a))
    path = (predict.synthesize_epilogue, epilogue.unpack_int16_pairs)
    absent = (epilogue.pack_int16_pairs, predict.synthesize,
              entropy.decode_residual_bits_stream,
              entropy.decode_residual_bits,
              entropy.decode_residual_bits_stream_delta, crc.crc16_ranges,
              seg_parse.demux_front, demux.walk_frames,
              seg_gather.gather_values)
    before = [w.launches for w in path + absent]
    dd = ct.decode_streams_device(datas, segmentation="device", device=cuda)
    torch.cuda.synchronize()
    assert [w.launches for w in path + absent] == \
        [b + 1 for b in before[:2]] + before[2:]
    (d,) = dd.dispatches
    assert tuple(d.out_full.shape) == (6912, 4096) and d.packed
    ((arrays, in_packed, _mesh),) = uploads
    assert in_packed and dd.upload_bytes == sum(a.nbytes for a in arrays)
    x16 = _c(arrays[0], cuda)
    unpacked = epilogue.unpack_int16_pairs(x16)
    assert torch.equal(unpacked, epilogue.unpack_int16_pairs_plain(x16))
    coefs, shifts, orders, wasted, pair_modes, lengths = (
        _c(a, cuda) for a in arrays[1:])
    assert torch.equal(d.out_full, predict.synthesize_epilogue_plain(
        unpacked, coefs, shifts, orders, lengths, wasted, pair_modes))
    n = (epilogue.pack_int16_pairs.launches,
         epilogue.interleave_runs.launches)
    _assert_scalar_and_md5(datas, dd.to_host())
    assert (epilogue.pack_int16_pairs.launches,
            epilogue.interleave_runs.launches) == (n[0], n[1] + 1)
    assert d.flag is None
    generated = [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]
    _assert_scalar_and_md5(generated, ct.decode_streams(generated,
                                                        device=cuda))
    mesh = make_mesh(devices=[cuda, cuda])
    two = ct.decode_streams_device(datas[:2], lane_quantum=lane_quantum(mesh),
                                   device=cuda, mesh=mesh)
    (_fi, _nch, halves), = two.device_buckets()
    assert [s.device.type for s in halves] == ["cuda"] * 2
    _assert_scalar_and_md5(datas[:2], two.to_host())
    _assert_scalar_and_md5(datas[:1] * 2, [
        ct.decode_ogg_stream(mux_ogg_flac(datas[0]), device=cuda),
        ct.decode_mp4_stream(mux_mp4_flac(datas[0], 3), device=cuda)])
    torch.cuda.synchronize()
