"""Inputs of the port's ``ops.rice.rice_decode``, ``ops.crc.crc16_device``
and ``ops.crc.crc16_frames_device``: a Rice bit buffer made with
vectorised numpy from a seed, with the values that made it, and the
garbage cases that the CPU tests hold the plain forms to the JAX package
with and that the card tests and ``chip_smoke.py`` hold the kernels to
the plain forms with.

Each ``*_calls`` function returns a list of calls, each a dict with
``args`` (numpy arrays and ints, in the function's argument order) and
``labels`` (case name -> the slice of lanes, rows or ranges that shows
it). The cases of one function share as few shapes as they can, so the
JAX package compiles few programs for them. Imports neither JAX nor
torch.
"""

import numpy as np

from ..crc import crc16

__all__ = ["rice_stream", "rice_calls", "crc16_rows_calls",
           "crc16_windows_calls", "INT32_MIN", "INT32_MAX"]

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
_M32 = 0xFFFFFFFF


def _pack_bits_be(data):
    from ..ops.rice import pack_bits_be

    return pack_bits_be(data)


def rice_stream(counts, seed, ks=tuple(range(15)), long_share=0.01,
                quotients=None, lead=0):
    """One Rice partition a lane, lane after lane in one bit buffer, after
    ``lead`` set bits.

    Lane l has ``counts[l]`` codes of a parameter drawn from ``ks``; a
    quotient is geometric (mean 1), or with probability ``long_share``
    between 32 and 299 (a unary run across words), or drawn from
    ``quotients`` when that is given; a remainder is uniform below 2^k.
    Returns a dict: ``words`` (int32, :func:`pack_bits_be`'s packing with
    its all-ones guard word), ``start_bits``, ``params``, ``counts``
    (int32, (L,)) and ``values`` ((L, max(counts)) int32, the decoded
    residuals, 0 past each count). Vectorised: no per-code Python."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    L, n = counts.size, int(counts.max(initial=0))
    k = rng.choice(np.asarray(ks, np.int64), L)
    live = np.arange(n)[None, :] < counts[:, None]           # (L, n)
    if quotients is None:
        q = rng.geometric(0.5, (L, n)).astype(np.int64) - 1
        q = np.where(rng.random((L, n)) < long_share,
                     rng.integers(32, 300, (L, n)), q)
    else:
        q = rng.choice(np.asarray(quotients, np.int64), (L, n))
    r = (rng.random((L, n)) * (1 << k)[:, None]).astype(np.int64)
    kk = np.broadcast_to(k[:, None], (L, n))
    v = ((q << kk) | r) & _M32
    values = np.where(v & 1, -1 - (v >> 1), v >> 1)
    values = np.where(live, values, 0).astype(np.int32)
    # Bit positions, codes in lane order.
    qf, rf, kf = q[live], r[live], kk[live]
    length = qf + 1 + kf
    start = lead + np.concatenate([[0], np.cumsum(length)[:-1]]) \
        if length.size else np.zeros(0, np.int64)
    total = lead + int(length.sum())
    bits = np.zeros(total + (-total) % 8, np.uint8)
    bits[:lead] = 1
    bits[start + qf] = 1                                     # the unary end
    for i in range(int(k.max(initial=0))):                   # remainder bits
        sel = np.flatnonzero(kf > i)
        one = ((rf[sel] >> (kf[sel] - 1 - i)) & 1) == 1
        bits[start[sel][one] + qf[sel][one] + 1 + i] = 1
    lane_bits = np.full(L + 1, lead, np.int64)
    per_lane = np.zeros(L, np.int64)
    np.add.at(per_lane, np.repeat(np.arange(L), counts.clip(0)), length)
    lane_bits[1:] += np.cumsum(per_lane)
    return {"words": _pack_bits_be(np.packbits(bits).tobytes()),
            "start_bits": lane_bits[:-1].astype(np.int32),
            "params": k.astype(np.int32), "counts": counts.astype(np.int32),
            "values": values}


def rice_calls(seed=77):
    """The garbage cases of ``rice_decode``, beside the JAX test's own
    (``tests/test_ops.py``, seed 77: 24 lanes of 1-39 codes, k in {0, 1,
    4, 8, 14, 30}, quotients up to 200, u32 quotient wrap).

    Calls 0-2 share one shape (W, L and T = 48): the seed-77 lanes and
    the garbage lanes over the guarded buffer; the same lanes over
    all-zero words (every search runs off the buffer, so the JAX loop's
    global iteration count moves each lane); and over the buffer with
    its last quarter zeroed (lanes run off while others find their bit).
    Calls 1 and 2 start their extreme lanes at moderate cursors instead:
    from a cursor near -2^31 over a zero word 0, the JAX loop steps 2^26
    times. Call 3 is the seed-77 lanes alone with ``max_count`` None (T =
    max(counts)), checked against the values that made them too; call 4
    has T = 0 (every count 0 or negative, ``max_count`` None)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 40, 24)
    # A negative cursor reads word 0: one set bit leads the buffer, or
    # the JAX loop would step up from about -2^26.
    st = rice_stream(n, seed, ks=(0, 1, 4, 8, 14, 30), long_share=0,
                     quotients=(0, 1, 2, 7, 40, 200), lead=1)
    words = st["words"]
    W = words.size
    nb = 32 * W
    T = 48
    s0 = st["start_bits"]

    def lanes(extreme):
        lo = [INT32_MIN, INT32_MIN + 7] if extreme else [-4000, -40]
        hi = [INT32_MAX, INT32_MAX - 40] if extreme else [nb + 999,
                                                          nb + 40]
        return {
            "seed 77 partitions": (s0, st["params"], st["counts"]),
            "k of 0, 30, 31, 32, 40 and -1": (
                np.tile(s0[:4], 6), np.repeat([0, 30, 31, 32, 40, -1], 4),
                np.full(24, T)),
            "negative start_bits": (
                [-1, -5, -31, -32, -33, -1000] + lo,
                [3, 0, 14, 1, 30, 4, 2, 31], np.full(8, T)),
            "start_bits past the buffer": (
                [nb, nb + 5, nb + 64, nb - 3] + hi, [2, 0, 9, 4, 31, 1],
                np.full(6, T)),
            "counts of 0 and negative": (
                s0[:6], st["params"][:6], [0, -1, -7, INT32_MIN, 0, -48]),
            "max_count below max(counts)": (
                s0[6:10], st["params"][6:10],
                [T + 1, 1000, INT32_MAX, 10 ** 6]),
        }

    def call(words_, extreme, prefix):
        cases = lanes(extreme)
        labels, at = {}, 0
        for name, (a, _, _) in cases.items():
            labels[prefix + name] = slice(at, at + len(a))
            at += len(a)
        args = [np.concatenate([np.asarray(c[i], np.int64)
                                for c in cases.values()]).astype(np.int32)
                for i in range(3)]
        if prefix:
            labels[prefix + "all lanes"] = slice(0, at)
        return {"args": (words_, *args, T), "labels": labels}

    tail = words.copy()
    tail[3 * W // 4:] = 0
    return [
        call(words, True, ""),
        call(np.zeros_like(words), False, "all-zero words: "),
        call(tail, False, "zero tail: "),
        {"args": (words, s0, st["params"], st["counts"], None),
         "labels": {"seed 77 partitions, max_count None": slice(0, 24)},
         "values": st["values"]},
        {"args": (words, s0[:5], st["params"][:5],
                  np.array([0, -1, 0, INT32_MIN, -3], np.int32), None),
         "labels": {"T of 0": slice(0, 5)}},
    ]


def crc16_rows_calls(seed=12):
    """The cases of ``crc16_device`` in one (L, 300) call: the JAX test's
    (``tests/test_crc.py``, seed 12: 8 rows of bytes, lengths 0..B), then
    lengths negative and above B, and element values outside 0..255."""
    rng = np.random.default_rng(seed)
    B = 300
    data = rng.integers(0, 256, (8, B)).astype(np.int32)
    lengths = rng.integers(0, B + 1, 8).astype(np.int32)
    odd_len = np.array([-1, -300, INT32_MIN, B + 1, 1000, INT32_MAX, B, 0],
                       np.int32)
    odd_val = rng.integers(INT32_MIN, INT32_MAX, (8, B), dtype=np.int64)
    odd_val[:, :3] = [[-1, 256, 511]] * 8
    rows = np.concatenate([data, rng.integers(0, 256, (8, B)),
                           odd_val]).astype(np.int32)
    lens = np.concatenate([lengths, odd_len,
                           rng.integers(0, B + 1, 8)]).astype(np.int32)
    return [{"args": (rows, lens), "labels": {
        "seed 12 rows": slice(0, 8),
        "lengths negative and above B": slice(8, 16),
        "values outside 0..255": slice(16, 24)}}]


def crc16_windows_calls(seed=21):
    """The cases of ``crc16_frames_device`` on one upload of 3000 random
    bytes (the JAX test's, ``tests/test_crc.py``, seed 21) whose bytes
    90-91 hold the CRC-16 of bytes 10-89 big-endian, so the range (10, 92)
    gives 0: the JAX test's ranges, then starts > ends, negative starts,
    ends past 4 S, ranges longer than the window, and int32 extremes.
    Two calls with the same ranges: n_words 1024 and n_words 1."""
    rng = np.random.default_rng(seed)
    raw = bytearray(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
    c = crc16(bytes(raw[10:90]))
    raw[90:92] = bytes([c >> 8, c & 0xFF])
    stream = np.frombuffer(bytes(raw), ">u4").astype(np.int64) \
        .astype(np.int32)
    cases = {
        "seed 21 ranges": [(0, 0), (5, 5), (0, 1), (0, 3000), (1, 2999),
                           (2, 2998), (3, 2997), (7, 512), (13, 526),
                           (100, 101), (2999, 3000)]
        + [tuple(sorted(rng.integers(0, 3001, 2))) for _ in range(20)],
        "a range ending in its stored CRC": [(10, 92)],
        "starts > ends": [(50, 40), (3000, 0), (7, 6), (2998, 2997)],
        "negative starts": [(-5, 3), (-100, 50), (-1, 0), (-4, 4)],
        "ends past 4 S": [(2990, 3100), (10, 5000), (3000, 3010),
                          (2999, 3004), (4000, 4100)],
        "ranges longer than the window": [(-2000, 2500), (0, 4097),
                                          (-5000, 5000)],
        "int32 extremes": [(INT32_MIN, INT32_MIN + 3), (0, INT32_MIN),
                           (INT32_MIN, INT32_MAX), (INT32_MAX - 9,
                                                    INT32_MAX),
                           (INT32_MIN + 2, INT32_MIN + 5)],
    }
    pairs, labels = [], {}
    for name, ranges in cases.items():
        labels[name] = slice(len(pairs), len(pairs) + len(ranges))
        pairs += ranges
    starts = np.array([a for a, _ in pairs], np.int64).astype(np.int32)
    ends = np.array([b for _, b in pairs], np.int64).astype(np.int32)
    return [{"args": (stream, starts, ends, n_words),
             "labels": {f"{k}, n_words {n_words}": v
                        for k, v in labels.items()}}
            for n_words in (1024, 1)]


def rice_edge_calls(seed=78):
    """Cases of ``rice_decode`` at the edges of its kernel's shared-memory
    ring (``csrc/rice.cu``), each held to the plain form.

    Call 0 has the shape of ``rice_calls``' calls 0-2 (W, 72 lanes, T =
    48), so the JAX test compiles nothing new for it: the seed-77 buffer
    with words 600-739 zeroed (a run of 140 words, longer than a lane's
    ring of 128); the seed-77 partitions over it; lanes whose first codes
    run into it; lanes whose cursors start below the buffer and enter it
    mid-partition; lanes that start near its end and leave it; random
    lanes of every k in 0..31 with ragged counts. Call 1: codes of 50-63
    bits (k 28-31), whose cursors outrun the words a ring has landed.
    Call 2: zero runs of 100 and 281 words between short codes, and lanes
    that start inside such a run."""
    rng = np.random.default_rng(seed)
    base = rice_calls()[0]["args"]
    words, s0, k0, c0 = (np.array(a) for a in base[:4])
    s0, k0, c0 = s0[:24], k0[:24], c0[:24]
    W, T = words.size, 48
    words[600:740] = 0
    nb = 32 * W
    z = 600 * 32
    cases = {
        "seed 77 partitions over a zero run": (s0, k0, c0),
        "a zero run longer than the ring": (
            [z - 40, z - 7, z - 1, z, z + 100, z - 27], [0, 3, 14, 31, 1, 30],
            np.full(6, T)),
        "cursors that enter the buffer mid-partition": (
            [-1000, -1500, -600, -700, -400, -900], [30, 31, 14, 31, 20, 31],
            np.full(6, T)),
        "cursors that leave the buffer mid-partition": (
            [nb - 600, nb - 1200, nb - 300, nb - 2000, nb - 100, nb - 40],
            [8, 14, 4, 30, 0, 31], np.full(6, T)),
        "random lanes, k 0..31, ragged counts": (
            rng.integers(0, nb, 30), rng.integers(0, 32, 30),
            rng.integers(0, T + 1, 30)),
    }
    labels, at = {}, 0
    for name, (a, _, _) in cases.items():
        labels[name] = slice(at, at + len(a))
        at += len(a)
    args = [np.concatenate([np.asarray(c[i], np.int64)
                            for c in cases.values()]).astype(np.int32)
            for i in range(3)]
    long = rice_stream(np.full(16, 160), seed, ks=(28, 29, 30, 31),
                       long_share=0, quotients=(20, 25, 31))
    runs = rice_stream(np.full(8, 40), seed + 1, ks=(0, 5, 12),
                       long_share=0, quotients=(0, 1, 3200, 9000))
    inside = runs["start_bits"][:4] + np.array([40, 900, 5000, 12000])
    return [
        {"args": (words, *args, T), "labels": labels},
        {"args": (long["words"], long["start_bits"], long["params"],
                  long["counts"], 160),
         "labels": {"codes of 50-63 bits": slice(0, 16)},
         "values": long["values"]},
        {"args": (runs["words"],
                  np.concatenate([runs["start_bits"], inside]).astype(
                      np.int32),
                  np.concatenate([runs["params"], [0, 5, 12, 31]]).astype(
                      np.int32),
                  np.concatenate([runs["counts"], [40] * 4]).astype(np.int32),
                  40),
         "labels": {"zero runs of 100 and 281 words": slice(0, 8),
                    "cursors inside a zero run": slice(8, 12)},
         "values": runs["values"]},
    ]


def crc16_windows_edge_calls(seed=22):
    """Cases of ``crc16_frames_device`` at the edges of its kernel's word
    skip, loads and items (``csrc/crc_lanes.cu``), each held to the plain
    form.

    Calls 0 and 1 have the shape of ``crc16_windows_calls`` (the seed-21
    upload, 53 ranges; n_words 1024 and 1), so the JAX test compiles
    nothing new for them: ranges whose ends - 4 n_words wraps (ends within
    4 n_words of -2^31), kept suffixes of every length mod 4 at every ends
    mod 4, ranges at the upload's edges, random ranges. Calls 2-5: a
    24,000-byte upload and ranges of up to 16 KB (several 4 KB items at
    n_words 4096) with the same edge ranges, at n_words 1, 2, 1024 and
    4096."""
    rng = np.random.default_rng(seed)
    stream = crc16_windows_calls()[0]["args"][0]
    lo = INT32_MIN
    fixed = {
        "ends - 4 n_words wraps": [
            (lo, lo + 10), (lo + 3, lo + 4095), (lo + 5, lo + 4097),
            (lo + 4090, lo + 4093), (-5, lo + 7), (lo, lo + 1),
            (lo + 1000, lo + 3000), (lo, lo + 2), (lo + 1, lo + 3),
            (INT32_MAX - 3, lo + 2), (lo + 4000, lo + 4095)],
        "kept suffixes of every length mod 4": [
            (e - m, e) for e in (2000, 2001, 2002, 2003)
            for m in (1, 2, 3, 5)],
        "ranges at the upload's edges": [
            (2990, 3000), (2995, 3001), (0, 5), (-3, 4), (2996, 3000),
            (1, 3000), (2999, 3003), (-8, -1)],
    }
    n_fixed = sum(len(v) for v in fixed.values())
    pairs, labels = [], {}
    for name, ranges in fixed.items():
        labels[name] = slice(len(pairs), len(pairs) + len(ranges))
        pairs += ranges
    pad = 53 - n_fixed
    a = rng.integers(-20, 3020, pad)
    pairs += list(zip(a, a + rng.integers(0, 600, pad)))
    labels["random ranges"] = slice(n_fixed, 53)
    starts = np.array([p for p, _ in pairs], np.int64).astype(np.int32)
    ends = np.array([q for _, q in pairs], np.int64).astype(np.int32)
    calls = [{"args": (stream, starts, ends, n_words),
              "labels": {f"{k}, n_words {n_words}": v
                         for k, v in labels.items()}}
             for n_words in (1024, 1)]
    big = rng.integers(INT32_MIN, INT32_MAX, 6000, dtype=np.int64).astype(
        np.int32)
    a = rng.integers(-100, 24100, 60)
    b = a + rng.integers(0, 16385, 60)
    sb = np.concatenate([a, starts[:n_fixed]]).astype(np.int32)
    eb = np.concatenate([b, ends[:n_fixed]]).astype(np.int32)
    for n_words in (1, 2, 1024, 4096):
        calls.append({"args": (big, sb, eb, n_words), "labels": {
            f"ranges of up to 16 KB, n_words {n_words}": slice(0, 60),
            f"the edge ranges on a larger upload, n_words {n_words}":
                slice(60, 60 + n_fixed)}})
    return calls
