"""K5, the port's sync scan (claxon_tpu_torch.ops.segment), in its plain
PyTorch form against the JAX package's ``find_frame_headers`` on the same
stream words. Tolerance 0: positions, validity, the count (which may
exceed the capacity) and every window byte are equal.

Then the fused front (claxon_tpu_torch.ops.seg_parse.demux_front: K6's
bswap, K5, K6's fields and compaction in two kernels): a numpy model of
its kernels against its plain form, and the plain form against the JAX
package on the generated corpus's groups."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from claxon_tpu import native
from claxon_tpu.ops.segment import find_frame_headers as jax_find
from claxon_tpu.testing import encode_flac, synth_music

from claxon_tpu_torch.ops import seg_parse, segment

from front_cases import FRONT_CASES, front_case
from front_cases import payload as _payload, saturated as _saturated

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")


def _words(payload):
    buf = np.frombuffer(bytes(payload), np.uint8)
    pad = np.zeros((-len(buf)) % 4, np.uint8)
    return np.concatenate([buf, pad]).view(">i4").astype(np.int32)


def _assert_same(words, n_bytes, C):
    want = jax_find(jnp.asarray(words), n_bytes, C)
    got = segment.find_frame_headers(torch.from_numpy(words), n_bytes, C)
    for name, a, b in zip(("positions", "valid", "count", "win"), want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), name
        assert np.array_equal(a, b.numpy()), name
    return int(got[2])


@pytest.mark.parametrize("case", ["stream", "stream_overflow", "saturated",
                                  "noise_short_nbytes"])
def test_sync_scan_matches_jax(case):
    if case.startswith("stream"):
        pcm = synth_music(2500, channels=2, bps=16, seed=21)
        payload = _payload(encode_flac(pcm, 44100, 16, block_size=576,
                                       stereo="left_side"))
        C = 3 if case == "stream_overflow" else 64
        count = _assert_same(_words(payload), len(payload), C)
        assert count >= 5
        if case == "stream_overflow":
            assert count > C  # the count reports every hit past C
    elif case == "saturated":
        payload = _saturated(3000, 3)
        count = _assert_same(_words(payload), len(payload), 1024)
        assert count > 500
    else:
        rng = np.random.default_rng(8)
        words = rng.integers(-(1 << 31), 1 << 31, 400, dtype=np.int64) \
            .astype(np.int32)
        words[::5] = np.int32(-0x00070001)  # 0xFFF8FFFF
        # n_bytes below the upload: hits in the tail must not count.
        _assert_same(words, 4 * 400 - 37, 128)


@pytest.mark.parametrize("payload, n_bytes", [
    (b"", 0), (b"\xff", 1), (b"\xff\xf8", 2), (b"\xff\xf8\xff", 3),
    (b"\x00\xff\xf8\x00\xff\xf9", 6)])
def test_sync_scan_empty_and_tiny_streams(payload, n_bytes):
    words = _words(payload) if payload else np.zeros(0, np.int32)
    _assert_same(words, n_bytes, 8)


def test_bswap_plain_matches_numpy():
    rng = np.random.default_rng(9)
    words = rng.integers(-(1 << 31), 1 << 31, 1000, dtype=np.int64) \
        .astype(np.int32)
    got = seg_parse.bswap_words_plain(torch.from_numpy(words)).numpy()
    assert np.array_equal(got, words.byteswap())


# ---- the fused front (seg_parse.demux_front) ---------------------------

_M32 = 0xFFFFFFFF
_BPS = (0, 8, 12, -1, 16, 20, 24, -1)
_MASK0 = (0x7F, 0, 0x1F, 0x0F, 0x07, 0x03, 0x01, 0)


def _lead8(b):
    n = 0
    while n < 8 and (b >> (7 - n)) & 1:
        n += 1
    return n


def _model_valid(w, pos, n_bytes):
    """csrc/header.cuh header_valid, one window."""
    from claxon_tpu_torch.crc import CRC8_TABLE

    bs_code, sr_code, ca, bps_code = (w[2] >> 4, w[2] & 15, w[3] >> 4,
                                      (w[3] >> 1) & 7)
    ok = bs_code != 0 and sr_code != 15 and ca <= 10 and bps_code not in \
        (3, 7) and (w[3] & 1) == 0
    lead = _lead8(w[4])
    ulen = max(lead, 1)
    ok = ok and lead not in (1, 8) and all(
        (w[4 + j] & 0xC0) == 0x80 for j in range(1, min(ulen, 7)))
    hlen = 4 + ulen + {6: 1, 7: 2}.get(bs_code, 0) \
        + {12: 1, 13: 2, 14: 2}.get(sr_code, 0)
    state = 0
    for j in range(hlen):
        state = int(CRC8_TABLE[state ^ w[j]])
    return bool(ok and state == w[min(hlen, 15)] and pos >= 0
                and max(pos, 0) + hlen < n_bytes)


def _model_fields(w, p, valid, ends, si_bps, T, nch):
    """csrc/header.cuh header_fields, one window -> the 9 field ints."""
    bs_code, sr_code, ca, bps_code = (w[2] >> 4, w[2] & 15, w[3] >> 4,
                                      (w[3] >> 1) & 7)
    nch_hdr, mode = (ca + 1, 0) if ca < 8 else (2, ca - 7)
    lead = _lead8(w[4])
    ulen = max(lead, 1)
    lo, hi = w[4] & _MASK0[min(lead, 7)], 0
    for j in range(1, min(ulen, 7)):
        hi = ((hi << 6) | ((lo >> 26) & 0x3F)) & _M32
        lo = ((lo << 6) | (w[4 + j] & 0x3F)) & _M32
    o = 4 + ulen
    b8 = w[min(o, 15)]
    b16 = (b8 << 8) | w[min(o + 1, 15)]
    if bs_code == 1:
        bs = 192
    elif bs_code <= 5:
        bs = 576 << max(bs_code - 2, 0)
    elif bs_code in (6, 7):
        bs = (b8 if bs_code == 6 else b16) + 1
    else:
        bs = 256 << (bs_code - 8)
    ok = valid and not (bs_code == 7 and b16 == 0xFFFF)
    hlen = o + {6: 1, 7: 2}.get(bs_code, 0) \
        + {12: 1, 13: 2, 14: 2}.get(sr_code, 0) + 1
    si = min(int(np.searchsorted(ends, p, side="right")), len(ends) - 1)
    bps = int(si_bps[si]) if bps_code == 0 else _BPS[bps_code]
    walkable = ok and nch_hdr == nch and bps > 0 and 1 <= bs <= T
    s32 = lambda v: v - (1 << 32) if v >> 31 else v
    return [bs, hlen, nch_hdr, mode, w[1] & 1, s32(lo), s32(hi), bps,
            int(walkable)]


def _sync_word(x, nxt):
    """csrc/seg_parse.cu sync_word on uint32 values held in int64."""
    after = ((x << 8) | (nxt >> 24)) & _M32
    return (~x & _M32) | ((after ^ 0xF8F8F8F8) & 0xFEFEFEFE)


def _any_zero_lane(v):
    return ((v - 0x01010101) & _M32) & (~v & _M32) & 0x80808080


def _sync_lanes(v):
    z = ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v | 0x7F7F7F7F) & _M32
    return ((((z >> 7) & 0x01010101) * 0x08040201) & _M32) >> 24


def _front_model(words_le, n_bytes, ends, si_bps, T, nch, C, wcap,
                 threads=256, per_thread=16, slots=128, rank_tiles=32):
    """A numpy model of csrc/seg_parse.cu's two front kernels. The scan
    kernel: tiles of threads * per_thread words, the shared words clamped
    past the upload with their 4-word halo, the word test of the sync hits
    in each thread's consecutive words, which hits are walkable, the block
    scan of the packed (hits << 16 | walkable) counts, each tile's counts
    and its first ``slots`` hits (position, the walkable hits before it in
    the tile, walkable), and every
    row and lane as it stands past the hits. The rank kernel: blocks of
    ``rank_tiles`` tiles, each tile's ranks from the counts before it, the
    rows and lanes of its hits of rank below C from its slots (windows
    read back from the stream), or by scanning a tile of more hits again,
    and the counts from the last block. Every output starts as a marker
    that no write leaves."""
    W = len(words_le)
    be = np.asarray(words_le).astype(np.int64) & _M32
    be = ((be & 0xFF) << 24) | ((be & 0xFF00) << 8) | ((be >> 8) & 0xFF00) \
        | (be >> 24)
    tile = threads * per_thread
    mark = 0x5A5A5A5A
    positions = np.full(C, mark, np.int64)
    valid = np.full(C, 7, np.int64)
    win = np.full((C, 16), mark, np.int64)
    fields = np.full((C, 9), mark, np.int64)
    lane_of = np.full(C, mark, np.int64)
    walk_in = np.full((4, wcap), mark, np.int64)
    counts = [mark, mark]
    n_tiles = -(-W // tile)

    def scan_tile(k):
        """The tile's hits per thread, as (pos, walkable, window)."""
        b0 = k * tile
        sw = be[np.minimum(b0 + np.arange(tile + 4), W - 1)]
        byt = ((sw[:, None] >> np.array([24, 16, 8, 0])) & 255).reshape(-1)
        # The kernel's word test (sync_word, any_zero_lane, sync_lanes),
        # then its bound: below n_bytes - 2 and the upload's last byte.
        v = _sync_word(sw[:tile], sw[1:tile + 1])
        lanes = np.where(_any_zero_lane(v) != 0, _sync_lanes(v), 0)
        hit = ((lanes[:, None] >> np.arange(4)) & 1).reshape(-1) != 0
        hit &= 4 * b0 + np.arange(4 * tile) < min(n_bytes - 2, 4 * W - 1)
        per_t = []
        for t in range(threads):
            lo_b = 4 * per_thread * t
            h = []
            for q in np.nonzero(hit[lo_b:lo_b + 4 * per_thread])[0] + lo_b:
                w = [int(x) for x in byt[q:q + 16]]
                pos = 4 * b0 + int(q)
                f = _model_fields(w, pos, _model_valid(w, pos, n_bytes),
                                  ends, si_bps, T, nch)
                h.append((pos, f[8], w))
            per_t.append(h)
        packed = np.array([(len(h) << 16) | sum(x[1] for x in h)
                           for h in per_t], np.int64)
        assert packed.sum() >> 16 < 1 << 16  # the scan's 16-bit fields
        return per_t

    def write_row(rank, lane, pos, w):
        ok = _model_valid(w, pos, n_bytes)
        f = _model_fields(w, pos, ok, ends, si_bps, T, nch)
        positions[rank], valid[rank] = pos, ok
        win[rank], fields[rank] = w, f
        walked = f[8] and lane < wcap
        lane_of[rank] = lane if walked else -1
        if walked:
            walk_in[:, lane] = ((pos + f[1]) * 8, f[0], f[3], f[7])
        if rank == C - 1:
            counts[1] = lane + f[8]
        return f[8]

    # The scan kernel.
    agg, kept = [], []
    for k in range(n_tiles):
        hits = [x for h in scan_tile(k) for x in h]
        agg.append((len(hits), sum(x[1] for x in hits)))
        before = np.concatenate([[0], np.cumsum([x[1] for x in hits])])
        kept.append([(pos, int(before[i]), wk)
                     for i, (pos, wk, _w) in enumerate(hits[:slots])])
    w0 = [0] * 16 if W == 0 or n_bytes < 2 else [
        int(be[min(j >> 2, W - 1)] >> (24 - 8 * (j & 3))) & 255
        for j in range(16)]
    positions[:], valid[:], lane_of[:] = -1, 0, -1
    win[:] = w0
    fields[:] = _model_fields(w0, 0, False, ends, si_bps, T, nch)
    walk_in[:] = np.array([[0], [0], [0], [1]])
    # The rank kernel.
    n_blocks = max(1, -(-n_tiles // rank_tiles))
    for blk in range(n_blocks):
        first = blk * rank_tiles
        g = agg[first:first + rank_tiles] + [(0, 0)] * rank_tiles
        g = g[:rank_tiles]
        base = (sum(x[0] for x in agg[:first]),
                sum(x[1] for x in agg[:first]))
        ex_h = base[0] + np.concatenate([[0], np.cumsum([x[0] for x in g])])
        ex_w = base[1] + np.concatenate([[0], np.cumsum([x[1] for x in g])])
        if blk == n_blocks - 1:
            counts[0] = int(ex_h[rank_tiles])
            if counts[0] < C:
                counts[1] = int(ex_w[rank_tiles])
        for t in range(rank_tiles):
            k = first + t
            rank, lane = int(ex_h[t]), int(ex_w[t])
            if k >= n_tiles or not g[t][0] or rank >= C:
                continue
            if g[t][0] <= slots:  # each hit on its own thread
                for i, (pos, before, wk) in enumerate(kept[k]):
                    if rank + i >= C:
                        break
                    q = np.minimum((pos >> 2) + np.arange(5), W - 1)
                    byt = ((be[q][:, None] >> np.array([24, 16, 8, 0]))
                           & 255).reshape(-1)
                    w = [int(x) for x in byt[pos & 3:(pos & 3) + 16]]
                    assert write_row(rank + i, lane + before, pos, w) == wk
            else:  # scanned again, the whole block on this tile
                for pos, wk, w in [x for h in scan_tile(k) for x in h]:
                    if rank >= C:
                        break
                    write_row(rank, lane, pos, w)
                    rank, lane = rank + 1, lane + wk
    out = (be, positions, valid, counts[0], win, fields, lane_of,
           tuple(walk_in), counts)
    for a in (positions, win, fields, lane_of, walk_in, np.array(counts)):
        assert not (a == mark).any()
    assert not (valid == 7).any()
    return out


def _assert_front_equal(got, want):
    names = ("stream", "positions", "valid", "count", "win", "fields",
             "lane_of", "walk_in", "counts")
    for name, g, w in zip(names, got, want):
        if name == "walk_in":
            for a, b in zip(g, w):
                assert np.array_equal(np.asarray(a), b.numpy()), name
        elif name == "stream":
            assert np.array_equal(np.asarray(g).astype(np.int64) & _M32,
                                  w.numpy().astype(np.int64) & _M32), name
        else:
            want_a = w.numpy().astype(np.int64)
            assert np.array_equal(np.asarray(g, np.int64), want_a), name


@pytest.mark.parametrize("case", FRONT_CASES)
def test_front_model_matches_plain(case):
    """The numpy model of the fused front's kernels equals demux_front's
    plain form (K5 and K6's plain forms, held to the JAX package by the
    tests above and test_torch_seg_pipeline.py) on every output, at the
    kernels' shape (256 threads of 16 words, 128 slots a tile, 32 tiles a
    rank block) and at a tile of 16 words (4 threads of 4, 2 slots, 3
    tiles a rank block), whose many boundaries
    move every hit and window across tiles and whose tiles overflow their
    slots: real frame groups with C and wcap cutting them, header
    copies and sync pairs at every offset around tile boundaries, dense
    FF F8 runs whose count passes C mid-tile, more streams than the
    kernels keep in shared memory, W below 4, n_bytes below 4 W and
    uploads that end inside a tile."""
    words, n_bytes, ends, si_bps, T, nch, C, wcap = front_case(case)
    want = seg_parse.demux_front(
        torch.from_numpy(words), n_bytes, torch.from_numpy(ends),
        torch.from_numpy(si_bps), T, nch, C, wcap)
    for threads, per_thread, slots, rank_tiles in ((256, 16, 128, 32),
                                                   (4, 4, 2, 3)):
        got = _front_model(words, n_bytes, ends, si_bps, T, nch, C, wcap,
                           threads, per_thread, slots, rank_tiles)
        _assert_front_equal(got, want)
    count = int(want[3])
    if case in ("dense", "dense_cut_mid_tile"):
        assert count > C
    if case.startswith("real"):
        assert int(want[8][1]) >= min(C, 10) and count >= 10
    if case.startswith("mimics"):
        assert int(want[8][1]) >= 2


def _generated_groups():
    """begin_segmented's group uploads of testsamples/generated (the
    arguments it hands the fused demux), without running the demux."""
    import pathlib

    import claxon_tpu_torch.pipeline_seg as tseg

    root = pathlib.Path(__file__).resolve().parents[1]
    datas = [p.read_bytes()
             for p in sorted((root / "testsamples" / "generated")
                             .glob("*.flac"))]
    calls = []
    real = seg_parse.fused_demux_async
    seg_parse.fused_demux_async = lambda *a, **kw: calls.append(a)
    try:
        tseg.begin_segmented(datas, device="cpu")
    finally:
        seg_parse.fused_demux_async = real
    return calls


def test_front_matches_jax_on_generated_groups():
    """demux_front's plain form on every group of the generated corpus,
    held to the JAX package: the stream to the JAX program's bswap, the
    sync scan to its find_frame_headers, and the fields, lanes and walk
    inputs of the valid candidates to its host twin of the device field
    parse (pipeline_seg.host_header_fields) with the stream's bits per
    sample; the numpy model of the kernel equals it on every output."""
    from claxon_tpu.pipeline_seg import host_header_fields

    groups = _generated_groups()
    assert len(groups) >= 3
    for words_le, n_bytes, T, nch, ends_abs, bps, frames_est in groups:
        S = -(-len(ends_abs) // seg_parse.S_QUANTUM) * seg_parse.S_QUANTUM
        ends = np.full(S, n_bytes, np.int32)
        ends[:len(ends_abs)] = ends_abs
        si_bps = np.ones(S, np.int32)
        si_bps[:len(bps)] = bps
        cap = seg_parse.pick_cap(n_bytes, frames_est)
        wcap = seg_parse.pick_wcap(n_bytes, frames_est)
        got = seg_parse.demux_front(words_le, n_bytes, torch.from_numpy(ends),
                                    torch.from_numpy(si_bps), T, nch, cap,
                                    wcap)
        stream, pos, valid, count, win, fields, lane_of, walk_in, counts = \
            (a.numpy() if isinstance(a, torch.Tensor) else a for a in got)
        w = jnp.asarray(words_le.numpy())
        j_stream = (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
                    | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))
        assert np.array_equal(np.asarray(j_stream), stream)
        for a, b in zip(jax_find(j_stream, n_bytes, cap),
                        (pos, valid, count, win)):
            assert np.array_equal(np.asarray(a), b)
        assert 0 < count <= cap and int(counts[0]) == count
        rows = np.nonzero(valid)[0]
        buf = stream.astype(">i4").view(np.uint8)
        h = host_header_fields(buf, pos[rows])
        assert h["ok"].all()
        table = np.array([0, 8, 12, -1, 16, 20, 24, -1])
        si = np.minimum(np.searchsorted(ends, pos[rows], side="right"), S - 1)
        h_bps = np.where(h["bps_code"] == 0, si_bps[si],
                         table[h["bps_code"]])
        f = fields[rows].astype(np.int64)
        time_raw = (f[:, 5] & 0xFFFFFFFF) | ((f[:, 6] & 0xF) << 32)
        for col, want in (("block_size", h["block_size"]),
                          ("hlen", h["hlen"]), ("nch_hdr", h["nch"]),
                          ("mode", h["mode"]), ("variable", h["variable"]),
                          ("bps", h_bps)):
            assert np.array_equal(f[:, seg_parse.FIELDS.index(col)], want)
        assert np.array_equal(time_raw, h["time_raw"])
        walkable = (h["nch"] == nch) & (h_bps > 0) & (h["block_size"] >= 1) \
            & (h["block_size"] <= T)
        assert np.array_equal(fields[:, 8] != 0,
                              np.isin(np.arange(cap), rows[walkable]))
        lanes = rows[walkable][:wcap]
        assert np.array_equal(lane_of[lanes], np.arange(len(lanes)))
        assert (np.delete(lane_of, lanes) == -1).all()
        assert int(counts[1]) == walkable.sum() >= 1
        for a, want in zip(walk_in, ((pos[lanes] + fields[lanes, 1]) * 8,
                                     fields[lanes, 0], fields[lanes, 3],
                                     fields[lanes, 7])):
            assert np.array_equal(a[:len(lanes)], want)
        _assert_front_equal(_front_model(words_le.numpy(), n_bytes, ends,
                                         si_bps, T, nch, cap, wcap),
                            tuple(got))
