"""The port's segmented path (claxon_tpu_torch.pipeline_seg, device="cpu",
so every kernel takes its plain form) against the JAX package's fused
demux and segmented decode, the port's host-walk path and the C++ scalar
decoder. Tolerance 0 throughout.

The JAX comparisons share one stream group, so the JAX fused program
compiles once for the file.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import claxon_tpu.pipeline_seg as jseg
from claxon_tpu import native
from claxon_tpu.ops.seg_parse import fused_demux as jax_fused_demux
from claxon_tpu.testing import encode_flac, synth_music

import claxon_tpu_torch as ct
import claxon_tpu_torch.ops.seg_parse as tsp
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch.error import Error, FormatError

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")


@pytest.fixture(autouse=True)
def _clear_port_reject_cache():
    """The port learns rejecting streams per process, like the JAX
    package; keep the tests independent of their order."""
    tseg._REJECT_CACHE.clear()
    yield
    tseg._REJECT_CACHE.clear()


def _enc(n, seed, channels=2, bps=16, block_size=1024, **kw):
    return encode_flac(synth_music(n, channels=channels, bps=bps, seed=seed),
                       44100, bps, block_size=block_size, **kw)


def _group_batch():
    """One stereo group of three streams: plain LPC, left/side with
    partition order 3 at block size 576 (merged into the 1024 group), and
    a 24-bit stream whose long codes the walk rejects."""
    return [_enc(3000, 1), _enc(2500, 2, block_size=576, stereo="left_side",
                                partition_order=3),
            _enc(2000, 3, bps=24)]


def _seg(datas, **kw):
    return ct.decode_streams_device(datas, segmentation="device",
                                    device="cpu", **kw)


def _assert_oracle(datas, results):
    assert len(results) == len(datas)
    for data, dec in zip(datas, results):
        assert np.array_equal(dec.pcm, native.decode_stream_scalar(data)[1])


def _assert_like_host(datas, dd):
    """The segmented results equal the host-walk path's and the scalar
    decoder's, frame times and sizes included."""
    got = dd.to_host()
    want = ct.decode_streams_device(datas, device="cpu").to_host()
    for g, w in zip(got, want):
        assert np.array_equal(g.pcm, w.pcm)
        assert g.frame_times == w.frame_times
        assert g.frame_sizes == w.frame_sizes
        assert g.streaminfo == w.streaminfo
    _assert_oracle(datas, got)
    return got


def test_fused_demux_matches_jax():
    """One group through the port's fused demux and the JAX package's:
    the count, and the pos, valid and walk_ok columns of every summary
    row, are equal; the other columns are equal on chainable rows, and
    the walk arrays on their lanes."""
    pending = tseg.begin_segmented(_group_batch(), device="cpu")
    [(T, nch, g_streams, _off, ends_abs, _sizes, pend)] = pending.groups
    assert (T, nch, g_streams) == (1024, 2, [0, 1, 2])
    words_le, n_bytes = pend._key[:2]
    bps = [16, 16, 24]
    frames_est = sum(-(-pending.sis[i].samples
                       // pending.sis[i].min_block_size) + 2
                     for i in g_streams)
    j_stream, j_walk, j_summary, j_count = jax_fused_demux(
        jnp.asarray(words_le.numpy()), n_bytes, T, nch, ends_abs, bps,
        frames_est)
    t_stream, t_walk, t_summary, t_count = tsp.fused_demux(
        words_le, n_bytes, T, nch, ends_abs, bps, frames_est)
    assert j_count == t_count >= 10  # every real frame is a candidate
    assert np.array_equal(np.asarray(j_stream), t_stream.numpy())
    cols = {c: i for i, c in enumerate(tsp.SUMMARY_COLS)}
    for c in ("pos", "valid", "walk_ok"):
        assert np.array_equal(j_summary[:, cols[c]], t_summary[:, cols[c]])
    chainable = (t_summary[:, cols["valid"]] != 0) \
        & (t_summary[:, cols["walk_ok"]] != 0)
    assert chainable.sum() >= 8
    assert np.array_equal(j_summary[chainable], t_summary[chainable])
    # Walk lanes of chainable candidates (walk row = rank * nch + ch).
    rank = np.cumsum(t_summary[:, cols["valid"]] != 0) - 1
    rows = (rank[chainable][:, None] * nch + np.arange(nch)).reshape(-1)
    for key, arr in zip(jseg._WALK_KEYS, j_walk):
        if key in t_walk:
            assert np.array_equal(np.asarray(arr)[rows],
                                  t_walk[key].numpy()[rows]), key


def test_slice_matches_jax():
    """The whole slice against the JAX package's segmented decode: the
    same PCM, frame times and sizes, the same fallback streams, and to
    host through the same int16 transfer (the 16-bit dispatches pack, the
    host-walked 24-bit stream's bucket does not)."""
    datas = _group_batch()
    ref_dd = jseg.decode_streams_segmented(datas)
    ref = ref_dd.to_host()
    dd = tseg.decode_streams_segmented(datas, device="cpu")
    got = dd.to_host()
    packed = [d.packed for d in dd.dispatches]
    assert packed == [d.packed for d in ref_dd.dispatches]
    assert packed == [True] * (len(packed) - 1) + [False]
    for d in dd.dispatches:
        assert (d.words is not None and int(d.flag) == 0) if d.packed \
            else d.host is not None
    assert dd.fallback_streams == ref_dd.fallback_streams == [2]
    assert dd.segmented and ref_dd.segmented and dd.seg_engaged
    for g, r in zip(got, ref):
        assert np.array_equal(g.pcm, r.pcm)
        assert g.frame_times == r.frame_times
        assert g.frame_sizes == r.frame_sizes
    _assert_oracle(datas, got)


def test_entry_points_agree(monkeypatch):
    """decode_streams_device(segmentation="device"), decode_streams_
    segmented, begin/finish, the async handle and segmentation="auto"
    with "device" chosen give the same result."""
    import claxon_tpu_torch.pipeline as tp

    datas = [_enc(2200, 4), _enc(1500, 5, channels=1, block_size=576)]
    want = [native.decode_stream_scalar(d)[1] for d in datas]
    pend = tseg.begin_segmented(datas, device="cpu")
    assert len(pend.groups) == 2  # stereo and mono
    runs = [_seg(datas), tseg.decode_streams_segmented(datas, device="cpu"),
            tseg.finish_segmented(pend)]
    handle = ct.decode_streams_device_async(datas, segmentation="device",
                                            device="cpu")
    runs.append(handle.finish())
    assert handle.finish() is runs[-1]
    monkeypatch.setitem(tp._seg_auto("cpu"), "choice", "device")
    runs.append(ct.decode_streams_device(datas, segmentation="auto",
                                         device="cpu"))
    for dd in runs:
        assert dd.segmented and dd.fallback_streams == []
        assert dd.upload_bytes > sum(len(d) for d in datas) // 2
        for dec, w in zip(dd.to_host(), want):
            assert np.array_equal(dec.pcm, w)


def test_async_overlapped_batches_keep_order():
    """Batch n+1 begins before batch n finishes; results stay in order."""
    batches = [[_enc(1800 + 300 * b + 77 * k, 10 * b + k) for k in range(2)]
               for b in range(2)]
    handles = [ct.decode_streams_device_async(b, segmentation="device",
                                              device="cpu")
               for b in batches]
    for b, h in zip(batches, handles):
        _assert_oracle(b, h.finish().to_host())


def _zeroed_group_words(payloads):
    """The group buffer as a fresh ``np.zeros`` builds it: each payload
    at its word-aligned offset, zeros everywhere else; and its offsets."""
    from claxon_tpu_torch.pipeline_bits import _pad_stream_words

    wcs = [(p.nbytes + 3) // 4 for p in payloads]
    buf = np.zeros(_pad_stream_words(sum(wcs)) * 4, np.uint8)
    offs, off = [], 0
    for p, wc in zip(payloads, wcs):
        buf[off:off + p.nbytes] = p
        offs.append(off)
        off += wc * 4
    return buf, offs


@pytest.mark.parametrize("n_streams", [1, 4])
@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_fill_group_words_matches_a_zeroed_buffer(rem, n_streams):
    """``_fill_group_words`` into a buffer that holds other bytes (0xFF,
    then a longer group's) gives the fresh ``np.zeros`` build byte for
    byte, alignment bytes and pad included, and writes nothing past the
    group's words. Payload lengths are ``rem`` mod 4."""
    rng = np.random.default_rng(10 * rem + n_streams)
    dst = np.full(1 << 18, 0xFF, np.uint8)
    for n in (5000, 700):  # a long group, then a shorter one
        payloads = [rng.integers(0, 256, 4 * (n + 37 * k) + rem, np.uint8)
                    for k in range(n_streams)]
        want, offs = _zeroed_group_words(payloads)
        before = dst.copy()
        sizes = [p.nbytes for p in payloads]
        byte_off = tseg._fill_group_words(
            dst, payloads, sizes, [(s + 3) // 4 for s in sizes],
            want.nbytes // 4)
        assert byte_off.tolist() == offs
        assert np.array_equal(dst[:want.nbytes], want)
        assert np.array_equal(dst[want.nbytes:], before[want.nbytes:])
        assert (dst[want.nbytes:] != 0).any()


def test_two_pending_batches_match_jax(monkeypatch):
    """Two batches begun before either finishes: the first one's uploaded
    words are still its own (the CPU takes a fresh buffer per group, as
    the upload there is the buffer itself), and each batch decodes as the
    JAX package's segmented decode does. The second batch holds the
    first's streams in another order, so its group words differ but the
    JAX program is the one ``test_slice_matches_jax`` compiled."""
    from claxon_tpu_torch.native.binding import _read_metadata

    monkeypatch.setattr(jseg, "_REJECT_CACHE", set())
    a = _group_batch()
    order = [1, 0, 2]
    b = [a[i] for i in order]
    pa = tseg.begin_segmented(a, device="cpu")
    pb = tseg.begin_segmented(b, device="cpu")
    for datas, pend in ((a, pa), (b, pb)):
        [(_T, _nch, g_streams, _off, _ends, _sizes, group)] = pend.groups
        want, _offs = _zeroed_group_words(
            [np.frombuffer(datas[i], np.uint8)[_read_metadata(datas[i])[1]:]
             for i in g_streams])
        assert np.array_equal(group._key[0].numpy().view(np.uint8), want)
    dd_b = tseg.finish_segmented(pb)
    dd_a = tseg.finish_segmented(pa)
    ref = jseg.decode_streams_segmented(a).to_host()
    for datas, dd, want in ((a, dd_a, ref),
                            (b, dd_b, [ref[i] for i in order])):
        got = dd.to_host()
        assert dd.fallback_streams == [2]
        for g, r in zip(got, want):
            assert np.array_equal(g.pcm, r.pcm)
            assert g.frame_times == r.frame_times
            assert g.frame_sizes == r.frame_sizes
        _assert_oracle(datas, got)


def test_more_than_two_channels_fall_back_alone():
    datas = [_enc(1500, 40), _enc(1200, 44, channels=3), _enc(1500, 41)]
    dd = _seg(datas)
    assert dd.segmented and dd.fallback_streams == [1]
    _assert_like_host(datas, dd)


def test_partition_order_7_falls_back_and_is_remembered():
    """128 partitions exceed the walk's cap of 64: the stream host-walks
    alone, and a repeated decode pre-routes it (the reject cache), with
    fewer bytes uploaded and the same result."""
    good = _enc(2000, 315)
    # Large enough that the group upload without it is a smaller class.
    odd = _enc(6144, 314, partition_order=7, max_lpc_order=4)
    dd1 = _seg([good, odd])
    assert dd1.fallback_streams == [1]
    r1 = _assert_like_host([good, odd], dd1)
    pend = tseg.begin_segmented([good, odd], device="cpu")
    assert pend.pre_fallback == [1]
    dd2 = tseg.finish_segmented(pend)
    assert dd2.fallback_streams == [1]
    for a, b in zip(r1, dd2.to_host()):
        assert np.array_equal(a.pcm, b.pcm)
    assert dd2.upload_bytes < dd1.upload_bytes


def test_header_mimic_in_verbatim_payload():
    """Verbatim samples that spell a valid frame header (sync, fields and
    CRC-8) lose the chain race: nothing falls back or changes."""
    from claxon_tpu.crc import CRC8_TABLE

    hdr = bytearray([0xFF, 0xF8, 0x99, 0x18, 0x00])
    crc = 0
    for b in hdr:
        crc = CRC8_TABLE[crc ^ b]
    hdr.append(crc)
    vals = np.frombuffer(bytes(hdr), ">i2").astype(np.int32)
    pcm = synth_music(2000, channels=2, bps=16, seed=6)
    pcm[100:100 + len(vals), 0] = vals
    data = encode_flac(pcm, 44100, 16, block_size=1024,
                       force_subframe="verbatim", stereo="independent")
    assert bytes(hdr) in data
    dd = _seg([data])
    assert dd.fallback_streams == []
    _assert_like_host([data], dd)


def test_crc_mismatch_raises_and_latches():
    data = bytearray(_enc(2000, 7))
    data[-1] ^= 0xFF  # a CRC-16 byte of the last frame
    dd = _seg([bytes(data)])
    assert dd.fallback_streams == []  # K4 on the segmented path finds it
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.sync()


def test_truncated_stream_raises_the_host_error():
    data = _enc(2000, 7)[:-7]
    with pytest.raises(Error) as host:
        ct.decode_streams_device([data], device="cpu").to_host()
    with pytest.raises(Error) as seg:
        _seg([_enc(1500, 8), data]).to_host()
    assert type(seg.value).__name__ == type(host.value).__name__
    assert str(seg.value) == str(host.value)


def test_empty_stream():
    data = encode_flac(np.zeros((0, 1), np.int32), 44100, 16)
    dd = _seg([data, _enc(1200, 9)])
    out = dd.to_host()
    assert out[0].pcm.shape[0] == 0 and dd.fallback_streams == []
    _assert_oracle([data], out[:1])


def test_capacity_overflow_regrows(monkeypatch):
    """Capacities below the candidate count re-dispatch with larger
    classes and stay bit-exact."""
    data = _enc(6000, 11, block_size=576)
    grown = []
    monkeypatch.setattr(tsp, "pick_cap", lambda *a: 8)
    monkeypatch.setattr(tsp, "pick_wcap", lambda *a: 8)
    dispatch = tsp.PendingDemux._dispatch

    def spying(self, cap, wcap):
        grown.append((cap, wcap))
        return dispatch(self, cap, wcap)

    monkeypatch.setattr(tsp.PendingDemux, "_dispatch", spying)
    dd = _seg([data])
    assert dd.segmented and dd.fallback_streams == []
    _assert_like_host([data], dd)
    assert grown[0] == (8, 8) and len(grown) >= 2
    assert grown[-1][0] > 8 and grown[-1][1] > 8


def test_demux_overflow_falls_back_as_a_group(monkeypatch):
    """Past MAX_CAP the group host-walks; other groups stay on the card."""
    monkeypatch.setattr(tsp, "MAX_CAP", 4)
    monkeypatch.setattr(tsp, "pick_cap", lambda *a: 4)
    monkeypatch.setattr(tsp, "pick_wcap", lambda *a: 4)
    stereo = [_enc(5000, 12, block_size=576), _enc(1000, 13)]
    mono = _enc(2000, 14, channels=1)
    dd = _seg(stereo + [mono])
    assert dd.fallback_streams == [0, 1] and dd.segmented
    _assert_like_host(stereo + [mono], dd)


def test_seg_debug_prints_stage_cpu_ms(monkeypatch, capsys):
    """``CLAXON_TPU_SEG_DEBUG`` set: the batch keeps (label, host-CPU
    time) marks from its start and ``finish_segmented`` prints each
    stage's milliseconds, as the JAX package does, over the stages that
    ``stage_seconds`` times; unset, nothing is kept or printed."""
    import ast

    datas = [_enc(1500, 60)]
    monkeypatch.setenv("CLAXON_TPU_SEG_DEBUG", "1")
    pend = tseg.begin_segmented(datas, device="cpu")
    assert pend.stages.marks[0][0] == "start"
    dd = tseg.finish_segmented(pend)
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("seg stage CPU ms: ")]
    stages = ast.literal_eval(line[len("seg stage CPU ms: "):])
    assert [b for b, _ms in stages] == [b for b, _t in
                                         pend.stages.marks[1:]]
    assert set(b for b, _ms in stages) == set(dd.stage_seconds)
    assert all(ms >= 0 for _b, ms in stages)
    monkeypatch.delenv("CLAXON_TPU_SEG_DEBUG")
    pend = tseg.begin_segmented(datas, device="cpu")
    assert pend.stages.marks is None
    _assert_oracle(datas, tseg.finish_segmented(pend).to_host())
    assert "seg stage" not in capsys.readouterr().out


def test_group_merge_one_upload():
    # Two frames or more each: the test encoder records a one-frame
    # stream's block size in STREAMINFO as 16.
    datas = [_enc(2500, 50, block_size=576), _enc(2500, 51),
             _enc(2500, 52, block_size=2048)]
    pend = tseg.begin_segmented(datas, device="cpu")
    assert [g[:2] for g in pend.groups] == [(2048, 2)]
    dd = tseg.finish_segmented(pend)
    assert dd.fallback_streams == []
    _assert_like_host(datas, dd)


@pytest.mark.parametrize("name", ["find_frame_headers", "pack_summary",
                                  "walk_frames", "gather_values",
                                  "demux_front"])
def test_wrappers_refuse_non_cpu_tensors(name):
    """Given tensors that are not on the CPU, each K5-K8 wrapper launches
    its kernel or raises; it never falls back to its plain form."""
    from claxon_tpu_torch.ops import demux, seg_gather, segment

    meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype,
                                                     device="meta")
    calls = {
        "find_frame_headers": (segment.find_frame_headers,
                               (meta(64), 256, 8)),
        "pack_summary": (tsp.pack_summary,
                         (meta(8), meta(8, 9), meta(8), meta(4),
                          meta(4, dtype=torch.bool), meta(8), meta(8), 2)),
        "walk_frames": (demux.walk_frames,
                        (meta(64), meta(4), meta(4), meta(4), meta(4), 1024,
                         2)),
        "gather_values": (seg_gather.gather_values,
                          (meta(4, 64), meta(4, 32), meta(4), meta(8), 64)),
        "demux_front": (tsp.demux_front,
                        (meta(64), 256, meta(8), meta(8), 1024, 2, 8, 8)),
    }
    fn, args = calls[name]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("mode", ["values", "delta", "scan"])
def test_seg_entropy_modes_match(monkeypatch, mode):
    """CLAXON_TPU_SEG_ENTROPY: the walk's values (K8), the delta decode
    from the walk's deltas (K10) and the in-chunk scan from its chunk
    bases (K2) give the scalar decoder's PCM on the inputs of
    tests/test_seg_pipeline.py::test_seg_entropy_modes_match, and the
    same dispatches; values mode is held to the JAX package by
    test_slice_matches_jax. K7 emits its deltas in delta mode only."""
    from claxon_tpu_torch.ops import entropy, seg_gather

    datas = []
    for seed, (bs, ch) in enumerate([(4096, 2), (576, 1)]):
        pcm = synth_music(4000 + 619 * seed, channels=ch, bps=16, seed=seed)
        datas.append(encode_flac(pcm, 44100, 16, block_size=bs,
                                 partition_order=3))
    # Two frames or more, so that the stream rides the device demux.
    datas.append(_enc(2500, 21, partition_order=3))
    calls = {}
    for mod, name in ((entropy, "decode_residual_bits_stream_delta"),
                      (entropy, "decode_residual_bits_stream"),
                      (seg_gather, "gather_values")):
        fn = getattr(mod, name)
        calls[name] = []
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            calls[_n].append(1) or _f(*a, **kw))
    monkeypatch.setenv("CLAXON_TPU_SEG_ENTROPY", mode)
    pend = tseg.begin_segmented(datas, device="cpu")
    assert pend.mode == mode
    assert all(("deltas" in g[-1].walk) == (mode == "delta")
               for g in pend.groups)
    dd = tseg.finish_segmented(pend)
    assert dd.segmented and dd.fallback_streams == [0]
    want = {"values": "gather_values",
            "delta": "decode_residual_bits_stream_delta",
            "scan": "decode_residual_bits_stream"}[mode]
    assert len(calls[want]) == len(dd.dispatches) - 1  # one host-walked
    got = dd.to_host()
    _assert_oracle(datas, got)
    if mode == "values":
        return
    monkeypatch.setenv("CLAXON_TPU_SEG_ENTROPY", "values")
    for a, b in zip(got, _seg(datas).to_host()):
        assert np.array_equal(a.pcm, b.pcm)
        assert a.frame_times == b.frame_times
