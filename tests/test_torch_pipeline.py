"""The port's decode path (claxon_tpu_torch.pipeline, device="cpu")
against the JAX package and the C++ scalar decoder: byte-identical
bucket uploads from the two planners, bit-identical PCM, and the same
errors with the same wording. Tolerance 0 throughout."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import claxon_tpu.pipeline as jpipe
import claxon_tpu.pipeline_bits as jpb
from claxon_tpu import native
from claxon_tpu.error import Error as RefError
from claxon_tpu.testing import encode_flac, synth_music

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline_bits as tpb
from claxon_tpu_torch.error import Error, FormatError
from claxon_tpu_torch.pipeline import extract_streams_bits
from util import pcm_md5

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

GENERATED = pathlib.Path(__file__).resolve().parents[1] / "testsamples" / \
    "generated"


def _generated():
    return [p.read_bytes() for p in sorted(GENERATED.glob("*.flac"))]


def _configs():
    """A few encoder configs beyond the committed corpus: a high partition
    order, a block size that is not a multiple of 32, verbatim frames."""
    pcm = synth_music(5000, channels=2, bps=16, seed=31)
    return [encode_flac(pcm, 44100, 16, block_size=1152, partition_order=5),
            encode_flac(pcm, 44100, 16, block_size=1000),
            encode_flac(pcm[:2500], 44100, 16, force_subframe="verbatim",
                        block_size=1152)]


def _fallback_stream():
    """Partition order 7 exceeds the device decoder's cap of 64
    partitions: the walker decodes these frames on the host."""
    pcm = synth_music(16384, channels=2, bps=16, seed=44)
    return encode_flac(pcm, 44100, 16, block_size=16384, max_lpc_order=4,
                       partition_order=7)


def _capture_jax_uploads(monkeypatch, datas, lane_quantum, mode="stream",
                         mesh=None):
    """Run the JAX package's planner on ``datas`` in entropy ``mode`` (over
    a JAX ``mesh`` when one is given) and capture the arrays its device
    programs receive, without compiling or running them."""
    monkeypatch.setenv("CLAXON_TPU_ENTROPY", mode)
    monkeypatch.delenv("CLAXON_TPU_HOST_CRC", raising=False)
    got = {"bits": [], "samples": [], "crc": []}

    def result(out_packed, L, T):
        out = np.zeros((L, T), np.int32)
        return (out, np.zeros((), np.int32), (out,)) if out_packed \
            else (out, (out,))

    def stream_program(P, SA, NC, out_packed, **_kw):
        def run(stream, mb):
            got["bits"].append((P, SA, NC, np.asarray(stream),
                                np.asarray(mb), out_packed))
            return result(out_packed, mb.shape[0], NC * 32)
        return run

    def bits_program(P, SA, out_packed, **_kw):
        def run(slots, deltas, ks, meta):
            got["bits"].append((P, SA, np.asarray(slots),
                                np.asarray(deltas), np.asarray(ks),
                                np.asarray(meta), out_packed))
            return result(out_packed, meta.shape[0], deltas.shape[1])
        return run

    def decode_program(in_packed, out_packed, chunked=True):
        def run(x, *rest):
            x = np.asarray(x)  # int16 pairs when in_packed
            got["samples"].append((x,) + tuple(np.asarray(a) for a in rest)
                                  + (in_packed, out_packed))
            return result(out_packed, x.shape[0],
                          x.shape[1] * (2 if in_packed else 1))
        return run

    def crc_program(mesh=None):
        def run(stream, se):
            got["crc"].append((np.asarray(stream), np.asarray(se)))
            return np.zeros(se.shape[1], np.int32)
        return run

    monkeypatch.setattr(jpb, "_stream_program", stream_program)
    monkeypatch.setattr(jpb, "_bits_program", bits_program)
    monkeypatch.setattr(jpb, "_crc_program", crc_program)
    monkeypatch.setattr(jpipe, "_decode_program", decode_program)
    monkeypatch.setattr(
        jpb, "_sample_program_sharded",
        lambda in_packed, out_packed, _mesh: decode_program(in_packed,
                                                            out_packed))
    braws, jmode = jpipe.extract_streams_bits(datas, native)
    assert jmode == mode
    dd = jpb.decode_raw_bits_device(braws, lane_quantum, mode, mesh=mesh)
    return got, dd.lane_plans()


def _assert_delta_buckets(bp, jax_bits):
    """Each delta bucket equals the JAX package's upload: the static P and
    SA, the packing flag, deltas, ks and meta; the slot words of every
    chunk of a real lane that hold its codes' bits (the sum of the
    chunk's deltas). The JAX planner leaves the other slot words
    uninitialised, the port zeroes them outside the real lanes' chunks
    (inside, the walk leaves words past a chunk's bits unwritten in both
    packages, and no output reads them)."""
    assert len(bp.bits) == len(jax_bits) > 1
    assert bp.stream is None and bp.se is None
    for b, (P, SA, slots, deltas, ks, meta, out_packed) in zip(bp.bits,
                                                              jax_bits):
        assert (b.n_parts_max, b.sa) == (P, SA)
        assert b.out_packed is out_packed
        for mine, theirs in ((b.deltas, deltas), (b.ks, ks),
                             (b.meta, meta)):
            assert mine.dtype == theirs.dtype
            assert np.array_equal(mine, theirs)
        assert b.slots.dtype == slots.dtype and b.slots.shape == slots.shape
        L = slots.shape[0]
        mine3 = b.slots.reshape(L, b.nc, SA)
        theirs3 = slots.reshape(L, b.nc, SA)
        filled = np.zeros((L, b.nc), bool)
        bits = b.deltas.reshape(L, b.nc, 32).astype(np.int64).sum(axis=2)
        for _si, _out0, nf, bs, nch, lane0 in b.plan:
            filled[lane0:lane0 + nf * nch, :(bs + 31) // 32] = True
        for lane, c in zip(*np.nonzero(filled)):
            n = (bits[lane, c] + 31) // 32
            assert np.array_equal(mine3[lane, c, :n], theirs3[lane, c, :n])
        assert not mine3[~filled].any()


@pytest.mark.parametrize("lane_quantum, mode", [
    (128, "stream"), (32, "stream"), (128, "delta"), (32, "delta")],
    ids=["128", "32", "128-delta", "32-delta"])
def test_planner_uploads_are_byte_identical(monkeypatch, lane_quantum, mode):
    """The port's numpy planner builds exactly the uploads the JAX
    package's programs receive: in stream mode the stream words, packed
    mb per bucket (same order, same static P/SA/NC) and CRC ranges se; in
    delta mode the (T, nch, SA) buckets' slots, deltas, ks and meta; in
    both the fallback buckets (their residuals as the same int16 pairs)
    and the int16 packing flags the JAX programs were built with."""
    _assert_planner_matches_jax(monkeypatch, lane_quantum, mode)


def test_planner_uploads_match_jax_on_a_mesh_of_three(monkeypatch):
    """The same at the lane quantum of a 3-device mesh (lcm(128, 6) =
    384, every bucket splitting into three even lane ranges), against
    the JAX planner over a JAX mesh of 3 devices, whose CRC ranges pad to
    a multiple of 3: the port's ``plan_raw_bits(..., n_shards=3)``."""
    import claxon_tpu.parallel as jpar
    from claxon_tpu_torch.parallel import lane_quantum, make_mesh

    q = lane_quantum(make_mesh(devices=["cpu"] * 3))
    assert q == jpar.lane_quantum(jpar.make_mesh(3)) == 384
    bp = _assert_planner_matches_jax(monkeypatch, q, "stream",
                                     jpar.make_mesh(3))
    assert bp.se.shape[1] % 3 == 0 and bp.se.shape[1] > bp.n_crc
    assert all(len(b.mb) % 384 == 0 for b in bp.bits)


def _assert_planner_matches_jax(monkeypatch, lane_quantum, mode, mesh=None):
    """The checks of the two tests above; returns the port's plan."""
    datas = _generated() + _configs() + [_fallback_stream()]
    jax_up, jax_plans = _capture_jax_uploads(monkeypatch, datas,
                                             lane_quantum, mode, mesh)
    bp = tpb.plan_raw_bits(extract_streams_bits(datas, native, mode),
                           lane_quantum, mode,
                           1 if mesh is None else mesh.devices.size)

    if mode == "delta":
        _assert_delta_buckets(bp, jax_up["bits"])
        assert not jax_up["crc"]
    else:
        assert len(bp.bits) == len(jax_up["bits"]) > 1
        for b, (P, SA, NC, stream, mb, out_packed) in zip(bp.bits,
                                                          jax_up["bits"]):
            assert (b.n_parts_max, b.sa, b.nc) == (P, SA, NC)
            assert b.out_packed is out_packed
            assert np.array_equal(bp.stream, stream)
            assert b.mb.dtype == mb.dtype and np.array_equal(b.mb, mb)
        [(stream, se)] = jax_up["crc"]
        assert np.array_equal(bp.stream, stream)
        assert bp.se.dtype == se.dtype and np.array_equal(bp.se, se)
    assert len(bp.samples) == len(jax_up["samples"]) == 1
    for s, (x, coefs, shifts, orders, wasted, pair_modes, lengths,
            in_packed, out_packed) in zip(bp.samples, jax_up["samples"]):
        assert (s.in_packed, s.out_packed) == (in_packed, out_packed)
        assert s.in_packed and s.x.shape[1] * 2 == 16384  # int16 pairs
        assert s.x.dtype == x.dtype and s.x.tobytes() == x.tobytes()
        for mine, theirs in ((s.x, x), (s.coefs, coefs), (s.shifts, shifts),
                             (s.orders, orders), (s.wasted, wasted),
                             (s.pair_modes, pair_modes),
                             (s.lengths, lengths)):
            assert np.array_equal(mine, theirs)
    assert [b.plan for b in bp.bits] + [s.plan for s in bp.samples] == \
        jax_plans
    # 16-bit buckets pack, the 24- and 32-bit ones do not.
    assert {b.out_packed for b in bp.bits} == {True, False}
    if mode == "delta":
        return bp

    # inputs_from_numpy turns the captured arrays into the port's tensors.
    P, SA, NC, stream, mb, _packed = jax_up["bits"][0]
    s_t, mb_t, se_t = tpb.inputs_from_numpy(stream, mb, se, device="cpu")
    assert s_t.dtype == mb_t.dtype == se_t.dtype == torch.int32
    assert np.array_equal(mb_t.numpy(), mb)
    return bp


def _assert_oracle(datas, results):
    assert len(results) == len(datas)
    for data, dec in zip(datas, results):
        si, pcm = native.decode_stream_scalar(data)
        assert np.array_equal(dec.pcm, pcm)
        if si.md5sum != b"\x00" * 16:
            assert pcm_md5(dec.pcm, si.bits_per_sample) == si.md5sum


def test_slice_matches_jax_and_oracle():
    """The whole slice, to host through the int16 transfer: the port packs
    exactly the buckets the JAX package packs (16-bit audio), fetches
    those as int16 pairs and the others as int32, and gives the same
    PCM."""
    datas = _generated() + _configs()
    dd = ct.decode_streams_device(datas, device="cpu")
    port = dd.to_host()
    _assert_oracle(datas, port)
    ref_dd = jpipe.decode_streams_device(datas, segmentation="host")
    assert [d.packed for d in dd.dispatches] == \
        [d.packed for d in ref_dd.dispatches]
    assert {d.packed for d in dd.dispatches} == {True, False}
    for d in dd.dispatches:
        if d.packed:
            L, T = d.out_full.shape
            assert d.words.shape == (L, T // 2) and int(d.flag) == 0
            assert d.host is None  # no int32 copy was made
        else:
            assert d.words is None and d.host.shape == d.out_full.shape
    ref = ref_dd.to_host()
    for a, b in zip(port, ref):
        assert np.array_equal(a.pcm, b.pcm)
        assert a.frame_times == b.frame_times
        assert a.frame_sizes == b.frame_sizes
        # Each package has its own StreamInfo class: compare the fields.
        assert dataclasses.astuple(a.streaminfo) == \
            dataclasses.astuple(b.streaminfo)


def test_device_resident_api():
    datas = _configs()[:2]
    dd = ct.decode_streams_device(datas, device="cpu")
    assert dd.sync() is dd
    buckets = dd.device_buckets()
    plans = dd.lane_plans()
    assert len(buckets) == len(plans) > 0
    for (_idx, n_ch, out), plan in zip(buckets, plans):
        assert out.dtype == torch.int32 and n_ch == 2
        for si, out0, nf, bs, nch, lane0 in plan:
            pcm = native.decode_stream_scalar(datas[si])[1]
            # Lane lane0 + f*nch + c holds frame f, channel c of the run.
            assert np.array_equal(out[lane0 + 1, :bs].numpy(),
                                  pcm[out0:out0 + bs, 1])
    _assert_oracle(datas, dd.start_fetch().to_host())


def _count_calls(monkeypatch, name):
    """Count calls of ``claxon_tpu_torch.ops.epilogue.<name>`` (the
    wrappers look it up there at each call)."""
    from claxon_tpu_torch.ops import epilogue

    calls = []
    fn = getattr(epilogue, name)
    monkeypatch.setattr(epilogue, name,
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def test_packing_happens_at_fetch_time_only(monkeypatch):
    """device_buckets(), lane_plans() and sync() pack nothing;
    start_fetch() packs each 16-bit bucket once, however often it and
    to_host() are called."""
    packs = _count_calls(monkeypatch, "pack_int16_pairs")
    datas = _configs()
    dd = ct.decode_streams_device(datas, device="cpu")
    dd.device_buckets()
    dd.lane_plans()
    dd.sync()
    assert not packs and all(d.words is None for d in dd.dispatches)
    assert dd.start_fetch() is dd
    n = len(dd.dispatches)
    assert len(packs) == n > 0 and all(d.packed for d in dd.dispatches)
    words = [d.words for d in dd.dispatches]
    dd.start_fetch()
    first = [r.pcm.copy() for r in dd.to_host()]
    again = dd.to_host()
    assert len(packs) == n
    assert all(d.words is w for d, w in zip(dd.dispatches, words))
    assert all(np.array_equal(a, b.pcm) for a, b in zip(first, again))
    _assert_oracle(datas, again)


def test_int16_overflow_flag_refetches_int32():
    """A bucket marked packed whose values leave int16 (only an invalid
    stream's garbage can) sets the flag; to_host() then fetches the int32
    bucket and scatters that: the same PCM as an unpacked bucket gives."""
    from claxon_tpu_torch.pipeline import (DecodedStream, DeviceDecoded,
                                           _BucketDispatch)

    rng = np.random.default_rng(91)
    L, T, bs, nf = 8, 64, 50, 3
    out = rng.integers(-32768, 32768, (L, T)).astype(np.int32)
    out[3, 7] = 40000
    out[4, bs - 1] = -(1 << 31)
    plan = [[(0, 0, nf, bs, 2, 0)]]

    def build(packed):
        pcm = np.zeros((nf * bs, 2), np.int32)
        res = DecodedStream(None, pcm, [0, bs, 2 * bs], [bs] * nf)
        d = _BucketDispatch(2, torch.from_numpy(out.copy()), packed)
        return DeviceDecoded([res], [d], plan, [pcm]), d

    dd, d = build(True)
    got = dd.to_host()[0].pcm
    assert int(d.flag) == 1 and d.host is not None
    want = build(False)[0].to_host()[0].pcm
    assert np.array_equal(got, want)
    # Lane 3 is frame 1, channel 1; lane 4 is frame 2, channel 0.
    assert got[bs + 7, 1] == 40000 and got[3 * bs - 1, 0] == -(1 << 31)
    # In range, the same bucket goes through the int16 view.
    out[3, 7], out[4, bs - 1] = 32767, -32768
    dd, d = build(True)
    got = dd.to_host()[0].pcm
    assert int(d.flag) == 0 and d.host is None
    assert np.array_equal(got, build(False)[0].to_host()[0].pcm)


@pytest.mark.parametrize("segmentation", ["host", "device"])
def test_damaged_stream_leaving_int16_refetches_int32(segmentation):
    """A 16-bit stream with one damaged byte and its frame CRC repaired
    decodes to garbage outside int16: the bucket's flag fires, as in the
    JAX package, and the int32 refetch gives the scalar decoder's PCM."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    bad = chip_smoke.overflow_stream()
    want = native.decode_stream_scalar(bad)[1]
    assert np.abs(want.astype(np.int64)).max() > 32767
    dd = ct.decode_streams_device([bad], segmentation=segmentation,
                                  device="cpu")
    got = dd.to_host()[0]
    assert dd.fallback_streams == []
    assert [(d.packed, int(d.flag)) for d in dd.dispatches] == [(True, 1)]
    assert dd.dispatches[0].host is not None
    assert np.array_equal(got.pcm, want)
    if segmentation == "host":
        ref_dd = jpipe.decode_streams_device([bad], segmentation="host")
        assert [(d.packed, int(d.flag)) for d in ref_dd.dispatches] == \
            [(True, 1)]
        assert np.array_equal(got.pcm, ref_dd.to_host()[0].pcm)


@pytest.mark.parametrize("segmentation", ["host", "device"])
def test_padding_never_trips_int16_flag(segmentation):
    """A short tail frame lies in a bucket wider than itself, beside
    padding lanes: neither the columns past a frame's length nor the
    padding lanes leave int16 (K1 zeroes them), so the flag, taken over
    every element, stays clear on a loud stream."""
    from claxon_tpu_torch.ops.epilogue import pack_int16_pairs

    pcm = np.linspace(20000, 32000, 5000).astype(np.int64).reshape(2500, 2)
    data = encode_flac(pcm, 44100, 16, block_size=1024)
    dd = ct.decode_streams_device([data], segmentation=segmentation,
                                  device="cpu").start_fetch()
    assert dd.fallback_streams == []
    tails = 0
    for d, plan in zip(dd.dispatches, dd.lane_plans()):
        assert d.packed, "a 16-bit stream fetches as int16 pairs"
        assert int(d.flag) == 0
        assert not pack_int16_pairs(d.out_full, per_lane=True)[1].any()
        used = 0
        for _si, _out0, nf, bs, nch, lane0 in plan:
            used = max(used, lane0 + nf * nch)
            assert d.out_full[lane0:lane0 + nf * nch, :bs].abs().max() > 20000
            assert not d.out_full[lane0:lane0 + nf * nch, bs:].any()
            tails += bs < d.out_full.shape[1]
        assert used < d.out_full.shape[0]
        assert not d.out_full[used:].any()  # padding lanes
    assert tails == 1
    assert np.array_equal(dd.to_host()[0].pcm, pcm)


def test_single_stream_and_pipelined():
    datas = _configs()
    _assert_oracle(datas[:1], [ct.decode_stream(datas[0], device="cpu")])
    _assert_oracle(datas, ct.decode_streams_pipelined(
        datas, batch_streams=2, depth=1, device="cpu"))


def test_fallback_many_partitions():
    data = _fallback_stream()
    _si, bb = native.extract_stream_bits(data)
    assert np.any(bb.bframes["flags"] & 1), "expected fallback frames"
    _assert_oracle([data], ct.decode_streams([data], device="cpu"))


def test_fallback_bucket_uploads_int16_pairs(monkeypatch):
    """A fallback bucket whose residuals fit int16 uploads them as int16
    pairs (half the bytes, counted in upload_bytes) and unpacks them on
    the device before K1; one that does not fit uploads int32."""
    data = _fallback_stream()
    bp = tpb.plan_raw_bits(extract_streams_bits([data], native), 128)
    [sb] = bp.samples
    assert sb.in_packed and sb.out_packed and not bp.bits
    L, T = sb.lengths.shape[0], 16384
    assert sb.x.shape == (L, T // 2)
    unpacks, unpack = [], tpb.unpack_int16_pairs
    monkeypatch.setattr(tpb, "unpack_int16_pairs",
                        lambda w: unpacks.append(tuple(w.shape)) or unpack(w))
    dd = ct.decode_streams_device([data], device="cpu")
    assert unpacks == [(L, T // 2)]
    small = sum(a.nbytes for a in (sb.coefs, sb.shifts, sb.orders,
                                   sb.wasted, sb.pair_modes, sb.lengths))
    assert dd.upload_bytes == bp.stream.nbytes + L * T * 2 + small \
        + bp.se.nbytes
    _assert_oracle([data], dd.to_host())

    # Verbatim 24-bit samples do not fit: the bucket stays int32.
    wide = encode_flac(synth_music(16384, channels=2, bps=24, seed=45),
                       44100, 24, block_size=16384, max_lpc_order=4,
                       partition_order=7)
    bp = tpb.plan_raw_bits(extract_streams_bits([wide], native), 128)
    assert [(s.in_packed, s.out_packed, s.x.shape[1])
            for s in bp.samples] == [(False, False, 16384)]
    _assert_oracle([wide], ct.decode_streams([wide], device="cpu"))


def _first_frame_span(data):
    """(abs_byte0, abs_byte1) of frame 0, via a host-verified walk."""
    from claxon_tpu.native.binding import _read_metadata

    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    _si, pos = _read_metadata(data)
    f0 = bb.bframes[0]
    return pos + int(f0["byte0"]), pos + int(f0["byte1"])


def _corrupt_crc(data):
    _b0, b1 = _first_frame_span(data)
    bad = bytearray(data)
    bad[b1 - 1] ^= 0xFF  # stored CRC byte: the frame still parses
    return bytes(bad)


def test_device_crc_flags_corrupt_frame():
    data = encode_flac(synth_music(1024 * 3, channels=2, bps=16, seed=77),
                       44100, 16, block_size=1024)
    bad = _corrupt_crc(data)
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        ct.decode_streams_device([bad], device="cpu").to_host()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        ct.decode_streams_device([bad], device="cpu").sync()
    _assert_oracle([data], ct.decode_streams([data], device="cpu"))


def test_device_crc_failure_latches():
    data = encode_flac(synth_music(1024 * 2, channels=2, bps=16, seed=81),
                       44100, 16, block_size=1024)
    dd = ct.decode_streams_device([_corrupt_crc(data)], device="cpu")
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.verify_crc()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.sync()


def test_deferred_crc_precedes_later_walk_error():
    """A CRC-corrupt frame before a malformed one surfaces "frame CRC
    mismatch", as the sequential reference would, in both packages."""
    data = encode_flac(synth_music(1024 * 3, channels=1, bps=16, seed=79),
                       44100, 16, block_size=1024)
    _b0, b1 = _first_frame_span(data)
    bad = bytearray(data[:b1 + 7])  # truncated mid-frame 1: a walk error
    bad[b1 - 1] ^= 0xFF             # and frame 0's CRC corrupted
    with pytest.raises(Error) as port:
        ct.decode_streams_device([bytes(bad)], device="cpu").to_host()
    with pytest.raises(RefError) as ref:
        jpipe.decode_streams_device([bytes(bad)],
                                    segmentation="host").to_host()
    assert "frame CRC mismatch" in str(port.value)
    # Each package raises its own classes: compare name and message.
    assert type(port.value).__name__ == type(ref.value).__name__
    assert str(port.value) == str(ref.value)


def test_channel_count_error_after_deferred_crc_check():
    """A frame whose channel count disagrees with STREAMINFO raises the
    reference's error, unless an earlier frame's deferred CRC fails."""
    mono = encode_flac(synth_music(2048, channels=1, bps=16, seed=83),
                       44100, 16, block_size=1024)
    si, bb = native.extract_stream_bits(mono, emit_slots=False,
                                        defer_crc=True)
    bb.bframes["channels"][1] = 2
    with pytest.raises(FormatError, match="channel count does not match"):
        tpb.plan_raw_bits([(si, bb)], 128)


def test_fuzzed_streams_decode_or_raise():
    """Damaged streams decode exactly like the scalar decoder, or raise
    claxon_tpu_torch.Error where it raises -- never another exception."""
    from test_torch_cuda import assert_decodes_like_scalar, fuzzed_streams

    assert_decodes_like_scalar(fuzzed_streams(), "cpu")


def test_decode_streams_device_empty_batch():
    assert ct.decode_streams_device([], device="cpu").to_host() == []
    assert ct.decode_streams([], device="cpu") == []


def test_unported_options_raise(monkeypatch):
    """Options that once raised now decode exactly. The Python-extractor
    route (use_native=False) decodes a container through the FrameDesc
    route. segmentation="auto" calibrates and decodes. A single stream at
    the 2^27-byte batch limit (int32 chunk bit positions) walks in chunks
    of frames on both paths."""
    import claxon_tpu_torch.pipeline as tp
    from claxon_tpu_torch.testing import mux_ogg_flac

    data = _configs()[1]
    _assert_oracle([data], [ct.decode_ogg_stream(
        mux_ogg_flac(data), use_native=False, device="cpu")])
    monkeypatch.setitem(tp._seg_auto("cpu"), "choice", None)
    _assert_oracle([data], ct.decode_streams_device(
        [data], segmentation="auto", device="cpu").to_host())
    assert tp._seg_auto("cpu")["choice"] in ("host", "device")
    monkeypatch.setattr(tpb, "MAX_BATCH_BYTES", len(data))
    for segmentation in ("host", "device"):
        _assert_oracle([data], ct.decode_streams_device(
            [data], segmentation=segmentation, device="cpu").to_host())


def _positional_calls(data):
    """Each stream entry point called with the reference's positional
    arguments up to ``use_native`` (claxon_tpu/pipeline.py:644-842), its
    PCM on the host."""
    return {
        "decode_stream": lambda u: [ct.decode_stream(data, u,
                                                     device="cpu")],
        "decode_streams": lambda u: ct.decode_streams([data], u,
                                                      device="cpu"),
        "decode_streams_device": lambda u: ct.decode_streams_device(
            [data], u, device="cpu").to_host(),
        "decode_streams_device_async": lambda u:
            ct.decode_streams_device_async([data], u,
                                           device="cpu").finish().to_host(),
        "decode_streams_pipelined": lambda u: ct.decode_streams_pipelined(
            [data], 8, 6, u, device="cpu"),
    }


@pytest.mark.parametrize("entry", [
    "decode_stream", "decode_streams", "decode_streams_device",
    "decode_streams_device_async", "decode_streams_pipelined"])
def test_positional_use_native(entry):
    """``use_native`` sits where the reference has it: True decodes as the
    default call does, and False (the Python extractor and the FrameDesc
    route) decodes the same PCM and frame times, not an error from the
    argument landing on another parameter."""
    data = _configs()[1]
    call = _positional_calls(data)[entry]
    want = ct.decode_streams([data], device="cpu")[0]
    for use_native in (True, False):
        (got,) = call(use_native)
        assert np.array_equal(got.pcm, want.pcm)
        assert got.frame_times == want.frame_times


def test_positional_decode_bucket_decodes():
    """The reference's third positional argument of ``decode_streams``, its
    per-bucket call on the FrameDesc route, receives each bucket's numpy
    arrays and its result is the PCM."""
    import functools

    import claxon_tpu_torch.pipeline as tp

    data = _configs()[1]
    calls = []

    def bucket(*arrays):
        calls.append(len(arrays))
        return tp.device_decode_bucket(*arrays, device="cpu").numpy()

    (got,) = ct.decode_streams([data], True, bucket, device="cpu")
    _assert_oracle([data], [got])
    assert calls and set(calls) == {7}
    (plain,) = ct.decode_streams(
        [data], False, functools.partial(tp.device_decode_bucket,
                                         device="cpu"), device="cpu")
    assert np.array_equal(plain.pcm, got.pcm)


@pytest.mark.parametrize("segmentation", ["host", "device"])
def test_batch_above_the_byte_limit_splits(monkeypatch, segmentation):
    """A batch of MAX_BATCH_BYTES or more decodes as sub-batches split at
    stream boundaries, exactly as unsplit; the segmented path hands such a
    batch to the host walk whole. A corrupted CRC in the second sub-batch
    raises, and the failure latches."""
    datas = _configs()
    want = ct.decode_streams_device(datas, device="cpu")
    want_res = want.to_host()
    # Every stream fits the limit and no two do: three sub-batches.
    limit = max(len(d) for d in datas) + 1
    assert min(len(a) + len(b) for a in datas for b in datas
               if a is not b) >= limit
    monkeypatch.setattr(tpb, "MAX_BATCH_BYTES", limit)
    dd = ct.decode_streams_device(datas, segmentation=segmentation,
                                  device="cpu")
    assert len(dd.crc_check) == 3  # one CRC dispatch per sub-batch
    assert dd.lane_plans() != want.lane_plans()
    got = dd.to_host()
    _assert_oracle(datas, got)
    for g, w in zip(got, want_res):
        assert np.array_equal(g.pcm, w.pcm)
        assert g.frame_times == w.frame_times

    bad = datas[:1] + [_corrupt_crc(datas[1])] + datas[2:]
    dd = ct.decode_streams_device(bad, segmentation=segmentation,
                                  device="cpu")
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.sync()


@pytest.mark.parametrize("segmentation", ["host", "device"])
def test_single_stream_above_the_byte_limit_walks_in_chunks(monkeypatch,
                                                            segmentation):
    """One stream of MAX_BATCH_BYTES or more walks in chunks of whole
    frames, decoded as runs below the limit whose PCM concatenates back:
    equal to the unchunked decode, the scalar decoder and the JAX
    package. A corrupted stored CRC in a middle chunk raises "frame CRC
    mismatch", and the failure latches."""
    from claxon_tpu.native.binding import _read_metadata

    from claxon_tpu_torch import native as tnative
    from claxon_tpu_torch.pipeline import _walk_chunks

    data = _configs()[0]
    whole = ct.decode_streams_device([data], device="cpu").to_host()[0]
    ref = jpipe.decode_streams_device([data], segmentation="host") \
        .to_host()[0]
    limit = len(data) // 3
    monkeypatch.setattr(tpb, "MAX_BATCH_BYTES", limit)
    _si, chunks = _walk_chunks(data, tnative, limit)
    assert len(chunks) >= 3
    assert all(len(bb.payload) + 4 < limit for bb in chunks)
    dd = ct.decode_streams_device([data], segmentation=segmentation,
                                  device="cpu")
    assert len(dd.crc_check) >= 3  # one CRC dispatch per run
    got = dd.to_host()[0]
    _assert_oracle([data], [got])
    for want in (whole, ref):
        assert np.array_equal(got.pcm, want.pcm)
        assert got.frame_times == want.frame_times
        assert got.frame_sizes == want.frame_sizes

    _si, bb = native.extract_stream_bits(data, emit_slots=False)
    mid = bb.bframes[len(bb.bframes) // 2]
    bad = bytearray(data)
    bad[_read_metadata(data)[1] + int(mid["byte1"]) - 1] ^= 0xFF
    dd = ct.decode_streams_device([bytes(bad)], segmentation=segmentation,
                                  device="cpu")
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.sync()


def test_delta_mode_matches_jax_and_md5(monkeypatch):
    """CLAXON_TPU_ENTROPY=delta (K9 on host-relocated slots, no K4): the
    generated corpus decodes to the JAX package's delta-mode PCM and the
    stored MD5s (tests/test_bits.py::test_entropy_modes_end_to_end)."""
    monkeypatch.setenv("CLAXON_TPU_ENTROPY", "delta")
    datas = _generated()
    dd = ct.decode_streams_device(datas, device="cpu")
    assert dd.crc_check is None  # the walk checked every frame CRC
    port = dd.to_host()
    _assert_oracle(datas, port)
    for a, b in zip(port, jpipe.decode_streams(datas)):
        assert np.array_equal(a.pcm, b.pcm)
        assert a.frame_times == b.frame_times


def _outcome(decode):
    """("pcm", array) of a decode, or ("error", class name, message)."""
    try:
        return ("pcm", decode())
    except (Error, RefError) as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("knob", ["CLAXON_TPU_ENTROPY=delta",
                                  "CLAXON_TPU_HOST_CRC=1"])
def test_damaged_streams_raise_the_jax_errors(monkeypatch, knob):
    """The 24 seeded damaged streams under delta mode and under the host
    CRC check: the port decodes the JAX package's PCM or raises its error
    class with its message, stream by stream."""
    from test_torch_cuda import fuzzed_streams

    name, value = knob.split("=")
    monkeypatch.setenv(name, value)
    errors = 0
    for data in fuzzed_streams():
        got = _outcome(lambda: ct.decode_streams_device(
            [data], device="cpu").to_host()[0].pcm)
        want = _outcome(lambda: jpipe.decode_streams_device(
            [data], segmentation="host").to_host()[0].pcm)
        assert got[0] == want[0]
        if got[0] == "pcm":
            assert np.array_equal(got[1], want[1])
        else:
            assert got[1:] == want[1:]
            errors += 1
    assert errors >= 12


def test_host_crc_raises_from_the_call(monkeypatch):
    """CLAXON_TPU_HOST_CRC=1 moves the frame CRC check into the walk: a
    corrupted CRC raises from decode_streams_device itself, before any
    device work (tests/test_bits.py::test_device_crc_host_knob), as it
    does in delta mode; without either the call returns and to_host()
    raises (K4's verdict). The Ogg and MP4 calls honour the knob too."""
    from claxon_tpu_torch.testing import mux_mp4_flac, mux_ogg_flac

    data = encode_flac(synth_music(1024 * 2, channels=1, bps=16, seed=78),
                       44100, 16, block_size=1024)
    bad = _corrupt_crc(data)
    monkeypatch.delenv("CLAXON_TPU_HOST_CRC", raising=False)
    monkeypatch.delenv("CLAXON_TPU_ENTROPY", raising=False)
    dd = ct.decode_streams_device([bad], device="cpu")
    assert dd.crc_check is not None
    with pytest.raises(FormatError, match="frame CRC mismatch"):
        dd.to_host()
    calls = []
    monkeypatch.setattr(tpb, "crc16_ranges",
                        lambda *a: calls.append(1) or tpb.crc16_ranges(*a))
    for name, value in (("CLAXON_TPU_HOST_CRC", "1"),
                        ("CLAXON_TPU_ENTROPY", "delta")):
        monkeypatch.setenv(name, value)
        with pytest.raises(FormatError, match="frame CRC mismatch"):
            ct.decode_streams_device([bad], device="cpu")
        with pytest.raises(RefError, match="frame CRC mismatch"):
            jpipe.decode_streams_device([bad], segmentation="host")
        monkeypatch.delenv(name)
    monkeypatch.setenv("CLAXON_TPU_HOST_CRC", "1")
    for mux in (mux_ogg_flac, lambda d: mux_mp4_flac(d, 1)):
        with pytest.raises(FormatError, match="frame CRC mismatch"):
            ct.decode_ogg_stream(mux(bad), device="cpu") \
                if mux is mux_ogg_flac else \
                ct.decode_mp4_stream(mux(bad), device="cpu")
        _assert_oracle([data], [ct.decode_ogg_stream(mux(data), device="cpu")
                                if mux is mux_ogg_flac else
                                ct.decode_mp4_stream(mux(data),
                                                     device="cpu")])
    assert not calls  # K4 never ran


def test_unknown_knob_values_fall_back(monkeypatch):
    """An unknown CLAXON_TPU_ENTROPY is stream mode and an unknown
    CLAXON_TPU_SEG_ENTROPY values mode, as in the JAX package; an empty
    CLAXON_TPU_HOST_CRC leaves the check on the device, any other value
    moves it to the walk."""
    import claxon_tpu.pipeline_seg as jseg

    import claxon_tpu_torch.pipeline_seg as tseg
    from claxon_tpu_torch.pipeline import _walk_options

    data = _configs()[1]
    for value in ("bogus", "", "DELTA", "delta", "stream"):
        monkeypatch.setenv("CLAXON_TPU_ENTROPY", value)
        monkeypatch.setenv("CLAXON_TPU_SEG_ENTROPY", value or "scan")
        mode = _walk_options()[0]
        assert mode == jpipe.extract_streams_bits([data], native)[1]
        assert tseg._seg_mode() == jseg._seg_mode()
    for value, defer in (("", True), ("0", False), ("1", False)):
        monkeypatch.setenv("CLAXON_TPU_ENTROPY", "x")
        monkeypatch.setenv("CLAXON_TPU_HOST_CRC", value)
        assert _walk_options() == ("stream", False, defer)
        jbb = jpipe.extract_streams_bits([data], native)[0][0][1]
        tbb = extract_streams_bits([data], native)[0][1]
        assert np.array_equal(jbb.bframes["flags"], tbb.bframes["flags"])
    monkeypatch.setenv("CLAXON_TPU_HOST_CRC", "")
    dd = ct.decode_streams_device([data], device="cpu")
    assert dd.crc_check is not None
    _assert_oracle([data], dd.to_host())


def test_delta_mode_rejects_deferred_crc_batches():
    """Internal contract (tests/test_bits.py::test_delta_mode_rejects_
    deferred_crc_batches): a batch walked with defer_crc must take stream
    mode, whose upload K4 reads."""
    data = encode_flac(synth_music(1024, channels=1, bps=16, seed=90),
                       44100, 16, block_size=1024)
    si, bb = ct.pipeline._native().extract_stream_bits(
        data, emit_slots=True, defer_crc=True)
    with pytest.raises(RuntimeError, match="defer_crc"):
        tpb.decode_raw_bits_device([(si, bb)], 128, device="cpu",
                                   mode="delta")
