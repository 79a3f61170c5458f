"""The FrameDesc route of the port (``use_native=False`` and the
``decode_bucket`` override) against the JAX package, with tolerance 0:
the FrameDescs of the port's Python extractor (``claxon_tpu_torch.
extract``) and of its C++ one (``native.extract_stream``) field by field
against JAX's Python extractor; ``pack_bucket``'s seven arrays byte for
byte; one decode through both packages' FrameDesc dispatch (one bucket
shape, so one JAX compile), its lane plans and frame indices; and every
other case against the port's scalar decoder and the stored MD5: the five
stream calls, the two container calls, the override, the packing rule,
the errors (by class name and message) and their order."""

import functools

import numpy as np
import pytest

from claxon_tpu import extract as jextract
from claxon_tpu import native as jnative
from claxon_tpu import pipeline as jpipeline

import claxon_tpu_torch as ct
from claxon_tpu_torch import extract as textract
from claxon_tpu_torch import native as tnative
from claxon_tpu_torch import pipeline as tpipeline
from claxon_tpu_torch import testing as ttesting
from claxon_tpu_torch.io import MemReader
from test_torch_reader import STREAMS, _outcome, _stream

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="native core not built")

def _pair(n=2):
    """``n`` 16-bit stereo streams of whole 1152-sample blocks: one
    (L, T) bucket shape for the JAX comparison."""
    pcm = ttesting.synth_music(1152 * 3, channels=2, bps=16, seed=9)
    kws = [dict(), dict(max_lpc_order=12, stereo="left_side"),
           dict(stereo="mid_side", partition_order=2)]
    return [ttesting.encode_flac(pcm[:1152 * (2 + i % 2)], 44100, 16,
                                 block_size=1152, **kws[i % 3])
            for i in range(n)]


def _assert_scalar(datas, results):
    """PCM equal to the port's scalar decoder, and the stored MD5."""
    assert len(results) == len(datas)
    for data, res in zip(datas, results):
        si, want = tnative.decode_stream_scalar(data)
        assert np.array_equal(res.pcm, want)
        assert ttesting.pcm_md5(res.pcm, si.bits_per_sample) == si.md5sum


def _frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.block_size, g.channels, g.mode, g.bps, g.time) == \
            (w.block_size, w.channels, w.mode, w.bps, w.time)
        assert len(g.subframes) == len(w.subframes)
        for gs, ws in zip(g.subframes, w.subframes):
            assert (gs.order, gs.shift, gs.wasted) == \
                (ws.order, ws.shift, ws.wasted)
            for field in ("x", "coefs"):
                a, b = np.asarray(getattr(gs, field)), getattr(ws, field)
                assert a.dtype == b.dtype == np.int32
                assert np.array_equal(a, b), field


@pytest.mark.parametrize("name", STREAMS)
def test_framedescs_match_jax(name):
    """The port's Python extractor and its native one give JAX's Python
    extractor's StreamBatch, field by field; ``max_frames`` too."""
    data = _stream(name)
    want = jextract.extract_stream(data)
    for got in (textract.extract_stream(data), tnative.extract_stream(data)):
        assert got.streaminfo == type(got.streaminfo)(
            **want.streaminfo.__dict__)
        assert got.total_samples == want.total_samples
        _frames_equal(got.frames, want.frames)
    head = textract.extract_stream(data, max_frames=1)
    _frames_equal(head.frames, want.frames[:1])


def test_pack_bucket_is_byte_identical():
    """group_frames and pack_bucket over the frames of every stream of the
    corpus at once (several streams to a bucket, padding lanes, stereo
    pair modes, 8- to 32-bit, orders 0-32), at two lane quanta: the seven
    arrays byte for byte, and frame_offsets."""
    frames = [f for name in STREAMS
              for f in jextract.extract_stream(_stream(name)).frames]
    tframes = [f for name in STREAMS
               for f in textract.extract_stream(_stream(name)).frames]
    for quantum in (128, 32):
        groups = jpipeline.group_frames(frames, quantum)
        assert tpipeline.group_frames(tframes, quantum) == groups
        for (t_bucket, n_ch), idx in groups.items():
            want = jpipeline.pack_bucket(frames, idx, n_ch, t_bucket, quantum)
            got = tpipeline.pack_bucket(tframes, idx, n_ch, t_bucket,
                                        quantum)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    assert np.array_equal(tpipeline.frame_offsets(tframes),
                          jpipeline.frame_offsets(frames))


def test_decode_streams_python_extractor_matches_jax():
    """decode_streams(datas, False) through both packages (one bucket,
    L 128, T 1152), and the device-resident form: equal PCM, frame times,
    lane plans and frame indices of device_buckets(); the bucket packs
    its input and its output (16-bit)."""
    datas = _pair()
    jdd = jpipeline.decode_streams_device(datas, False)
    want = jdd.to_host()
    tdd = ct.decode_streams_device(datas, False, device="cpu")
    assert tdd.lane_plans() == jdd.lane_plans()
    assert [(b[0], b[1], tuple(b[2].shape)) for b in tdd.device_buckets()] \
        == [(b[0], b[1], tuple(b[2].shape)) for b in jdd.device_buckets()]
    assert [d.packed for d in tdd.dispatches] == [True]
    got = tdd.to_host()
    for g, w in zip(got, want):
        assert np.array_equal(g.pcm, w.pcm)
        assert (g.frame_times, g.frame_sizes) == (w.frame_times,
                                                  w.frame_sizes)
    _assert_scalar(datas, got)
    # Residuals as int16 pairs: (L, T // 2) int32, plus the per-lane rows.
    L, T = 128, 1152
    assert tdd.upload_bytes == L * T * 2 + L * 32 * 4 + 4 * L * 4 + L * 2
    assert tdd.crc_check is None
    for g, w in zip(ct.decode_streams(datas, False, device="cpu"), want):
        assert np.array_equal(g.pcm, w.pcm)


def test_raw_batches_match_jax(monkeypatch):
    """decode_raw_batches_device (the CLAXON_TPU_NO_BITS route) through
    both packages on the C++ core's raw arrays (one bucket, L 128, T
    1152, the program the test above compiles): equal PCM, frame times
    and sizes, lane plans (runs of several frames), bucket shapes and
    packed flags, and the seven uploaded arrays byte for byte."""
    import claxon_tpu_torch.pipeline_bits as tbits

    datas = _pair()
    uploads = {"jax": [], "torch": []}
    prog = jpipeline._decode_program

    def jax_program(*flags, **kw):
        run = prog(*flags, **kw)

        def spy(*args):
            uploads["jax"].append((flags, [np.asarray(a) for a in args]))
            return run(*args)
        return spy

    shards = tbits._decode_sample_shards

    def torch_shards(arrays, in_packed, mesh):
        uploads["torch"].append(((in_packed,), list(arrays)))
        return shards(arrays, in_packed, mesh)

    monkeypatch.setattr(jpipeline, "_decode_program", jax_program)
    monkeypatch.setattr(tbits, "_decode_sample_shards", torch_shards)
    jdd = jpipeline.decode_raw_batches_device(
        [jnative.extract_stream_raw(d) for d in datas])
    tdd = tpipeline.decode_raw_batches_device(
        [tnative.extract_stream_raw(d) for d in datas], device="cpu")
    assert tdd.lane_plans() == jdd.lane_plans()
    assert any(run[2] > 1 for plan in tdd.lane_plans() for run in plan)
    assert [(b[0], b[1], tuple(b[2].shape)) for b in tdd.device_buckets()] \
        == [(b[0], b[1], tuple(b[2].shape)) for b in jdd.device_buckets()]
    assert [d.packed for d in tdd.dispatches] == \
        [d.packed for d in jdd.dispatches] == [True]
    ((jflags, jargs),), ((tflags, targs),) = uploads["jax"], uploads["torch"]
    assert jflags[0] == tflags[0] is True  # the residuals as int16 pairs
    for a, b in zip(targs, jargs, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert tdd.upload_bytes == sum(a.nbytes for a in jargs)
    assert tdd.crc_check is None and tdd.frames == []
    want, got = jdd.to_host(), tdd.to_host()
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.pcm, w.pcm)
        assert (g.frame_times, g.frame_sizes) == (w.frame_times,
                                                  w.frame_sizes)
    _assert_scalar(datas, got)


def _calls(datas):
    """The five stream calls with use_native=False, PCM on the host."""
    return {
        "decode_stream": lambda: [ct.decode_stream(d, False, device="cpu")
                                  for d in datas],
        "decode_streams": lambda: ct.decode_streams(datas, False,
                                                    device="cpu"),
        "decode_streams_device": lambda: ct.decode_streams_device(
            datas, False, device="cpu").to_host(),
        "decode_streams_device_async": lambda: ct.decode_streams_device_async(
            datas, False, device="cpu").finish().to_host(),
        "decode_streams_pipelined": lambda: ct.decode_streams_pipelined(
            datas, 2, 2, False, device="cpu"),
    }


@pytest.mark.parametrize("entry", sorted(_calls([])))
def test_stream_calls_take_the_python_extractor(entry, monkeypatch):
    """Each stream call with use_native=False decodes the mixed corpus
    through the Python extractor and K1 + K3's plain form, whatever the
    segmentation says (the "auto" choice is neither read nor
    calibrated), equal to the scalar decoder."""
    datas = [_stream(n) for n in ("leftside.flac", "mono8_fixed.flac",
                                  "hires24.flac", "encoded_lpc12_1152")]
    walks = []
    monkeypatch.setattr(tnative, "extract_stream_bits",
                        lambda *a, **k: walks.append(a))
    monkeypatch.setattr(tpipeline, "_calibrate_segmentation",
                        lambda *a, **k: walks.append(a))
    for seg in ("auto", "device"):
        monkeypatch.setenv("CLAXON_TPU_SEGMENTATION", seg)
        _assert_scalar(datas, _calls(datas)[entry]())
    assert walks == []


def test_decode_batches_device_on_native_descriptors():
    """The FrameDesc dispatch fed by the C++ extractor (the chip check's
    full-width case): equal to the scalar decoder; a 24-bit bucket does
    not pack its output, a 16-bit one does."""
    names = ["hires24.flac", "stereo16.flac", "sixchan.flac",
             "variable_blocking.flac"]
    datas = [_stream(n) for n in names]
    dd = tpipeline.decode_batches_device(
        [tnative.extract_stream(d) for d in datas], device="cpu")
    for plan, d in zip(dd.lane_plans(), dd.dispatches):
        # Stream 0 is the only one wider than 16 bits.
        assert d.packed == (0 not in {run[0] for run in plan})
    assert not all(d.packed for d in dd.dispatches)
    _assert_scalar(datas, dd.to_host())
    assert dd.block_until_ready() is dd


@pytest.mark.parametrize("override", ["tensor", "numpy"])
def test_decode_bucket_override(override):
    """decode_streams' decode_bucket receives each bucket's seven numpy
    arrays, as in JAX, and may return a tensor or a numpy array; the
    streams are extracted as use_native says."""
    datas = [_stream("rice2.flac"), _stream("encoded_midside_verbatim")]
    seen = []

    def bucket(*arrays):
        seen.append([type(a) for a in arrays])
        out = tpipeline.device_decode_bucket(*arrays, device="cpu")
        return out if override == "tensor" else out.numpy()

    for use_native in (True, False):
        _assert_scalar(datas, ct.decode_streams(datas, use_native, bucket,
                                                device="cpu"))
    assert seen and all(t == [np.ndarray] * 7 for t in seen)
    # decode_batch / decode_batches take it too.
    batch = textract.extract_stream(datas[0])
    _assert_scalar(datas[:1], [tpipeline.decode_batch(batch, bucket,
                                                      device="cpu")])


def test_device_decode_bucket_default_lengths():
    """Without lengths every lane runs to T, as in JAX."""
    frames = textract.extract_stream(_stream("stereo16.flac")).frames[:2]
    x, coefs, shifts, orders, wasted, pair_modes, lengths = \
        tpipeline.pack_bucket(frames, [0, 1], 2, 4096)
    full = tpipeline.device_decode_bucket(x, coefs, shifts, orders, wasted,
                                          pair_modes, device="cpu")
    cut = tpipeline.device_decode_bucket(x, coefs, shifts, orders, wasted,
                                         pair_modes, lengths, device="cpu")
    assert np.array_equal(full.numpy()[:4], cut.numpy()[:4])
    assert full.dtype == cut.dtype


@pytest.mark.parametrize("fmt", ["ogg", "mp4"])
def test_containers_take_the_python_extractor(fmt):
    """decode_ogg_stream / decode_mp4_stream with use_native=False: the
    default route's PCM and the scalar decoder's; a short MP4 chunk and a
    damaged frame raise the JAX package's errors."""
    flac = _stream("encoded_lpc12_1152")
    fn = ct.decode_ogg_stream if fmt == "ogg" else ct.decode_mp4_stream
    data = ttesting.mux_ogg_flac(flac) if fmt == "ogg" else \
        ttesting.mux_mp4_flac(flac, frames_per_chunk=2)
    got = fn(data, use_native=False, device="cpu")
    assert np.array_equal(got.pcm, fn(data, device="cpu").pcm)
    _assert_scalar([flac], [got])
    from claxon_tpu import containers as jcontainers

    jfn = getattr(jcontainers, fn.__name__)
    bad = bytearray(flac)
    bad[-1] ^= 0xFF
    bad = ttesting.mux_ogg_flac(bytes(bad)) if fmt == "ogg" else \
        ttesting.mux_mp4_flac(bytes(bad), frames_per_chunk=2)
    cases = [bad]
    if fmt == "mp4":
        at = data.index(b"stsc") + 4 + 12
        cases.append(data[:at] + (4).to_bytes(4, "big") + data[at + 4:])
    for case in cases:
        want = _outcome(lambda: jfn(case, use_native=False))
        assert want[0] == "error"
        assert _outcome(lambda: fn(case, use_native=False,
                                   device="cpu")) == want


def test_python_extractor_errors_match_jax():
    """24 seeded damaged streams, one at a time: the JAX Python
    extractor's error by class and message, or the scalar decoder's PCM;
    in a batch the first bad stream's error surfaces, before any
    dispatch."""
    from test_torch_cuda import fuzzed_streams

    datas = fuzzed_streams()
    bad = []
    for i, data in enumerate(datas):
        want = _outcome(lambda: jextract.extract_stream(data))
        if want[0] == "error":
            bad.append(i)
            assert _outcome(lambda: ct.decode_streams(
                [data], False, device="cpu")) == want
        else:
            _assert_scalar([data], ct.decode_streams([data], False,
                                                     device="cpu"))
    assert bad
    first = _outcome(lambda: jextract.extract_stream(datas[bad[0]]))
    dispatched = []
    orig = tpipeline._dispatch_bucket
    try:
        tpipeline._dispatch_bucket = lambda *a: dispatched.append(a)
        assert _outcome(lambda: ct.decode_streams_device(
            datas, False, device="cpu")) == first
    finally:
        tpipeline._dispatch_bucket = orig
    assert dispatched == []


def test_channel_count_mismatch_matches_jax():
    """A StreamBatch whose frame disagrees with STREAMINFO's channel count
    raises _prepare_outputs' error, as in JAX."""
    data = _stream("mono8_fixed.flac")
    jb, tb = jextract.extract_stream(data), textract.extract_stream(data)
    jb.frames[1].channels = tb.frames[1].channels = 2
    want = _outcome(lambda: jpipeline._prepare_outputs([jb]))
    assert want[:2] == ("error", "FormatError")
    assert _outcome(lambda: tpipeline.decode_batches_device(
        [tb], device="cpu")) == want
    assert _outcome(lambda: tpipeline.decode_batches(
        [tb], functools.partial(tpipeline.device_decode_bucket,
                                device="cpu"), device="cpu")) == want


def test_block_until_ready_gives_no_crc_verdict():
    """block_until_ready() waits without the CRC check; sync() raises the
    deferred mismatch, as in JAX."""
    data = bytearray(_pair(1)[0])
    data[-1] ^= 0xFF  # the stored CRC-16 of the last frame
    dd = ct.decode_streams_device([bytes(data)], segmentation="host",
                                  device="cpu")
    assert dd.block_until_ready() is dd
    with pytest.raises(ct.FormatError, match="frame CRC mismatch"):
        dd.sync()


def test_extract_frames_reads_a_memreader():
    """extract_frames on a MemReader positioned at the first frame, as
    the container calls use it."""
    data = _stream("leftside.flac")
    si, pos = tnative.binding._read_metadata(data)
    frames = textract.extract_frames(MemReader(data, pos=pos))
    _frames_equal(frames, jextract.extract_stream(data).frames)
