"""The sample-shipping route of the port (``CLAXON_TPU_NO_BITS``,
``pipeline.decode_raw_batches_device``, the C++ core's raw extraction and
pack helpers) against the JAX package, with tolerance 0: the raw arrays
and the helpers' outputs byte for byte; the five stream calls, the two
container calls and ``parallel.decode_streams_sharded`` under the
variable against the port's scalar decoder and the stored MD5, with
spies showing which route ran; lane runs that split where one stream's
frames interleave across buckets; the fused int16 fill against a numpy
fill; and the errors of damaged streams by class name and message, in
the JAX package's order. Every JAX call here raises before it compiles
anything. The one decode through both packages' raw dispatch is in
``tests/test_torch_extract.py``."""

import numpy as np
import pytest
import torch

from claxon_tpu import native as jnative
from claxon_tpu import pipeline as jpipeline

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline_bits as tbits
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch import native as tnative
from claxon_tpu_torch import pipeline as tpipeline
from claxon_tpu_torch import testing as ttesting
from test_torch_extract import _assert_scalar
from test_torch_reader import STREAMS, _outcome, _stream

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="native core not built")

#: Four streams that make several buckets: stereo, 8-bit mono, 24-bit and
#: 16-bit LPC at block sizes 4096 and 1152.
MIXED = ("leftside.flac", "mono8_fixed.flac", "hires24.flac",
         "encoded_lpc12_1152")


def _same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _same_streaminfo(got, want):
    assert got == type(got)(**want.__dict__)


@pytest.mark.parametrize("name", STREAMS)
def test_raw_extraction_matches_jax(name):
    """extract_stream_raw's streaminfo and three flat arrays, and
    extract_frames_raw's (whole, and bounded by max_frames), equal JAX's
    byte for byte."""
    data = _stream(name)
    want = jnative.extract_stream_raw(data)
    got = tnative.extract_stream_raw(data)
    _same_streaminfo(got[0], want[0])
    _same_arrays(got[1:], want[1:])
    pos = tnative.binding._read_metadata(data)[1]
    payload = memoryview(data)[pos:]
    for max_frames in (None, 1, 2):
        _same_arrays(tnative.extract_frames_raw(payload, max_frames),
                     jnative.binding.extract_frames_raw(payload,
                                                        max_frames))


def test_pack_helpers_match_jax():
    """has_pack_helpers, minmax (0 always in the range, empty arrays too)
    and rows_to_i16 (rows into the middle of a padded bucket) equal JAX's."""
    assert tnative.has_pack_helpers() == jnative.has_pack_helpers() is True
    rng = np.random.default_rng(16)
    cases = [np.zeros(0, np.int32), np.arange(5, 9, dtype=np.int32),
             -np.arange(1, 4, dtype=np.int32),
             rng.integers(-(1 << 31), 1 << 31, 1001).astype(np.int32)]
    for arr in cases:
        assert tnative.minmax(arr) == jnative.minmax(arr)
    src = rng.integers(-32768, 32768, 3 * 100).astype(np.int32)
    for bs in (100, 97):
        got = np.zeros((8, 128), np.int16)
        want = np.zeros((8, 128), np.int16)
        tnative.rows_to_i16(src, 3, bs, got, 4)
        jnative.rows_to_i16(src, 3, bs, want, 4)
        assert got.tobytes() == want.tobytes()
        assert np.array_equal(got[4:7, :bs], src[:3 * bs].reshape(3, bs))


def test_pack_helpers_refuse_overruns():
    """rows_to_i16 and minmax check what they hand the C++ core: a wrong
    dtype, a strided array, and rows past either array's end raise
    ValueError (the JAX package asserts these) and write nothing."""
    src = np.arange(300, dtype=np.int32)
    dst = np.zeros((8, 128), np.int16)
    bad = [(src.astype(np.int64), 3, 100, dst, 0),
           (src[::2], 1, 100, dst, 0),
           (src, 3, 100, dst.astype(np.int32), 0),
           (src, 3, 100, dst, 6), (src, 3, 129, dst, 0),
           (src, 4, 100, dst, 0), (src, 1, 10, dst, -1)]
    for args in bad:
        with pytest.raises(ValueError):
            tnative.rows_to_i16(*args)
    assert not dst.any()
    for arr in (src.astype(np.int16), src[::2]):
        with pytest.raises(ValueError):
            tnative.minmax(arr)


@pytest.fixture
def no_bits(monkeypatch):
    """CLAXON_TPU_NO_BITS=1, a clean "auto" cache, and spies: the raw
    route's calls are counted, and any call into the bits path, the
    segmented path or the calibration is recorded as forbidden."""
    monkeypatch.setenv("CLAXON_TPU_NO_BITS", "1")
    monkeypatch.setattr(tpipeline, "_SEG_AUTO", {})
    seen = {"raw": 0, "forbidden": []}
    orig = tpipeline.decode_raw_batches_device

    def raw(*a, **k):
        seen["raw"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tpipeline, "decode_raw_batches_device", raw)
    for mod, name in ((tbits, "decode_raw_bits_device"),
                      (tseg, "decode_streams_segmented"),
                      (tseg, "begin_segmented"),
                      (tpipeline, "_calibrate_segmentation"),
                      (tnative, "extract_stream_bits"),
                      (tnative, "extract_frames_bits")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            seen["forbidden"].append(_n))
    yield seen
    assert seen["forbidden"] == []


def _calls(datas, segmentation):
    """The five stream calls on the default route, PCM on the host."""
    return {
        "decode_stream": lambda: [ct.decode_stream(d, device="cpu")
                                  for d in datas],
        "decode_streams": lambda: ct.decode_streams(datas, device="cpu"),
        "decode_streams_device": lambda: ct.decode_streams_device(
            datas, segmentation=segmentation, device="cpu").to_host(),
        "decode_streams_device_async": lambda: ct.decode_streams_device_async(
            datas, segmentation=segmentation, device="cpu").finish()
        .to_host(),
        "decode_streams_pipelined": lambda: ct.decode_streams_pipelined(
            datas, 2, 2, device="cpu"),
    }


@pytest.mark.parametrize("segmentation", ["device", "auto"])
@pytest.mark.parametrize("entry", sorted(_calls([], None)))
def test_stream_calls_take_the_sample_shipping_route(entry, segmentation,
                                                     no_bits, monkeypatch):
    """Under the variable each stream call decodes the mixed corpus
    through the raw route whatever the segmentation says, equal to the
    scalar decoder and the MD5; "auto" calibrates and caches nothing."""
    monkeypatch.setenv("CLAXON_TPU_SEGMENTATION", segmentation)
    datas = [_stream(n) for n in MIXED]
    _assert_scalar(datas, _calls(datas, segmentation)[entry]())
    assert no_bits["raw"] >= 1
    assert tpipeline._seg_auto("cpu")["choice"] is None


def test_raw_route_device_resident(no_bits):
    """The DeviceDecoded of the raw route: runs of several frames a lane
    plan, no FrameDescs, no CRC left to check, the upload counted, and a
    24-bit bucket neither uploaded nor fetched as int16 pairs."""
    datas = [_stream(n) for n in MIXED]
    dd = ct.decode_streams_device(datas, device="cpu")
    assert dd.frames == [] and dd.crc_check is None
    assert all(b[0] == [] for b in dd.device_buckets())
    plans = dd.lane_plans()
    assert any(run[2] > 1 for plan in plans for run in plan)
    for plan, d in zip(plans, dd.dispatches):
        # Stream 2 is the only one wider than 16 bits.
        assert d.packed == (2 not in {run[0] for run in plan})
    assert dd.upload_bytes > 0
    _assert_scalar(datas, dd.to_host())


@pytest.fixture(params=["ogg", "mp4"])
def muxed(request):
    """(format, a stream, its container, damaged containers), muxed
    before ``no_bits`` spies on the walk the muxers use: a damaged frame,
    and for MP4 a chunk declaring more frames than it holds."""
    fmt = request.param

    def mux(data):
        return ttesting.mux_ogg_flac(data) if fmt == "ogg" else \
            ttesting.mux_mp4_flac(data, frames_per_chunk=2)

    flac = _stream("encoded_lpc12_1152")
    bad = bytearray(flac)
    bad[-1] ^= 0xFF
    data = mux(flac)
    cases = [mux(bytes(bad))]
    if fmt == "mp4":
        at = data.index(b"stsc") + 4 + 12
        cases.append(data[:at] + (4).to_bytes(4, "big") + data[at + 4:])
    return fmt, flac, data, cases


def test_containers_take_the_native_framedescs(muxed, no_bits, monkeypatch):
    """Under the variable the container calls extract with the C++
    core's FrameDesc extraction and decode on the FrameDesc route, equal
    to the scalar decoder; a damaged frame and a short MP4 chunk raise
    JAX's errors."""
    from claxon_tpu import containers as jcontainers

    fmt, flac, data, cases = muxed
    calls = []
    orig = tnative.extract_frames
    monkeypatch.setattr(tnative, "extract_frames",
                        lambda *a: calls.append(len(a)) or orig(*a))
    fn = ct.decode_ogg_stream if fmt == "ogg" else ct.decode_mp4_stream
    _assert_scalar([flac], [fn(data, device="cpu")])
    assert calls
    jfn = getattr(jcontainers, fn.__name__)
    for case in cases:
        want = _outcome(lambda: jfn(case))
        assert want[0] == "error"
        assert _outcome(lambda: fn(case, device="cpu")) == want


def test_sharded_call_takes_the_framedesc_step(no_bits, monkeypatch):
    """Under the variable decode_streams_sharded decodes the C++ core's
    FrameDescs through make_decode_step over a CPU mesh of two, whatever
    the segmentation says, equal to the scalar decoder."""
    import claxon_tpu_torch.parallel.mesh as tmesh

    steps, extracted = [], []
    orig_step, orig_extract = tmesh.make_decode_step, tnative.extract_stream
    monkeypatch.setattr(tmesh, "make_decode_step",
                        lambda m: steps.append(m) or orig_step(m))
    monkeypatch.setattr(tnative, "extract_stream",
                        lambda d: extracted.append(1) or orig_extract(d))
    monkeypatch.setattr(tpipeline, "decode_streams_device",
                        lambda *a, **k: no_bits["forbidden"].append("dsd"))
    datas = [_stream(n) for n in MIXED]
    mesh = tmesh.make_mesh(devices=["cpu", "cpu"])
    for segmentation in ("host", "device", None):
        _assert_scalar(datas, tmesh.decode_streams_sharded(
            datas, mesh, segmentation=segmentation))
    assert steps == [mesh] * 3 and len(extracted) == 3 * len(datas)


@pytest.mark.parametrize("shape,hi", [((8, 6), 32767), ((8, 6), 32768),
                                      ((8, 5), 100)],
                         ids=["int16", "int32-range", "int32-odd-t"])
def test_fused_fill_matches_a_numpy_fill(shape, hi):
    """The raw route's fill (one C min/max pass a run, the C++ core's fused
    int16 convert) uploads what a numpy int32 fill and the FrameDesc
    route's packing rule (``_pack_input``) upload: int16 pairs when every
    run's samples fit and T is even, else int32, padding zero."""
    rng = np.random.default_rng(16)
    samples_of = [rng.integers(-hi, hi, 40, endpoint=True).astype(np.int32)
                  for _ in range(2)]
    samples_of[1][7] = hi  # in run 1: 32768 must not pack
    # (stream, p0, rows, bs, lane0); the runs leave lanes and columns
    # unfilled.
    runs = [(0, 0, 2, 4, 0), (1, 3, 3, shape[1], 3), (0, 20, 1, 1, 7)]
    want = np.zeros(shape, dtype=np.int32)
    for si, p0, nl, bs, lane0 in runs:
        want[lane0:lane0 + nl, :bs] = \
            samples_of[si][p0:p0 + nl * bs].reshape(nl, bs)
    (want,), want_packed = tpipeline._pack_input((want,))
    got, got_packed = tpipeline._fill_bucket(runs, samples_of, shape,
                                             tnative)
    assert got_packed == want_packed == (shape == (8, 6) and hi < 32768)
    _same_arrays([got], [want])


def _spliced(names, order):
    """One stream's raw arrays whose frames are frames of the streams
    ``names`` (stereo, 16-bit) in ``order`` ((stream, frame) pairs), and
    the PCM they decode to (frames decode independently: the scalar
    decoder's rows of each)."""
    parts = []
    for name in names:
        data = _stream(name)
        si, frames, subs, samples = tnative.extract_stream_raw(data)
        nch = frames["channels"].astype(np.int64)
        bs = frames["block_size"].astype(np.int64)
        parts.append((si, frames, subs, samples,
                      np.concatenate([[0], np.cumsum(nch)]),
                      np.concatenate([[0], np.cumsum(bs * nch)]),
                      np.concatenate([[0], np.cumsum(bs)]),
                      tnative.decode_stream_scalar(data)[1]))
    cat = np.concatenate
    pick = [(parts[s], f) for s, f in order]
    frames = cat([p[1][f:f + 1] for p, f in pick])
    subs = cat([p[2][p[4][f]:p[4][f + 1]] for p, f in pick])
    samples = cat([p[3][p[5][f]:p[5][f + 1]] for p, f in pick])
    pcm = cat([p[7][p[6][f]:p[6][f + 1]] for p, f in pick])
    return (parts[0][0], frames, subs, samples), pcm


def test_interleaved_block_sizes_split_runs(no_bits):
    """Frames of one stream that share a bucket but not a subframe run
    (4096-sample frames with 192-sample frames between them, in another
    bucket) make runs of their own: the PCM of every frame lands in its
    place, and each run's subframes are consecutive in the flat arrays."""
    raw, want = _spliced(["stereo16.flac", "encoded_midside_verbatim"],
                         [(0, 0), (1, 0), (1, 1), (0, 1), (0, 2), (1, 2),
                          (0, 3), (1, 3)])
    dd = tpipeline.decode_raw_batches_device([raw, raw], device="cpu")
    assert [[run[2] for run in plan] for plan in dd.lane_plans()] == \
        [[1, 2, 1] * 2, [2, 1, 1] * 2]
    for res in dd.to_host():
        assert np.array_equal(res.pcm, want)


def _no_channels(data):
    """``data`` with STREAMINFO saying one channel fewer than its frames
    carry (the 3 bits of channels - 1 in byte 20)."""
    data = bytearray(data)
    nch = ((data[20] >> 1) & 7) + 1
    data[20] = (data[20] & ~0x0E) | ((nch - 2) << 1)
    return bytes(data)


def test_damaged_streams_raise_jax_errors_in_order(no_bits):
    """24 seeded damaged streams, one at a time: JAX's raw extraction
    error by class and message, or the scalar decoder's PCM; in a batch
    the first bad stream's error surfaces before any dispatch. A channel
    mismatch in stream 0 raises after a CRC error in stream 1, since every
    stream is extracted first, as in JAX."""
    from test_torch_cuda import fuzzed_streams

    datas = fuzzed_streams()
    bad = 0
    for data in datas:
        want = _outcome(lambda: jnative.extract_stream_raw(data))
        if want[0] == "error":
            bad += 1
            assert _outcome(lambda: ct.decode_streams_device(
                [data], device="cpu")) == want
            continue
        got = ct.decode_streams_device([data], device="cpu").to_host()
        assert np.array_equal(got[0].pcm,
                              tnative.decode_stream_scalar(data)[1])
    assert bad
    flac = _stream("encoded_lpc12_1152")
    crc = bytearray(flac)
    crc[-1] ^= 0xFF
    batches = [datas, [_no_channels(flac), bytes(crc)],
               [_no_channels(flac), flac], [flac, _no_channels(flac)]]
    outcomes = []
    dispatched = []
    orig = tbits._decode_sample_shards
    tbits._decode_sample_shards = lambda *a: dispatched.append(a)
    try:
        for batch in batches:
            want = _outcome(lambda: jpipeline.decode_streams_device(batch))
            assert want[0] == "error"
            assert _outcome(lambda: ct.decode_streams_device(
                batch, device="cpu")) == want
            outcomes.append(want[1:])
    finally:
        tbits._decode_sample_shards = orig
    assert dispatched == []
    assert outcomes[1][0] == outcomes[2][0] == "FormatError"
    assert outcomes[1][1].endswith("frame CRC mismatch")
    assert outcomes[2] == outcomes[3]
    assert outcomes[2][1].endswith(
        "frame channel count does not match streaminfo")
