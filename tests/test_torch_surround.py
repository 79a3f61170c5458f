"""5.1 surround hi-res streams through the port's default route on the
CPU (``device="cpu"``, so every kernel takes its plain form): six
independently coded channels (channel assignment 0b0101: FL FR FC LFE BL
BR), 24 bits, 96 kHz, block 4096, LPC order 12 and RICE2 partitions, as
``flac -8`` codes hi-res multichannel releases. The device demux takes
one or two channels, so every such stream takes the host walk
(``pipeline._decode_host_walk``), and a stream of ``MAX_BATCH_BYTES`` or
more walks in chunks of frames, planned in runs below that limit.

The PCM is held to the JAX package's scalar decoder, the STREAMINFO MD5
and the benchmark's plain reference (``flacbench/reference/flac.py``)
with tolerance 0; the batch's walk counters (``walk_streams``,
``walk_units``, ``walk_runs``, ``walk_frames``, ``walk_bytes``) are held
to what the batch holds, whole and walked in chunks.
"""

import numpy as np
import pytest

from claxon_tpu import native as jax_native

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline as tp
import claxon_tpu_torch.pipeline_bits as tpb
from claxon_tpu_torch import native
from claxon_tpu_torch.native.binding import _read_metadata
from claxon_tpu_torch.testing import encode_flac, pcm_md5, synth_music
from flacbench.reference.flac import decode_stream as reference_decode

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

RATE = 96000
BPS = 24
CHANNELS = 6
BLOCK = 4096
#: the first ends in a short frame, the second in a whole one.
LENGTHS = (11500, 8192)
COUNTERS = ("walk_streams", "walk_units", "walk_runs", "walk_frames",
            "walk_bytes")


def _surround(n, seed):
    """A 5.1 stream at the configuration's widths: block 4096, LPC order
    12 with 15-bit coefficients, partition order 6 (lowered for a short
    frame it cannot split), RICE2 codes."""
    return encode_flac(synth_music(n, channels=CHANNELS, bps=BPS, seed=seed,
                                   sample_rate=RATE),
                       RATE, BPS, block_size=BLOCK, max_lpc_order=12,
                       partition_order=6, rice2=True, lpc_precision=15)


@pytest.fixture(scope="module")
def surround():
    return [_surround(n, 510 + k) for k, n in enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def want(surround):
    """Each stream's PCM by the JAX package's scalar decoder, which the
    plain reference and the stored MD5 must agree with."""
    out = []
    for data, n in zip(surround, LENGTHS):
        si, pcm = jax_native.decode_stream_scalar(data)
        info, ref = reference_decode(data)
        assert pcm.shape == (n, CHANNELS)
        assert (info["channels"], info["bps"], info["sample_rate"]) == \
            (CHANNELS, BPS, RATE)
        assert np.array_equal(ref, pcm)
        assert pcm_md5(pcm, BPS) == bytes(si.md5sum)
        out.append(pcm)
    return out


@pytest.fixture
def default_route(monkeypatch):
    """The default route: no ``CLAXON_TPU_SEGMENTATION`` and nothing
    cached, so ``"auto"`` decides."""
    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setattr(tp, "_SEG_AUTO", {})


def _frame_section_bytes(data):
    return len(data) - _read_metadata(data)[1]


def _frames(n):
    return -(-n // BLOCK)


def _assert_exact(surround, want, results):
    for data, pcm, dec in zip(surround, want, results):
        assert dec.pcm.shape == pcm.shape
        assert np.array_equal(dec.pcm, pcm)
        si = _read_metadata(data)[0]
        assert pcm_md5(dec.pcm, BPS) == bytes(si.md5sum)


def test_surround_streams_take_the_host_walk_exactly(surround, want,
                                                     default_route):
    """Both streams ride the host walk whole, in one run; ``"auto"``
    caches nothing for a batch the demux cannot take."""
    dd = ct.decode_streams_device(surround, device="cpu")
    assert not dd.seg_engaged and not dd.segmented
    assert tp._seg_auto("cpu")["choice"] is None
    names = {s[0] for s in dd.trace.spans}
    assert {"claxon.walk.extract", "claxon.walk.plan",
            "claxon.walk.dispatch"} <= names
    got = dd.sync().to_host()
    _assert_exact(surround, want, got)
    assert [g.frame_sizes[-1] for g in got] == [11500 - 2 * BLOCK, BLOCK]
    assert {(b[1], b[2].shape[1]) for b in dd.device_buckets()} == \
        {(CHANNELS, BLOCK)}


def test_walk_counters_count_the_batch(surround, default_route):
    dd = ct.decode_streams_device(surround, device="cpu")
    counters = dd.trace.counters
    assert {k: counters[k] for k in COUNTERS} == {
        "walk_streams": 2, "walk_units": 2, "walk_runs": 1,
        "walk_frames": sum(_frames(n) for n in LENGTHS),
        "walk_bytes": sum(_frame_section_bytes(d) for d in surround)}


def test_chunked_walk_keeps_the_pcm(surround, want, default_route,
                                    monkeypatch):
    """With ``MAX_BATCH_BYTES`` at most each stream's size and under two of
    its largest frames, every stream walks in chunks of one frame, each
    run of units below the limit is planned and uploaded apart (a plan
    span each), and the results merge back into one PCM a stream."""
    limit = min(2 * _read_metadata(d)[0].max_frame_size + 4
                for d in surround)
    assert limit <= min(map(len, surround))
    monkeypatch.setattr(tpb, "MAX_BATCH_BYTES", limit)
    dd = ct.decode_streams_device(surround, device="cpu")
    counters = dd.trace.counters
    frames = sum(_frames(n) for n in LENGTHS)
    assert counters["walk_streams"] == 2
    assert counters["walk_units"] == frames > counters["walk_streams"]
    plans = [sp for sp in dd.trace.spans if sp[0] == "claxon.walk.plan"]
    assert 1 < counters["walk_runs"] == len(plans) <= frames
    assert counters["walk_frames"] == frames
    assert counters["walk_bytes"] == sum(_frame_section_bytes(d)
                                         for d in surround)
    _assert_exact(surround, want, dd.sync().to_host())


def test_segmented_batch_counts_its_walked_stream(surround, want):
    """A 5.1 stream in a segmented batch goes to the host walk before the
    demux; its walk counters land in the batch's record, beside the
    segmented path's own."""
    stereo = encode_flac(synth_music(2000, channels=2, bps=16, seed=512),
                         44100, 16, block_size=1024)
    datas = [stereo, surround[1]]
    dd = ct.decode_streams_device(datas, segmentation="device", device="cpu")
    assert dd.segmented and dd.fallback_streams == [1]
    counters = dd.trace.counters
    assert counters["seg_streams"] == 1
    assert {k: counters[k] for k in COUNTERS} == {
        "walk_streams": 1, "walk_units": 1, "walk_runs": 1,
        "walk_frames": _frames(LENGTHS[1]),
        "walk_bytes": _frame_section_bytes(surround[1])}
    got = dd.sync().to_host()
    assert np.array_equal(got[0].pcm,
                          jax_native.decode_stream_scalar(stereo)[1])
    _assert_exact(surround[1:], want[1:], got[1:])
