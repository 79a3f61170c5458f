"""Many short mono speech-format streams through the port's segmented path
(claxon_tpu_torch.pipeline_seg, device="cpu", so every kernel takes its
plain form): 32 mono 16 kHz 16-bit streams of 0.3-2.0 s, as LibriSpeech
ships its utterances, each ending in a short last frame. The PCM is held
to the JAX package's scalar decoder and to the benchmark's plain
reference (``flacbench/reference/flac.py``) with tolerance 0; the batch's
counters ``seg_streams``, ``seg_frames`` and ``seg_fallback_streams`` and
its span ``claxon.seg.results`` are checked, and a batch of mono and
stereo streams makes one group of each.

The segmented path's plain forms step through every sample position of
a 4096-sample block, so the speech batch is decoded once for the file.
"""

import numpy as np
import pytest

from claxon_tpu import native as jax_native

import claxon_tpu_torch as ct
import claxon_tpu_torch.pipeline as tp
import claxon_tpu_torch.pipeline_seg as tseg
from claxon_tpu_torch import native
from claxon_tpu_torch.testing import encode_flac, synth_music
from flacbench.reference.flac import decode_stream as reference_decode

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native core not built")

RATE = 16000
BLOCK = 4096
N_STREAMS = 32
STAGES = ["metadata", "buffer", "upload", "demux_queue", "between",
          "summary", "chain", "plan_dispatch"]


def _frames(n, block):
    return -(-n // block)


def _speech_lengths():
    """Sample counts on an even grid over 0.3-2.0 s, none a multiple of
    the block, so every stream ends in a short frame."""
    lens = [int(round(s * RATE)) for s in np.linspace(0.3, 2.0, N_STREAMS)]
    return [n + 1 if n % BLOCK == 0 else n for n in lens]


@pytest.fixture(scope="module")
def speech():
    """(streams, sample counts): block 4096, LPC order 8, partition orders
    0-5 in turn (the encoder lowers one a short frame cannot split)."""
    lens = _speech_lengths()
    datas = [encode_flac(synth_music(n, channels=1, bps=16, seed=1600 + i,
                                     sample_rate=RATE),
                         RATE, 16, block_size=BLOCK, max_lpc_order=8,
                         partition_order=i % 6)
             for i, n in enumerate(lens)]
    return datas, lens


@pytest.fixture(scope="module")
def want(speech):
    """Each stream's PCM by the JAX package's scalar decoder, which the
    plain reference must give too."""
    datas, lens = speech
    out = []
    for data, n in zip(datas, lens):
        _si, pcm = jax_native.decode_stream_scalar(data)
        info, ref = reference_decode(data)
        assert pcm.shape == (n, 1) and info["channels"] == 1
        assert info["sample_rate"] == RATE
        assert np.array_equal(ref, pcm)
        out.append(pcm)
    return out


@pytest.fixture(scope="module")
def segmented(speech):
    """The speech batch through ``segmentation="device"``, once."""
    tseg._REJECT_CACHE.clear()
    return ct.decode_streams_device(speech[0], segmentation="device",
                                    device="cpu")


@pytest.fixture(autouse=True)
def _clear_port_reject_cache():
    tseg._REJECT_CACHE.clear()
    yield
    tseg._REJECT_CACHE.clear()


@pytest.mark.parametrize("route", ["device", "auto"])
def test_speech_streams_decode_exactly(route, speech, want, segmented,
                                       monkeypatch):
    """Both routes ride the segmented path with no stream on the host
    walk. On the CPU ``"auto"`` would time the plain forms (about 15 s,
    and the host walk wins there); it is given the choice the card's
    calibration makes, so the default entry's own dispatch is what runs."""
    datas, lens = speech
    if route == "device":
        dd = segmented
    else:
        monkeypatch.setitem(tp._SEG_AUTO, "cpu", {"choice": "device"})
        dd = ct.decode_streams_device(datas, segmentation="auto",
                                      device="cpu")
    assert dd.segmented
    assert dd.fallback_streams == []
    got = dd.to_host()
    assert len(got) == len(datas)
    for g, w, n in zip(got, want, lens):
        assert np.array_equal(g.pcm, w)
        assert g.frame_sizes[-1] == n % BLOCK
        assert g.streaminfo.sample_rate == RATE
        assert g.streaminfo.channels == 1


def test_speech_counters(speech, segmented):
    _datas, lens = speech
    counters = segmented.trace.counters
    assert counters["seg_streams"] == N_STREAMS
    assert counters["seg_frames"] == sum(_frames(n, BLOCK) for n in lens)
    assert counters["seg_fallback_streams"] == 0


def test_results_span_lies_inside_plan_dispatch(segmented):
    """``claxon.seg.results`` is a span of its own inside the
    ``plan_dispatch`` stage, not a stage: ``stage_seconds`` keeps its
    keys and sums."""
    rec = segmented.trace
    plan, = [s for s in rec.spans if s[0] == "claxon.seg.plan_dispatch"]
    res, = [s for s in rec.spans if s[0] == "claxon.seg.results"]
    assert res[3] == "claxon.seg.plan_dispatch"
    assert plan[1] <= res[1] <= res[2] <= plan[2]
    assert list(segmented.stage_seconds) == STAGES
    assert segmented.stage_seconds["plan_dispatch"] == \
        (plan[2] - plan[1]) / 1e9


def test_mono_and_stereo_make_two_groups():
    """Four mono and four stereo 16 kHz streams (block 1024, short last
    frames): one group of each channel count, and the batch's counters
    are the sums over both."""
    lens = [1500, 2600, 3100, 4500]
    datas = []
    for i, n in enumerate(lens):
        for ch in (1, 2):
            datas.append(encode_flac(
                synth_music(n, channels=ch, bps=16, seed=40 + i,
                            sample_rate=RATE),
                RATE, 16, block_size=1024, partition_order=i + 1))
    pend = tseg.begin_segmented(datas, device="cpu")
    groups = {nch: list(g) for _T, nch, g, *_rest in pend.groups}
    assert sorted(groups) == [1, 2]
    assert groups[1] == [0, 2, 4, 6] and groups[2] == [1, 3, 5, 7]
    dd = tseg.finish_segmented(pend)
    assert dd.fallback_streams == []
    counters = dd.trace.counters
    assert counters["seg_streams"] == len(groups[1]) + len(groups[2])
    assert counters["seg_frames"] == 2 * sum(_frames(n, 1024) for n in lens)
    assert counters["seg_fallback_streams"] == 0
    assert [s[0] for s in dd.trace.spans].count("claxon.seg.results") == 2
    for data, g in zip(datas, dd.to_host()):
        assert np.array_equal(g.pcm, jax_native.decode_stream_scalar(data)[1])
