"""Many short mono speech-format streams through the port's segmented path
(claxon_tpu_torch.pipeline_seg, device="cpu", so every kernel takes its
plain form): 32 mono 16 kHz 16-bit streams of 0.3-2.0 s, as LibriSpeech
ships its utterances, each ending in a short last frame. The PCM is held
to the JAX package's scalar decoder and to the benchmark's plain
reference (``flacbench/reference/flac.py``) with tolerance 0; the batch's
counters ``seg_streams``, ``seg_frames`` and ``seg_fallback_streams`` and
its span ``claxon.seg.results`` are checked, and a batch of mono and
stereo streams makes one group of each. Each group's chained streams
share one zero-filled PCM allocation (``pipeline.zeroed_pcm``), one
disjoint view a stream; the counters ``seg_pcm_allocs`` and
``seg_pcm_bytes`` count them.

The segmented path's plain forms step through every sample position of
a 4096-sample block, so the speech batch is decoded once for the file.
"""

import gc
import weakref

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


MIXED_LENS = [1500, 2600, 3100, 4500]


def _short_stream(n, channels, seed, partition_order):
    return encode_flac(synth_music(n, channels=channels, bps=16, seed=seed,
                                   sample_rate=RATE),
                       RATE, 16, block_size=1024,
                       partition_order=partition_order)


@pytest.fixture(scope="module")
def mixed():
    """Four mono and four stereo 16 kHz streams in turn (block 1024, short
    last frames)."""
    return [_short_stream(n, ch, 40 + i, i + 1)
            for i, n in enumerate(MIXED_LENS) for ch in (1, 2)]


@pytest.fixture(scope="module")
def mixed_segmented(mixed):
    """The mixed batch through ``segmentation="device"``, not fetched."""
    tseg._REJECT_CACHE.clear()
    return ct.decode_streams_device(mixed, segmentation="device",
                                    device="cpu")


def _assert_scalar_and_jax(datas, results):
    for data, g in zip(datas, results):
        assert np.array_equal(g.pcm, native.decode_stream_scalar(data)[1])
        assert np.array_equal(g.pcm,
                              jax_native.decode_stream_scalar(data)[1])


def test_mono_and_stereo_make_two_groups(mixed):
    """Four mono and four stereo 16 kHz streams (block 1024, short last
    frames): one group of each channel count, and the batch's counters
    are the sums over both."""
    lens = MIXED_LENS
    datas = mixed
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


def test_chained_pcm_is_zeroed_disjoint_views_until_to_host(mixed,
                                                             mixed_segmented):
    """Before ``to_host()`` every chained stream's PCM is a zero int32
    C-contiguous (samples, channels) array of the scalar decoder's shape,
    sharing memory with no other stream's; ``to_host()`` fills those
    arrays, bit-exact."""
    dd = mixed_segmented
    assert dd.fallback_streams == []
    pcms = [r.pcm for r in dd.results]
    for data, pcm in zip(mixed, pcms):
        want = native.decode_stream_scalar(data)[1]
        assert type(pcm) is np.ndarray and pcm.dtype == np.int32
        assert pcm.flags.c_contiguous and pcm.shape == want.shape
        assert not pcm.any()
    for i, a in enumerate(pcms):
        for b in pcms[i + 1:]:
            assert not np.shares_memory(a, b)
    got = dd.to_host()
    assert all(g.pcm is pcm for g, pcm in zip(got, pcms))
    _assert_scalar_and_jax(mixed, got)


@pytest.mark.parametrize("batch", ["speech", "mixed"])
def test_pcm_allocation_counters(batch, speech, segmented, mixed,
                                 mixed_segmented):
    """``seg_pcm_allocs`` is the number of groups that chained a stream
    and ``seg_pcm_bytes`` the sum of samples x channels x 4."""
    if batch == "speech":
        datas, dd, groups = speech[0], segmented, 1
    else:
        datas, dd, groups = mixed, mixed_segmented, 2
    shapes = [native.decode_stream_scalar(d)[1].shape for d in datas]
    counters = dd.trace.counters
    assert counters["seg_pcm_allocs"] == groups
    assert counters["seg_pcm_bytes"] == sum(4 * n * ch for n, ch in shapes)


def test_kept_stream_outlives_its_batch(mixed):
    """A stream's PCM kept alone, its batch and the other results dropped
    and unrelated arrays allocated and filled, still holds its samples:
    the view keeps its group's allocation alive."""
    dd = ct.decode_streams_device(mixed, segmentation="device", device="cpu")
    gone = weakref.ref(dd)
    kept = dd.to_host()[5].pcm  # the third stream of the stereo group
    del dd
    gc.collect()
    assert gone() is None
    sizes = [len(native.decode_stream_scalar(d)[1]) * 2 for d in mixed]
    junk = [np.full(n, -0x5A5A5A5B, np.int32) for n in sizes * 4]
    assert np.array_equal(kept, native.decode_stream_scalar(mixed[5])[1])
    assert all((j == -0x5A5A5A5B).all() for j in junk)


def test_host_walked_stream_keeps_its_own_pcm():
    """A three-channel stream leaves for the host walk before the demux:
    the batch merges as before, that stream's PCM is an array of its own,
    the chained streams share their groups' allocations, and every stream
    is bit-exact with the host walk's frame times and sizes."""
    datas = [_short_stream(1500, 1, 60, 2), _short_stream(1200, 3, 61, 1),
             _short_stream(2600, 2, 62, 3), _short_stream(3100, 1, 63, 4)]
    dd = ct.decode_streams_device(datas, segmentation="device", device="cpu")
    assert dd.segmented and dd.fallback_streams == [1]
    counters = dd.trace.counters
    assert counters["seg_pcm_allocs"] == 2
    assert counters["seg_pcm_bytes"] == 4 * (1500 + 2600 * 2 + 3100)
    pcms = [r.pcm for r in dd.results]
    assert pcms[1].shape == (1200, 3) and pcms[1].flags.owndata
    assert not any(np.shares_memory(pcms[1], p)
                   for i, p in enumerate(pcms) if i != 1)
    got = dd.to_host()
    want = ct.decode_streams_device(datas, segmentation="host",
                                    device="cpu").to_host()
    for g, w in zip(got, want):
        assert np.array_equal(g.pcm, w.pcm)
        assert g.frame_times == w.frame_times
        assert g.frame_sizes == w.frame_sizes
    _assert_scalar_and_jax(datas, got)
