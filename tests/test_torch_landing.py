"""The to-host landing on the CPU: ``interleave_runs``' plain form and
the arena's assembly (``pipeline.land_buckets``: offsets, run table,
views) held to ``DeviceDecoded.to_host()``'s host scatter on the same
buckets and lane plans, zeros included where no run lands. On a CUDA
device ``start_fetch()`` lands through the same functions with the
kernel (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import claxon_tpu_torch as ct
from claxon_tpu_torch import pipeline as tp
from claxon_tpu_torch.ops import epilogue
from claxon_tpu_torch.testing import encode_flac, synth_music
from claxon_tpu_torch.testing.interleave_cases import (CASE_SEEDS,
                                                       headline_case,
                                                       plan_case)


def _decoded(buckets, plans, shapes):
    """A DeviceDecoded of CPU buckets with the case's lane plans."""
    pcms = [np.zeros(s, np.int32) for s in shapes]
    results = [tp.DecodedStream(None, p, [], []) for p in pcms]
    dispatches = [tp._BucketDispatch(plan[0][4], torch.from_numpy(b))
                  for b, plan in zip(buckets, plans)]
    return tp.DeviceDecoded(results, dispatches, plans, pcms)


def _landed(dd):
    """Each stream's PCM through land_buckets and arena_views."""
    arena, offsets = tp.land_buckets([d.out_full for d in dd.dispatches],
                                     dd._plans, dd._pcms)
    assert all(o % 4 == 0 for o in offsets)
    return tp.arena_views(arena.numpy(), offsets, dd._pcms)


def _covered(plans, shapes):
    """Per stream, a mask of the PCM rows some run writes."""
    masks = [np.zeros(n, bool) for n, _ch in shapes]
    for plan in plans:
        for si, out0, nf, bs, _nch, _lane0 in plan:
            masks[si][out0:out0 + nf * bs] = True
    return masks


@pytest.mark.parametrize("seed", CASE_SEEDS)
def test_interleave_plain_matches_the_host_scatter(seed):
    """Random plans (mono, stereo and six channels; tail frames; several
    streams and buckets, each stream's runs spread over buckets with
    shifted out0; padding lanes of garbage between runs; frames that land
    nowhere): the landed views equal to_host()'s scatter, C-contiguous,
    and zero wherever no run lands."""
    buckets, plans, shapes = plan_case(seed)
    dd = _decoded(buckets, plans, shapes)
    views = _landed(dd)
    out = dd.to_host()
    assert len(views) == len(out) == len(shapes)
    for view, res, mask in zip(views, out, _covered(plans, shapes)):
        assert view.flags.c_contiguous and view.dtype == np.int32
        assert np.array_equal(view, res.pcm)
        assert not view[~mask].any()


def test_interleave_plain_reads_no_padding_lane():
    """Every lane and sample that no run names can hold anything: the
    landed PCM does not change when they do."""
    buckets, plans, shapes = plan_case(5)
    first = _landed(_decoded(buckets, plans, shapes))
    for b, plan in zip(buckets, plans):
        used = np.zeros(b.shape, bool)
        for _si, _o, nf, bs, nch, lane0 in plan:
            used[lane0:lane0 + nf * nch, :bs] = True
        b[~used] = np.int32(-7)
    again = _landed(_decoded(buckets, plans, shapes))
    assert all(np.array_equal(a, b) for a, b in zip(first, again))


def test_interleave_plain_at_a_decode_shape():
    """One bucket as a mono batch of four streams lays it out: the plain
    form equals the scatter."""
    buckets, plans, shapes = headline_case(4, 6, 1152, 1, T=1152)
    dd = _decoded(buckets, plans, shapes)
    views = _landed(dd)
    assert all(np.array_equal(v, r.pcm) for v, r in zip(views,
                                                        dd.to_host()))


def test_interleave_runs_refuses_a_run_outside():
    bucket = torch.zeros((8, 64), dtype=torch.int32)
    arena = torch.zeros(1000, dtype=torch.int32)
    for run in [(0, 2, 64, 2, 5),      # lanes 5..8 of 8
                (0, 1, 65, 1, 0),      # 65 samples of 64
                (990, 1, 64, 1, 0),    # past the arena
                (0, 1, 64, 0, 0),      # no channel
                (-1, 1, 4, 1, 0)]:
        with pytest.raises(ValueError, match="outside"):
            epilogue.interleave_runs(bucket, [run], arena)
    epilogue.interleave_runs(bucket, np.zeros((0, 5), np.int64), arena)
    assert epilogue.interleave_runs.launches == 0


def _streams():
    pcm = synth_music(6000, channels=2, bps=16, seed=11)
    return [encode_flac(pcm, 44100, 16, block_size=576),
            encode_flac(pcm[:2500, :1], 16000, 16, block_size=1152),
            encode_flac(pcm[:3100], 44100, 16, block_size=1024)]


@pytest.mark.parametrize("route", ["host", "framedesc", "raw", "merged"])
def test_landing_matches_to_host_on_decoded_batches(route, monkeypatch):
    """Decoded batches of three streams on the CPU (the host walk, the
    FrameDesc route, the sample-shipping route, and a merge of two
    chunks of one stream with a second stream): the landed PCM equals
    to_host()'s, which equals the scalar decoder's."""
    from claxon_tpu_torch import native

    datas = _streams()
    if route == "raw":
        monkeypatch.setenv("CLAXON_TPU_NO_BITS", "1")
    if route == "merged":
        import claxon_tpu_torch.pipeline_bits as tbits

        monkeypatch.setattr(tbits, "MAX_BATCH_BYTES", len(datas[0]) // 2)
    dd = ct.decode_streams_device(datas, route != "framedesc",
                                  segmentation="host", device="cpu")
    views = _landed(dd)
    out = dd.to_host()
    assert dd.trace.counters["fetch_landed_buckets"] == 0
    assert dd.trace.counters["fetch_scattered_buckets"] == \
        len(dd.dispatches)
    for data, view, res in zip(datas, views, out):
        want = native.decode_stream_scalar(data)[1]
        assert np.array_equal(res.pcm, want)
        assert np.array_equal(view, want)


def test_a_second_to_host_gives_the_same_arrays():
    dd = ct.decode_streams_device(_streams()[:2], segmentation="host",
                                  device="cpu")
    first = [r.pcm for r in dd.to_host()]
    spans = len(dd.trace.spans)
    assert all(a is r.pcm for a, r in zip(first, dd.to_host()))
    assert len(dd.trace.spans) == spans + 3
