"""The 5.1 surround cell's readers (``walk_mbps``, ``walk_plan_ms``,
``walk_dispatch_ms``) on hand-made records matched to hand-made calls, a
record without the program's host-walk counters, the cell's
configuration and mix as the harness resolves them, and a tiny
six-channel pool: the plain reference decodes it to the encoded audio,
and a CPU decode of its tracks on the default route compares clean."""

import numpy as np
import pytest

from flacbench.gen import assemble, pool
from flacbench.gen.flacgen import synth_music
from flacbench.harness import Bench
from flacbench.reference import check
from flacbench.tests.test_flacbench_speech import (  # noqa: F401
    _calls, _read, _record, records)

CELL = "surround51-flac8.device"
WALK = ("walk_mbps", "walk_plan_ms", "walk_dispatch_ms")


def _walk(extract, plans, dispatches):
    """The host walk's spans: one extract, then a plan and a dispatch a
    run."""
    spans = [("claxon.walk.extract", 1, extract)]
    at = 1 + extract
    for plan, dispatch in zip(plans, dispatches):
        spans += [("claxon.walk.plan", at, plan),
                  ("claxon.walk.dispatch", at + plan, dispatch)]
        at += plan + dispatch
    return spans


def test_walk_readers_are_medians_per_call(records):
    """``walk_mbps``: walked bytes over the extract span, per call;
    ``walk_plan_ms`` and ``walk_dispatch_ms``: each call's spans summed
    over its runs."""
    records += [
        _record(5.0, _walk(400, (10, 20), (30, 30)), walk_bytes=400_000_000,
                walk_runs=2),                                    # 1000 MB/s
        _record(10.0, _walk(200, (15, 15, 20), (10, 10, 10)),
                walk_bytes=100_000_000, walk_runs=3),            # 500 MB/s
        _record(20.0, _walk(100, (40,), (5,)), walk_bytes=200_000_000,
                walk_runs=1),                                    # 2000 MB/s
        # A warm-up call's record, before the window: not read.
        _record(1.0, _walk(1, (900,), (900,)), walk_bytes=1, walk_runs=1)]
    rec = _calls(5.0, 10.0, 20.0)
    assert _read("walk_mbps", rec) == pytest.approx(1000.0)
    assert _read("walk_plan_ms", rec) == pytest.approx(40.0)
    assert _read("walk_dispatch_ms", rec) == pytest.approx(30.0)


def test_walk_readers_read_nothing_without_the_counters(records):
    """A program that does not count the walk (the spans alone), or a
    segmented call with no host walk in it, gives no value."""
    records += [_record(5.0, _walk(400, (10,), (30,))),
                _record(10.0, [("claxon.seg.chain", 1, 5)], seg_streams=4)]
    rec = _calls(5.0, 10.0)
    assert [_read(name, rec) for name in WALK] == [None] * 3
    records.append(_record(20.0, _walk(100, (40,), (5,)),
                           walk_bytes=50_000_000, walk_runs=1))
    # Only the counted call is read.
    assert [_read(name, _calls(5.0, 10.0, 20.0)) for name in WALK] == \
        pytest.approx([500.0, 40.0, 5.0])


def test_the_cell_resolves_to_six_channels_at_4_tracks_a_call():
    bench = Bench()
    cell = bench.cell(CELL)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    assert (config["sample_rate"], config["channels"],
            config["bits_per_sample"], config["block_size"],
            config["max_lpc_order"], config["max_partition_order"]) == \
        (96000, 6, 24, 4096, 12, 6)
    assert config["reduced"] == [] and cell["chips"] == 1
    assert mix["entry"] == "device" and mix["tracks_per_call"] == 4
    lengths = assemble.track_frames(config, 4 * mix["distinct_batches"])
    seconds = [f * 4096 / 96000 for f in lengths]
    assert 179 < min(seconds) and max(seconds) < 301
    per = [m["name"] for m in bench.metrics("per_layer", CELL)]
    assert set(per) == {"kernels_roofline_pct", "device_idle_pct", *WALK}
    assert [m["name"] for m in bench.metrics("end_to_end", CELL)] == \
        ["rate_device", "setup_s"]


@pytest.fixture(scope="module")
def tiny_surround():
    """The cell's configuration with a pool of 4 frames in 2 segments and
    tracks of 2-5 frames."""
    config = dict(Bench().config("surround51-flac8"), pool_frames=4,
                  pool_segment_frames=2, track_seconds=[0.1, 0.2])
    return pool.Pool(pool.build_pool(config, workers=1), config)


def test_tiny_pool_decodes_to_the_encoded_audio(tiny_surround):
    """``build_pool`` raises unless the reference's PCM is the audio; it
    is, channel for channel, at the configuration's widths."""
    config = tiny_surround.config
    bs = config["block_size"]
    audio = np.concatenate([
        synth_music(2 * bs, 6, 24, seed=config["pool_seed"] + i,
                    sample_rate=96000).reshape(2, bs, 6) for i in range(2)])
    assert tiny_surround.pcm.shape == (4, bs, 6)
    assert np.array_equal(tiny_surround.pcm, audio)
    # Channel assignment 0b0101 (six independent channels), 24 bits.
    assert all(p[3] >> 4 == 0b0101 for p in tiny_surround.prefix)


def test_tiny_surround_batch_compares_clean_on_the_cpu(tiny_surround,
                                                      monkeypatch):
    """Two tracks through ``decode_streams_device``'s default route on the
    CPU (the host walk) compare with 0 mismatched, uncovered and
    overlapping samples; a track left out does not."""
    import claxon_tpu_torch as ct
    import claxon_tpu_torch.pipeline as tp

    monkeypatch.delenv("CLAXON_TPU_SEGMENTATION", raising=False)
    monkeypatch.setattr(tp, "_SEG_AUTO", {})
    (batch,) = assemble.seed_batches(
        tiny_surround, {"distinct_batches": 1, "tracks_per_call": 2},
        2**31 + 26)
    dd = ct.decode_streams_device([t.data for t in batch], device="cpu")
    dd.sync()
    assert not dd.seg_engaged
    assert dd.trace.counters["walk_streams"] == 2
    assert check.compare_device(dd, batch, tiny_surround) == {
        "mismatched_samples": 0, "uncovered_samples": 0,
        "overlapping_samples": 0}
    short = ct.decode_streams_device([batch[0].data], device="cpu")
    got = check.compare_device(short, batch, tiny_surround)
    assert got["uncovered_samples"] == batch[1].samples
