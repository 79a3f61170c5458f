"""The readers of the LibriSpeech-format cell (``stream_host_us``,
``batch_p95_ms.libri16``) on hand-made records matched to hand-made
calls, a record without the program's ``seg_streams`` counter, and a
segmented decode of short mono streams on the CPU; the cell's
configuration and mix as the harness resolves them."""

import time

import pytest

from claxon_tpu_torch import trace
from flacbench import program
from flacbench.gen.assemble import track_frames
from flacbench.harness import Bench

MS = 1_000_000  # ns
CELL = "librispeech-16k.device"


def _record(t0, spans=(), **counters):
    """A batch record whose root ``claxon.decode`` starts at ``t0``
    seconds and lasts 1 s, with (name, start ms after t0, ms) children."""
    rec = trace.Trace()
    base = int(t0 * 1e9)
    rec.spans.append(("claxon.decode", base, base + 1000 * MS, None,
                      rec.batch))
    for name, at, ms in spans:
        rec.spans.append((name, base + at * MS, base + (at + ms) * MS,
                          "claxon.decode", rec.batch))
    rec.counters.update(counters)
    return rec


def _calls(*t0s):
    return {"entry": "device",
            "calls": [{"start": t - 0.001, "done": t + 1.5} for t in t0s]}


@pytest.fixture
def records(monkeypatch):
    kept = []
    monkeypatch.setattr(program, "_records", lambda: list(kept))
    return kept


def _read(name, rec):
    return Bench().reader(name).read(rec)


def _stages(metadata, chain, results):
    return [("claxon.seg.metadata", 1, metadata),
            ("claxon.seg.buffer", 100, 50),
            ("claxon.seg.chain", 200, chain),
            ("claxon.seg.results", 300, results)]


def test_stream_host_us_is_the_median_per_stream(records):
    """Per call: metadata + chain + results over ``seg_streams``, in us;
    the buffer and the other stages are not counted."""
    records += [
        _record(5.0, _stages(10, 20, 10), seg_streams=100),   # 400 us
        _record(10.0, _stages(30, 30, 40), seg_streams=200),  # 500 us
        _record(20.0, _stages(5, 5, 10), seg_streams=100),    # 200 us
        # A warm-up call's record, before the window: not read.
        _record(1.0, _stages(900, 900, 900), seg_streams=1)]
    assert _read("stream_host_us", _calls(5.0, 10.0, 20.0)) == \
        pytest.approx(400.0)


def test_stream_host_us_reads_nothing_without_the_counter(records):
    """A program that does not count ``seg_streams`` (or a batch that
    queued none on the demux, as on the host walk) gives no value."""
    records += [_record(5.0, _stages(10, 20, 10)),
                _record(10.0, _stages(10, 20, 10), seg_streams=0)]
    assert _read("stream_host_us", _calls(5.0, 10.0)) is None
    records.append(_record(20.0, [("claxon.seg.metadata", 1, 3)],
                           seg_streams=10))
    # Only the counted call's spans, a span missing counting 0.
    assert _read("stream_host_us", _calls(5.0, 10.0, 20.0)) == \
        pytest.approx(300.0)


def test_batch_p95_libri16_reads_the_call_latencies():
    calls = [{"start": 0.0, "done": d / 1e3} for d in range(1, 21)]
    assert _read("batch_p95_ms.libri16",
                 {"entry": "device", "calls": calls}) == pytest.approx(19.0)
    assert _read("batch_p95_ms.libri16", {"entry": "device",
                                          "calls": []}) is None
    assert _read("batch_p95_ms.libri16", {"entry": "host",
                                          "calls": calls}) is None


def test_stream_host_us_on_a_real_segmented_decode():
    """Short mono 16 kHz streams (block 1024) through the segmented path
    on the CPU, timed as the harness times a call."""
    import claxon_tpu_torch as ct
    from claxon_tpu_torch.testing import encode_flac, synth_music

    datas = [encode_flac(synth_music(n, channels=1, bps=16, seed=n,
                                     sample_rate=16000),
                         16000, 16, block_size=1024)
             for n in (1500, 2200, 3300)]
    calls = []
    for _ in range(2):
        start = time.perf_counter()
        dd = ct.decode_streams_device(datas, segmentation="device",
                                      device="cpu").sync()
        calls.append({"start": start, "done": time.perf_counter()})
        assert dd.trace.counters["seg_streams"] == 3
    rec = {"entry": "device", "calls": calls}
    assert len(program.call_records(rec)) == 2
    assert _read("stream_host_us", rec) > 0


def test_the_cell_resolves_to_mono_speech_at_256_a_call():
    bench = Bench()
    cell = bench.cell(CELL)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    assert (config["sample_rate"], config["channels"],
            config["bits_per_sample"]) == (16000, 1, 16)
    assert config["reduced"] == []
    assert mix["entry"] == "device" and mix["tracks_per_call"] == 256
    lengths = track_frames(config, 256 * mix["distinct_batches"])
    seconds = [f * config["block_size"] / 16000 for f in lengths]
    assert 12.0 < sum(seconds) / len(seconds) < 13.0
    per = [m["name"] for m in bench.metrics("per_layer", CELL)]
    assert {"stream_host_us", "batch_p95_ms.libri16", "seg_stages_ms",
            "kernels_roofline_pct", "device_idle_pct", "seg_buffer_ms",
            "upload_gbps"} == set(per)
    assert [m["name"] for m in bench.metrics("end_to_end", CELL)] == \
        ["rate_device", "setup_s"]
