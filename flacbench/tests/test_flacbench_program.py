"""The readers of the program's own spans and counters
(``flacbench/program.py``, ``seg_buffer_ms``, ``upload_gbps``,
``fetch_wait_ms``, ``fetch_scatter_ms``): hand-made records matched to
hand-made calls, a program without the tracer, a segmented decode, and
a traced run of the tiny host cell (CPU)."""

import json
import sys

import pytest

from claxon_tpu_torch import trace
from flacbench import program
from flacbench.harness import Bench, run_cell
from flacbench.tests.tiny import tiny_bench

NEW = ("seg_buffer_ms", "upload_gbps", "fetch_wait_ms", "fetch_scatter_ms")
MS = 1_000_000  # ns


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
    return {"calls": [{"start": t - 0.001, "done": t + 1.5} for t in t0s]}


@pytest.fixture
def records(monkeypatch):
    kept = []
    monkeypatch.setattr(program, "_records", lambda: list(kept))
    return kept


def _read(name, rec):
    return Bench().reader(name).read(rec)


def test_each_reader_takes_the_median_over_the_counted_calls(records):
    records += [
        _record(5.0, [("claxon.seg.buffer", 1, 4), ("claxon.seg.upload", 5,
                                                     10)],
                upload_group_bytes=10_000_000),
        _record(10.0, [("claxon.seg.buffer", 1, 2), ("claxon.seg.buffer",
                                                      4, 1),
                       ("claxon.seg.upload", 5, 20)],
                upload_group_bytes=10_000_000),
        _record(20.0, [("claxon.seg.buffer", 1, 7), ("claxon.seg.upload", 9,
                                                     5)],
                upload_group_bytes=20_000_000),
        # A warm-up call's record, before the window: not read.
        _record(1.0, [("claxon.seg.buffer", 1, 500)],
                upload_group_bytes=1)]
    rec = _calls(5.0, 10.0, 20.0)
    assert _read("seg_buffer_ms", rec) == pytest.approx(4.0)
    # 1.0, 0.5 and 4.0 GB/s
    assert _read("upload_gbps", rec) == pytest.approx(1.0)
    assert _read("fetch_wait_ms", rec) is None
    records[:] = [_record(t, [("claxon.fetch.wait", 2, ms),
                              ("claxon.fetch.scatter", 3, 10 * ms)])
                  for t, ms in ((5.0, 3), (10.0, 1), (20.0, 2))]
    assert _read("fetch_wait_ms", rec) == pytest.approx(2.0)
    assert _read("fetch_scatter_ms", rec) == pytest.approx(20.0)
    assert _read("seg_buffer_ms", rec) is None
    assert _read("upload_gbps", rec) is None


def test_a_call_without_its_record_is_left_out(records):
    records.append(_record(10.0, [("claxon.fetch.wait", 2, 3)]))
    rec = _calls(5.0, 10.0)
    assert [c["start"] for c, _r in program.call_records(rec)] == \
        [10.0 - 0.001]
    assert _read("fetch_wait_ms", rec) == pytest.approx(3.0)


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    import claxon_tpu_torch

    monkeypatch.delattr(claxon_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "claxon_tpu_torch.trace", None)
    assert program._records() == []
    for name in NEW:
        assert _read(name, _calls(5.0)) is None


def test_the_segmented_readers_on_a_real_decode():
    """A segmented decode on the CPU, timed as the harness times a call."""
    import time

    import claxon_tpu_torch as ct
    from claxon_tpu_torch.testing import encode_flac, synth_music

    datas = [encode_flac(synth_music(700, channels=2, bps=16, seed=s),
                         44100, 16, block_size=256) for s in (1, 2)]
    calls = []
    for _ in range(3):
        start = time.perf_counter()
        ct.decode_streams_device(datas, segmentation="device",
                                 device="cpu").sync()
        calls.append({"start": start, "done": time.perf_counter()})
    rec = {"calls": calls}
    assert len(program.call_records(rec)) == 3
    assert _read("seg_buffer_ms", rec) > 0
    assert _read("upload_gbps", rec) > 0
    assert _read("fetch_wait_ms", rec) is None


def test_a_traced_run_reports_the_host_cells_metrics(tmp_path, monkeypatch):
    bench = tiny_bench(tmp_path, monkeypatch, "host")
    manifest = bench.manifest
    for m in manifest["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = ["tiny.device", "tiny.host"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    bench = Bench(path, tmp_path)
    result, _ = run_cell(bench, "tiny.host", 2**31 + 95, 1.5, 1,
                         device="cpu")
    assert result["correct"]
    read = {"fetch_wait_ms", "fetch_scatter_ms"}
    assert set(result["metrics"]) & set(NEW) == read
    assert all(result["metrics"][m]["value"] > 0 for m in read)
