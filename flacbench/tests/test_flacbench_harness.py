"""Whole runs on the CPU, with the look for a card skipped: a sound run is
correct, and a run whose timed path is broken underneath is not, once
for each fault a cell can have, in early calls and in late ones only;
the control is not correct either; the result line and the process's
checks (CPU). The calls take the host walk here (``tiny_bench``), and
the planted faults also the segmented path, which every cell's default
route takes on the card; the card's test runs them on the default
route."""

import subprocess
import sys
import types

import pytest

import claxon_tpu_torch as ct
from flacbench import harness
from flacbench.control import control_counts
from flacbench.harness import ROOT, run_cell
from flacbench.tests.tiny import answer_altered, half_left_out, tiny_bench

CELLS = ["tiny.device", "tiny.host"]


@pytest.fixture
def bench(tmp_path, monkeypatch):
    return tiny_bench(tmp_path, monkeypatch, segmentation="host")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(bench, cell):
    result, compared = run_cell(bench, cell, 2**31 + 99, 1.5, 0,
                                device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert all(v == 0 for _k, v, _lim in compared)
    assert list(result)[-1] == "compared"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    e2e = {"tiny.device": {"rate_device", "setup_s"},
           "tiny.host": {"rate_host", "setup_s"}}[cell]
    assert set(result["metrics"]) == e2e
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
@pytest.mark.parametrize("segmentation", ["host", "device"],
                         ids=["host-walk", "segmented"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            segmentation, fault):
    bench = tiny_bench(tmp_path, monkeypatch, segmentation)
    monkeypatch.setattr(ct, "decode_streams_device",
                        fault(ct.decode_streams_device))
    # the segmented path's plain forms take seconds a call on the CPU
    seconds = 1.5 if segmentation == "host" else 5.0
    result, compared = run_cell(bench, cell, 2**31 + 98, seconds, 0,
                                device="cpu")
    assert not result["correct"]
    bad = {k for k, v, lim in compared if v > lim}
    assert bad == ({"uncovered_samples"} if fault is half_left_out
                   else {"mismatched_samples"})


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_late_calls_only_is_not_correct(bench, monkeypatch, cell):
    """Calls past the warm-up (one calibrating call and one a distinct
    batch) and the window's first two rounds, where the early checked
    calls lie, are altered: only the late checked calls can see it."""
    n_dist = bench.mix(bench.cell(cell)["traffic"])["distinct_batches"]
    monkeypatch.setattr(ct, "decode_streams_device", answer_altered(
        ct.decode_streams_device, after=1 + 3 * n_dist))
    result, compared = run_cell(bench, cell, 2**31 + 96, 1.5, 0,
                                device="cpu")
    assert not result["correct"]
    assert {k for k, v, lim in compared if v > lim} == {"mismatched_samples"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(bench, cell):
    counts = control_counts(bench, cell, 2**31 + 97, "cpu")
    assert counts["mismatched_samples"] > 1000
    assert counts["uncovered_samples"] == 0


def test_traced_run_reads_spans(bench):
    result, _ = run_cell(bench, "tiny.host", 5, 1.5, 1, device="cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"fetch_ms", "batch_p95_ms.host"}
    assert result["device"]["window_s"] > 0
    assert list(result)[-2:] == ["breakdown", "compared"]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert "claxon_tpu_torch" in sys.modules
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "flacbench/run.py", "--workload",
         "cd16-flac5.device", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout == ""
    assert "CUDA" in proc.stderr
