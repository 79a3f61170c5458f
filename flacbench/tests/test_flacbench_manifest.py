"""BENCHMARK.json against the contract it is written to, the files it
names, and the harness taking in new cells, mixes and metrics as files
(CPU)."""

import ast
import json
import re

import pytest

from flacbench.harness import BENCH_DIR, ROOT, Bench, run_cell
from flacbench.tests.tiny import tiny_bench

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["flacbench"]
    assert MANIFEST["command"] == ["python3", "flacbench/run.py"]
    rs = MANIFEST["run_seconds"]
    assert 1 <= rs <= 51
    # A full check with 24 cells fits its time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_and_units():
    groups = (MANIFEST["configs"], MANIFEST["workloads"],
              MANIFEST["end_to_end"], MANIFEST["per_layer"])
    names = [x["name"] for g in groups for x in g]
    assert all(NAME.match(n) for n in names), names
    for g in groups:
        assert len({x["name"] for x in g}) == len(g)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


def test_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        cell = w["name"]
        e2e = [m for m in MANIFEST["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(_reports(m, cell) for m in MANIFEST["per_layer"])


def test_moves_names_what_each_of_its_cells_reports():
    for m in MANIFEST["per_layer"]:
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in
                                         MANIFEST["workloads"]]):
            assert _reports(moved, cell), (m["name"], cell)


def test_files_exist_and_agree():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.parent == BENCH_DIR / "configs"
        data = json.loads(path.read_text())
        assert data["source"] == c["source"] and len(c["source"]) <= 200
        assert data["reduced"] == c["reduced"]
        assert path.stem == c["name"]
    for w in MANIFEST["workloads"]:
        assert (BENCH_DIR / "configs" / f"{w['config']}.json").exists()
        assert (BENCH_DIR / "mixes" / f"{w['traffic']}.json").exists()
    bench = Bench()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        reader = bench.reader(m["name"])
        assert reader.UNIT == m["unit"] and reader.SOURCE == m["source"]
        if "layer" in m:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "claxon_tpu"}, path


def test_a_new_cell_mix_and_metric_are_found_without_an_edit(
        tmp_path, monkeypatch):
    bench = tiny_bench(tmp_path, monkeypatch, segmentation="host")
    (tmp_path / "mixes" / "tiny-new.json").write_text(json.dumps(
        {"entry": "device", "tracks_per_call": 1, "distinct_batches": 2,
         "why": "a new mix"}))
    (tmp_path / "metrics" / "calls_counted.py").write_text(
        'UNIT = "calls"\nSOURCE = "host_clock"\nLAYER = "pipeline entry"\n'
        'MOVES = "rate_device"\n\n\ndef read(rec):\n'
        '    return len(rec["calls"])\n')
    manifest = bench.manifest
    manifest["workloads"].append({"name": "tiny.new", "config": "tiny",
                                  "traffic": "tiny-new", "chips": 1,
                                  "why": "a new cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "rate_device":
            m["workloads"].append("tiny.new")
    manifest["per_layer"].append({
        "name": "calls_counted", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "pipeline entry",
        "moves": "rate_device", "workloads": ["tiny.new"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    bench = Bench(path, tmp_path)
    result, _ = run_cell(bench, "tiny.new", 7, 1.5, 1, device="cpu")
    assert result["correct"]
    assert result["metrics"]["calls_counted"]["value"] >= 1
    result, _ = run_cell(bench, "tiny.new", 8, 1.5, 0, device="cpu")
    assert set(result["metrics"]) == {"rate_device", "setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cells_resolve(cell):
    bench = Bench()
    w = bench.cell(cell)
    assert bench.config(w["config"])["name"] == w["config"]
    assert bench.mix(w["traffic"])["entry"] in ("device", "host")
