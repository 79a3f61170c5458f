"""One run of one cell: set-up, warm-up, a closed-loop window, the check
against the plain reference, and the result line.

Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``mixes/<traffic>.json``,
and each metric's reader in ``metrics/<metric>.py``. The cells and the
metrics each one reports are listed in ``BENCHMARK.json`` at the root.
"""

import gc
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from . import measure
from .gen.assemble import seed_batches
from .gen.pool import load_pool
from .reference import check
from .trace import Spans, device_events, host_spans

__all__ = ["Bench", "run_cell", "card_line", "forbidden_modules"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: modules that must not be loaded in the process that prints a result,
#: by whole top-level name (the port's name begins with the JAX
#: package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "claxon_tpu")


def log(msg):
    print(f"[flacbench] {msg}", file=sys.stderr, flush=True)


class Bench:
    """The manifest and the files it names."""

    def __init__(self, manifest_path=ROOT / "BENCHMARK.json",
                 bench_dir=BENCH_DIR):
        self.manifest = json.loads(pathlib.Path(manifest_path).read_text())
        self.dir = pathlib.Path(bench_dir)

    def cell(self, name):
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind, name):
        data = json.loads((self.dir / kind / f"{name}.json").read_text())
        data["name"] = name
        return data

    def config(self, name):
        return self._json("configs", name)

    def mix(self, name):
        return self._json("mixes", name)

    def metrics(self, group, cell):
        """The entries of ``group`` ("end_to_end" or "per_layer") that
        ``cell`` reports."""
        return [m for m in self.manifest[group]
                if cell in m.get("workloads", [cell])]

    def reader(self, name):
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "flacbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(torch, device):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench, cell_name, seed, seconds, trace, device="cuda",
             t_process=None):
    """Run one cell once; returns the result dict (the last line) and the
    compared numbers [(name, value, limit), ...]."""
    if t_process is None:
        t_process = time.perf_counter()
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    entry = mix["entry"]
    if entry not in ("device", "host"):
        raise ValueError(f"unknown entry {entry!r}")

    import torch
    import claxon_tpu_torch as ct

    t_imports = time.perf_counter()
    pool, built = load_pool(config, log=log)
    if built:
        log(f"pool built in {built:.3f} s (encoding and the reference's "
            f"decode of every frame; not counted in setup_s)")
    log(f"pool: longest Rice code {int(pool.longest_code.max())} bits with "
        f"its partition's parameter field (K7 walks codes of up to 32)")
    t_pool = time.perf_counter()
    batches = seed_batches(pool, mix, seed)
    t_tracks = time.perf_counter()
    datas = [[t.data for t in b] for b in batches]
    n_dist = len(batches)
    log(f"{cell_name}: {n_dist} distinct batches of {len(batches[0])} "
        f"tracks; MB {[round(sum(map(len, d)) / 1e6, 3) for d in datas]}; "
        f"samples {[sum(t.samples for t in b) for b in batches]}")

    def call(i, spans):
        b = datas[i % n_dist]
        with spans.span("decode"):
            dd = ct.decode_streams_device(b, device=device)
        if entry == "device":
            with spans.span("sync"):
                dd.sync()
            return dd
        if spans.profiling:
            with spans.span("sync"):
                dd.sync()
            with spans.span("fetch"):
                return dd, dd.to_host()
        return dd, dd.to_host()

    # ---- warm-up: the default route calibrates on the first batch; then
    # every distinct batch once, as the window will run it.
    quiet = Spans(False)
    t_w = time.perf_counter()
    call(0, quiet)
    choice = ct.pipeline._seg_auto(device)
    log(f"route after calibration: {choice}")
    for i in range(n_dist):
        out = call(i, quiet)
        dd = out if entry == "device" else out[0]
        log(f"batch {i}: segmented={dd.segmented} "
            f"fallback_streams={dd.fallback_streams} "
            f"upload_bytes={dd.upload_bytes} buckets="
            f"{[tuple(b[2].shape) for b in dd.device_buckets()]}")
        del out, dd
    _sync(torch, device)
    log(f"set-up: to imports {t_imports - t_process:.3f} s, pool "
        f"{t_pool - t_imports:.3f} s, tracks {t_tracks - t_pool:.3f} s, "
        f"warm-up {time.perf_counter() - t_w:.3f} s")

    # ---- the window: a closed loop over the distinct batches. Each
    # distinct batch has two calls whose results are kept for the check:
    # an early one, drawn from the seed among its first two, and a late
    # one, its first call that starts after a share of the window drawn
    # from the seed between 0.75 and 0.95 (the loop runs on past the
    # window until every late call is made).
    rng = np.random.default_rng([seed, 1])
    keep = {d + n_dist * int(rng.integers(2)) for d in range(n_dist)}
    late_at = 0.75 + 0.2 * rng.random(n_dist)
    spans = Spans(bool(trace))
    if trace:
        spans.wrap_program()
    kept, calls, failed = {}, [], []
    prof = None
    gc.collect()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t_process - built
    t_start = time.perf_counter()
    t_end = t_start + seconds
    late_from = t_start + seconds * late_at
    late = {}
    i = 0
    try:
        while (time.perf_counter() < t_end or i <= max(keep)
               or len(late) < n_dist):
            rec = {"spans": {}}
            spans.current = rec["spans"]
            start = time.perf_counter()
            try:
                with spans.span("batch"):
                    out = call(i, spans)
            except ct.Error as e:
                failed.append({"index": i, "error": repr(e),
                               "start": start, "done": time.perf_counter()})
                if i % n_dist not in late and start >= late_from[i % n_dist]:
                    late[i % n_dist] = i
                i += 1
                continue
            done = time.perf_counter()
            b = batches[i % n_dist]
            dd = out if entry == "device" else out[0]
            rec.update(index=i, start=start, done=done,
                       samples=sum(t.samples for t in b),
                       flac_bytes=sum(len(t.data) for t in b),
                       stage_seconds=dict(dd.stage_seconds))
            calls.append(rec)
            d = i % n_dist
            if i in keep:
                kept[i] = out if entry == "device" else out[1]
            elif d not in late and start >= late_from[d]:
                late[d] = i
                kept[i] = out if entry == "device" else out[1]
            del out, dd
            i += 1
    finally:
        spans.current = None
        spans.restore()
        if prof is not None:
            prof.__exit__(None, None, None)
    window_calls = measure.counted(calls, t_end)
    attempted = sum(1 for c in calls + failed if c["start"] < t_end)
    log(f"window: {len(window_calls)} calls counted of {attempted} "
        f"started, {len(failed)} failed, {i} made; checked calls "
        f"{sorted(kept)}")
    for d in range(n_dist):
        mine = [c for c in window_calls if c["index"] % n_dist == d]
        ms = sorted((c["done"] - c["start"]) * 1e3 for c in mine)
        if ms:
            log(f"batch {d} calls {len(ms)}: ms least {ms[0]:.3f}, median "
                f"{measure.median(ms):.3f}, p95 {measure.p95(ms):.3f}, "
                f"most {ms[-1]:.3f}")

    info = _device_info(torch, device)
    rec = {"entry": entry, "calls": window_calls, "t_start": t_start,
           "setup_s": setup_s, "window_s": None}
    if trace:
        rec.update(_read_trace(prof, window_calls))
        info["busy_s"] = rec["busy_s"]
        info["window_s"] = rec["window_s"]
    del prof

    # ---- the check, after the peak was read: every distinct batch's
    # kept result against the plain reference.
    t_c = time.perf_counter()
    counts = {"mismatched_samples": 0, "uncovered_samples": 0,
              "overlapping_samples": 0, "failed_calls": len(failed),
              "unchecked_calls": 2 * n_dist}
    for i, out in sorted(kept.items()):
        batch = batches[i % n_dist]
        if entry == "device":
            got = check.compare_device(out, batch, pool)
        else:
            got = check.compare_host(out, batch, pool)
        for k, v in got.items():
            counts[k] += v
        counts["unchecked_calls"] -= 1
        kept[i] = None
    kept.clear()
    gc.collect()
    log(f"check against the reference {time.perf_counter() - t_c:.3f} s")
    _log_first_touch()
    compared = [(k, v, 0) for k, v in counts.items()]
    correct = all(v <= lim for _k, v, lim in compared)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(group, cell_name):
        value = bench.reader(m["name"]).read(rec)
        if value is None:
            if group == "end_to_end":
                raise RuntimeError(f"{m['name']} read nothing in "
                                   f"{cell_name}")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted,
              "failed": len(failed), "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = rec["breakdown"]
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, v, lim in compared}
    return result, compared


def _log_first_touch(mib=256, reps=3):
    """After the window: the speed of writing fresh memory, whose every
    page faults on first touch, against rewriting the same memory. The
    program writes fresh arrays of this size every call, and on the
    card's host ``getrusage`` counts no page faults, so this is the
    reading of what they cost in this process."""
    n = mib << 20
    fresh = []
    for _ in range(reps):
        t = time.perf_counter()
        a = np.ones(n, np.uint8)
        fresh.append(time.perf_counter() - t)
        del a
    a = np.ones(n, np.uint8)
    t = time.perf_counter()
    a.fill(2)
    again = time.perf_counter() - t
    del a
    log(f"first touch of {mib} MiB: GB/s fresh "
        f"{[round(n / s / 1e9, 3) for s in fresh]}, rewritten "
        f"{n / again / 1e9:.3f}")


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _read_trace(prof, window_calls):
    """The device's busy time, kernel time, idle gaps by host span and
    top operations over the traced window: from the first counted call's
    start to the last one's end, on the profiler's clock."""
    spans = host_spans(prof)
    batch_spans = sorted((s for s in spans if s[0] == "batch"),
                         key=lambda s: s[1])
    if not window_calls:
        raise RuntimeError("no call completed in the window")
    lo = batch_spans[0][1]
    hi = batch_spans[len(window_calls) - 1][2]
    dev = device_events(prof)
    all_iv = [(a, b) for _n, _k, a, b in dev]
    kern_iv = [(a, b) for _n, k, a, b in dev if k == "kernel"]
    busy = measure.union_seconds(all_iv, lo, hi)
    by_name = {}
    for name, _k, a, b in dev:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps = measure.idle_gaps(all_iv, lo, hi)
    by_label = measure.label_gaps(
        gaps, [s for s in spans if s[0] != "batch" and s[2] > lo
               and s[1] < hi])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    log(f"trace: window {hi - lo:.6f} s, busy {busy:.6f} s, "
        f"{len(dev)} device operations, {len(gaps)} idle gaps")
    return {"window_s": hi - lo, "busy_s": busy,
            "kernel_s": measure.union_seconds(kern_iv, lo, hi),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}
