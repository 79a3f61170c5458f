"""A tiny bench directory for the tests: the real metric readers, one
small configuration and two mixes. On the CPU the tests send the cells'
calls to the host walk (the plain PyTorch forms run every kernel on the
CPU, slowly); the mixes themselves, like every cell's, take the default
route."""

import functools
import json
import shutil

from flacbench.harness import BENCH_DIR, Bench

TINY = {"source": "test", "sample_rate": 44100, "bits_per_sample": 16,
        "channels": 2, "block_size": 1024, "max_lpc_order": 8,
        "max_partition_order": 3, "track_seconds": [0.05, 0.1],
        "pool_frames": 8, "pool_segment_frames": 4, "pool_seed": 11,
        "reference": "reference/flac.py", "reduced": [], "assumed": []}


def tiny_bench(tmp_path, monkeypatch, segmentation=None):
    """A Bench over copies of the real manifest's metrics, with cells
    ``tiny.device`` and ``tiny.host``; pools are cached in tmp_path. A
    ``segmentation`` other than None is passed to every
    ``decode_streams_device`` call (the default route otherwise)."""
    import claxon_tpu_torch as ct
    from flacbench.gen import pool

    if segmentation is not None:
        monkeypatch.setattr(ct, "decode_streams_device", functools.partial(
            ct.decode_streams_device, segmentation=segmentation))
    monkeypatch.setattr(pool, "CACHE_DIR", tmp_path / "cache")
    shutil.copytree(BENCH_DIR / "metrics", tmp_path / "metrics")
    (tmp_path / "configs").mkdir()
    (tmp_path / "mixes").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for entry in ("device", "host"):
        (tmp_path / "mixes" / f"tiny-{entry}.json").write_text(json.dumps(
            {"entry": entry, "tracks_per_call": 2, "distinct_batches": 2,
             "why": "test"}))
    real = Bench().manifest
    cells = [{"name": f"tiny.{e}", "config": "tiny", "traffic": f"tiny-{e}",
              "chips": 1, "why": "test"} for e in ("device", "host")]
    manifest = dict(real, workloads=cells)
    for group in ("end_to_end", "per_layer"):
        manifest[group] = [dict(m, workloads=[
            "tiny." + ("host" if "host" in m["name"] or m["name"]
                       == "fetch_ms" else "device")])
            if "workloads" in m else m for m in real[group]]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return Bench(path, tmp_path)


# Faults planted under the timed path, each wrapping the program's
# ``decode_streams_device``.

def half_left_out(decode):
    """Half of each batch's streams are never decoded."""
    def broken(datas, *a, **kw):
        return decode(datas[:len(datas) // 2], *a, **kw)
    return broken


def answer_altered(decode, after=0):
    """One sample altered where it is produced, in every call after the
    first ``after``."""
    made = [0]

    def broken(datas, *a, **kw):
        dd = decode(datas, *a, **kw)
        made[0] += 1
        if made[0] > after:
            dd.dispatches[0].out_full[1, 5] += 1
        return dd
    return broken
