"""The comparison that decides ``correct``: the program's PCM against the
plain reference's, sample for sample (the limit of every number is 0).

The reference decoded every frame of the pool when the pool was built
(``gen.pool``); a track is pool frames in a known order, renumbered, so
its PCM is theirs in that order (the tests decode whole assembled tracks
with the reference to show it). On the card the program's buckets are
read through ``device_buckets()`` and ``lane_plans()``, its only
description of where each frame's samples lie; a stream sample that no
run covers counts as uncovered, one that two runs cover as overlapping.
"""

import numpy as np

__all__ = ["expected", "compare_device", "compare_host"]


def expected(pool, track):
    """(samples, channels) int32 PCM of ``track`` by the reference."""
    ch = pool.config["channels"]
    return pool.pcm[track.order].reshape(-1, ch)


def _coverage(intervals, n):
    """(uncovered, overlapping) samples of [0, n) under ``intervals``."""
    covered = overlap = 0
    end = 0
    for a, b in sorted(intervals):
        a, b = max(a, 0), min(b, n)
        if b <= a:
            continue
        if a < end:
            overlap += min(b, end) - a
        covered += max(0, b - max(a, end))
        end = max(end, b)
    return n - covered, overlap


def compare_device(dd, batch, pool):
    """Counts of mismatched, uncovered and overlapping samples of a
    DeviceDecoded (or anything with ``device_buckets()`` and
    ``lane_plans()``) against the reference's PCM of ``batch``."""
    want = {}
    runs = {}
    mismatched = 0
    for (_fi, _n_ch, bucket), plan in zip(dd.device_buckets(),
                                          dd.lane_plans()):
        if isinstance(bucket, tuple):
            host = np.concatenate([b.cpu().numpy() for b in bucket])
        else:
            host = bucket.cpu().numpy()
        for si, out0, nf, bs, n_ch, lane0 in plan:
            if si not in want:
                want[si] = expected(pool, batch[si])
            ref = want[si]
            for ci in range(n_ch):
                got = host[lane0 + ci:lane0 + nf * n_ch:n_ch, :bs]
                exp = ref[out0:out0 + nf * bs, ci]
                if got.size != exp.size:
                    mismatched += abs(got.size - exp.size)
                    got = got.reshape(-1)[:exp.size]
                    exp = exp[:got.size]
                mismatched += int(np.count_nonzero(got.reshape(-1) != exp))
                runs.setdefault((si, ci), []).append((out0, out0 + nf * bs))
        del host
    uncovered = overlapping = 0
    ch = pool.config["channels"]
    for si, track in enumerate(batch):
        n = track.samples // ch
        for ci in range(ch):
            u, o = _coverage(runs.get((si, ci), []), n)
            uncovered += u
            overlapping += o
    return {"mismatched_samples": mismatched, "uncovered_samples": uncovered,
            "overlapping_samples": overlapping}


def compare_host(results, batch, pool):
    """The same counts for per-stream host PCM (``to_host()``'s results,
    each with ``pcm`` of shape (samples, channels))."""
    mismatched = uncovered = 0
    for si, track in enumerate(batch):
        ref = expected(pool, track)
        pcm = results[si].pcm if si < len(results) else np.zeros((0, 0))
        if pcm.shape != ref.shape:
            uncovered += max(0, ref.size - pcm.size)
            n = min(len(pcm), len(ref))
            pcm, ref = pcm[:n], ref[:n]
            if pcm.shape != ref.shape:
                mismatched += ref.size
                continue
        mismatched += int(np.count_nonzero(pcm != ref))
    return {"mismatched_samples": mismatched, "uncovered_samples": uncovered,
            "overlapping_samples": 0}
