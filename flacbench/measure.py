"""The benchmark's arithmetic, apart from anything it measures: window
rules, tails, unions of device intervals, idle gaps and their labels,
the least bytes of the decoded work, and the spread of a set of runs.
Times are seconds on one clock."""

import bisect
import math
import statistics

__all__ = ["HBM_BYTES_PER_S", "counted", "window_rate", "p95", "median",
           "merge", "union_seconds", "idle_gaps", "label_gaps",
           "least_bytes", "spread"]

#: H100 SXM device memory bandwidth, NVIDIA's data sheet (700 W).
HBM_BYTES_PER_S = 3.35e12


def counted(calls, t_end):
    """The calls of a closed loop that completed by ``t_end``: each call
    is a dict with ``start`` and ``done``. A call that straddles the end
    is not counted, nor is its time."""
    return [c for c in calls if c["done"] <= t_end]


def window_rate(calls, t_start, key="samples"):
    """Work of every counted call over the time from the window's start
    to the last completion; None when no call completed."""
    if not calls:
        return None
    span = max(c["done"] for c in calls) - t_start
    return sum(c[key] for c in calls) / span


def p95(values):
    """The 95th percentile by nearest rank over every value: the
    ceil(0.95 n)-th smallest."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def median(values):
    return statistics.median(values) if values else None


def merge(intervals, lo=-math.inf, hi=math.inf):
    """Intervals (start, end) clipped to [lo, hi] and merged, in order."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def union_seconds(intervals, lo=-math.inf, hi=math.inf):
    """Length of the union of intervals within [lo, hi]: time in which
    at least one of them ran, each instant counted once."""
    return sum(b - a for a, b in merge(intervals, lo, hi))


def idle_gaps(intervals, lo, hi):
    """The gaps in [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in merge(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps, spans, other="other"):
    """Seconds of idle gap by the host span open at each gap's midpoint
    (the innermost: the latest-starting one that holds it); ``spans`` are
    (name, start, end). Returns {label: seconds}."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s for _, s, _ in spans]
    longest = max((e - s for _, s, e in spans), default=0.0)
    out = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = other
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            name, s, e = spans[i]
            if s < mid - longest:
                break
            if e >= mid:
                label = name
                break
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def least_bytes(flac_bytes, samples):
    """The least device-memory traffic of decoding: the compressed bytes
    read once and the PCM written once as int32."""
    return flac_bytes + 4 * samples


def spread(values):
    """(Q3 - Q1) / median, with Python's quartiles."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
