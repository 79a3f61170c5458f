"""The program's own spans and counters of each counted call.

``claxon_tpu_torch.trace.recent()`` keeps the records of the last batches
the process began; a call's record is the one whose root span
``claxon.decode`` started within the call (both on
``time.perf_counter``). A program without that module gives none, and
the metrics that read it report nothing.
"""

import bisect

__all__ = ["call_records", "per_call", "span_seconds"]

ROOT = "claxon.decode"


def _records():
    try:
        from claxon_tpu_torch import trace
    except ImportError:
        return []
    return trace.recent()


def call_records(rec):
    """[(call, record), ...] for each counted call of ``rec`` whose
    record the program kept."""
    roots = sorted((s[1], r) for r in _records() for s in r.spans
                   if s[0] == ROOT and s[3] is None)
    starts = [t for t, _r in roots]
    out = []
    for c in rec["calls"]:
        i = bisect.bisect_left(starts, c["start"] * 1e9)
        if i < len(roots) and roots[i][0] <= c["done"] * 1e9:
            out.append((c, roots[i][1]))
    return out


def span_seconds(record, name):
    """Seconds of every span ``name`` of ``record``, summed; None when it
    has none."""
    got = [e - s for n, s, e, _p, _b in record.spans if n == name]
    return sum(got) / 1e9 if got else None


def per_call(rec, value):
    """[value(record), ...] over the counted calls, leaving out None."""
    vals = [value(r) for _c, r in call_records(rec)]
    return [v for v in vals if v is not None]
