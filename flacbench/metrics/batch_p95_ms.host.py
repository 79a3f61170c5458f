"""The 95th percentile by nearest rank of the traced run's call
latencies in the to-host cell (the benchmark's span from the call to the
return of ``to_host()``; profiled, and ``sync()`` is called apart).
Runs spread too far for a bound (PERF.md §2)."""

from flacbench import measure

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline entry"
MOVES = "rate_host"


def read(rec):
    if rec["entry"] != "host" or not rec["calls"]:
        return None
    return measure.p95([c["done"] - c["start"] for c in rec["calls"]]) * 1e3
