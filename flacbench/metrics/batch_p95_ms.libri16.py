"""The 95th percentile by nearest rank of the traced run's call
latencies in the LibriSpeech-format device cell (the benchmark's span
from the call to the return of ``sync()``; profiled, so longer than in
an untimed run). Runs spread too far for a bound (PERF.md §2)."""

from flacbench import measure

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline entry"
MOVES = "rate_device"


def read(rec):
    if rec["entry"] != "device" or not rec["calls"]:
        return None
    return measure.p95([c["done"] - c["start"] for c in rec["calls"]]) * 1e3
