"""Median per call of the span around ``to_host()`` after ``sync()``
returned: K3b pack, the copy into pinned memory and the strided scatter
into per-stream PCM."""

from flacbench import measure

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline fetch"
MOVES = "rate_host"


def read(rec):
    vals = [c["spans"]["fetch"] for c in rec["calls"]
            if "fetch" in c["spans"]]
    return None if not vals else measure.median(vals) * 1e3
