"""Median per call of the program's span ``claxon.fetch.scatter``:
``to_host()``'s strided copies of each bucket's lanes into fresh
per-stream PCM."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline fetch"
MOVES = "rate_host"


def read(rec):
    vals = per_call(rec, lambda r: span_seconds(r, "claxon.fetch.scatter"))
    return None if not vals else measure.median(vals) * 1e3
