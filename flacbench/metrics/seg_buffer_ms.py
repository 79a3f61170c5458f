"""Median per call of the program's span ``claxon.seg.buffer``: building
each group's zeroed word buffer from the streams' payloads on the host,
before its upload (``pipeline_seg.begin_segmented``)."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline_seg host stages"
MOVES = "rate_device"


def read(rec):
    vals = per_call(rec, lambda r: span_seconds(r, "claxon.seg.buffer"))
    return None if not vals else measure.median(vals) * 1e3
