"""Median per call of the program's span ``claxon.walk.plan``, summed
over the call's runs (``pipeline_bits.plan_raw_bits``: the numpy
planning of the walked units into buckets and uploads). A record without
the host walk's counter ``walk_runs`` reads nothing."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline host walk"
MOVES = "rate_device"


def _ms(record):
    if not record.counters.get("walk_runs"):
        return None
    seconds = span_seconds(record, "claxon.walk.plan")
    return None if seconds is None else seconds * 1e3


def read(rec):
    vals = per_call(rec, _ms)
    return None if not vals else measure.median(vals)
