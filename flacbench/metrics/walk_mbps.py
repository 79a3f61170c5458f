"""Median per call of the program's counter ``walk_bytes`` (the
frame-section bytes the C++ core walked on the host-walk path) over the
seconds of its span ``claxon.walk.extract``: the host walk's rate, in
10^6 bytes a second. A record without that counter reads nothing."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "MB/s"
SOURCE = "program_counter"
LAYER = "pipeline host walk"
MOVES = "rate_device"


def _rate(record):
    seconds = span_seconds(record, "claxon.walk.extract")
    nbytes = record.counters.get("walk_bytes")
    if not seconds or not nbytes:
        return None
    return nbytes / seconds / 1e6


def read(rec):
    vals = per_call(rec, _rate)
    return None if not vals else measure.median(vals)
