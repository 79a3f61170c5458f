"""Median per call of the program's counter ``upload_group_bytes`` (the
segmented path's group words) over the seconds of its span
``claxon.seg.upload``: the host-to-device rate of the group uploads, in
10^9 bytes a second."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "GB/s"
SOURCE = "program_counter"
LAYER = "pipeline_seg host stages"
MOVES = "rate_device"


def _rate(record):
    seconds = span_seconds(record, "claxon.seg.upload")
    nbytes = record.counters.get("upload_group_bytes")
    if not seconds or not nbytes:
        return None
    return nbytes / seconds / 1e9


def read(rec):
    vals = per_call(rec, _rate)
    return None if not vals else measure.median(vals)
