"""Median per call of the segmented path's per-stream host work, in
microseconds a stream: the seconds of the program's spans
``claxon.seg.metadata`` (each stream's metadata and payload view),
``claxon.seg.chain`` (each stream's frame chain) and
``claxon.seg.results`` (each stream's PCM array and result) over its
counter ``seg_streams``, the streams queued on the device demux. A
record without that counter reads nothing."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "us"
SOURCE = "program_span"
LAYER = "pipeline_seg host stages"
MOVES = "rate_device"

SPANS = ("claxon.seg.metadata", "claxon.seg.chain", "claxon.seg.results")


def _per_stream(record):
    streams = record.counters.get("seg_streams")
    if not streams:
        return None
    seconds = sum(span_seconds(record, name) or 0.0 for name in SPANS)
    return seconds / streams * 1e6


def read(rec):
    vals = per_call(rec, _per_stream)
    return None if not vals else measure.median(vals)
