"""Median per call of the sum of the segmented path's host stages, the
program's own ``DeviceDecoded.stage_seconds`` (metadata, group buffer,
upload, demux queue, summary wait, chaining, planning and dispatch,
fallback)."""

from flacbench import measure

UNIT = "ms"
SOURCE = "program_counter"
LAYER = "pipeline_seg host stages"
MOVES = "rate_device"


def read(rec):
    vals = [sum(c["stage_seconds"].values()) for c in rec["calls"]
            if c["stage_seconds"]]
    return None if not vals else measure.median(vals) * 1e3
