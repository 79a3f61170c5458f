"""Median per call of the program's span ``claxon.walk.dispatch``, summed
over the call's runs (``pipeline_bits.decode_raw_bits_device``: the
uploads of the words and of each bucket's packed ``mb`` array, the
``mb`` unpack, torch operations the host paces, and the launches of K2,
K1 + K3 and K4). A record without the host walk's counter ``walk_runs``
reads nothing."""

from flacbench import measure
from flacbench.program import per_call, span_seconds

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline host walk"
MOVES = "rate_device"


def _ms(record):
    if not record.counters.get("walk_runs"):
        return None
    seconds = span_seconds(record, "claxon.walk.dispatch")
    return None if seconds is None else seconds * 1e3


def read(rec):
    vals = per_call(rec, _ms)
    return None if not vals else measure.median(vals)
