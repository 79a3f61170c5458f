"""The least time of the window's decoded work on the card's memory (the
compressed bytes read once and the PCM written once as int32, over
3.35 TB/s) as a share of the union of kernel intervals in the traced
window (copies not counted). It counts the same work whatever kernels
do it."""

from flacbench import measure

UNIT = "%"
SOURCE = "device_trace"
LAYER = "ops kernels"
MOVES = "rate_device"


def read(rec):
    if not rec.get("kernel_s"):
        return None
    least = sum(measure.least_bytes(c["flac_bytes"], c["samples"])
                for c in rec["calls"]) / measure.HBM_BYTES_PER_S
    return 100.0 * least / rec["kernel_s"]
