"""100 x (1 - the union of kernel and copy intervals / the traced
window), from torch.profiler."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "rate_device"


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
