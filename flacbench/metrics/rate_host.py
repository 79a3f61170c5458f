"""As ``rate_device``, with each call ending when ``to_host()`` has
returned every stream's int32 PCM in numpy."""

from flacbench import measure

UNIT = "Msamples/s"
SOURCE = "host_clock"


def read(rec):
    if rec["entry"] != "host":
        return None
    rate = measure.window_rate(rec["calls"], rec["t_start"])
    return None if rate is None else rate / 1e6
