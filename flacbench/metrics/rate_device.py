"""Decoded samples (each channel counted) of every call completed in the
window, over the time from the window's start to the last completion;
a call ends when ``sync()`` has returned with the frame-CRC verdict."""

from flacbench import measure

UNIT = "Msamples/s"
SOURCE = "host_clock"


def read(rec):
    if rec["entry"] != "device":
        return None
    rate = measure.window_rate(rec["calls"], rec["t_start"])
    return None if rate is None else rate / 1e6
