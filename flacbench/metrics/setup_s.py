"""From the start of the process to the start of the window: imports,
the pool (built on a checkout's first run), the seed's tracks, loading
the kernels (built on the first run) and the warm-up, which calibrates
the default route."""

UNIT = "s"
SOURCE = "host_clock"


def read(rec):
    return rec["setup_s"]
