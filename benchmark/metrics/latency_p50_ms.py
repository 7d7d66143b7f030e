"""Median over every picture of the window of (the time its planes are
complete on the device) - (the time its access unit was due)."""

import numpy as np

SOURCE = "host_clock"
UNIT = "ms"


def read(ctx):
    lat = ctx.window.latencies
    return 1e3 * float(np.percentile(lat, 50)) if lat else None
