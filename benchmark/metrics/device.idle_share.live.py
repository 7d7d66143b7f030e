"""Device in the paced cell: as device.idle_share."""

SOURCE = "device_trace"
UNIT = "%"
MOVES = "latency_p50_ms"


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
