"""Device (one H100): the share of the traced window in which no
operation ran on the card, 1 - (union of CUDA activity) / window."""

SOURCE = "device_trace"
UNIT = "%"
MOVES = "fps"


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
