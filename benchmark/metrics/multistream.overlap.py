"""Many streams (parallel/multistream.py): how far the N frame bodies'
device operations overlap, the sum of their durations over the union of
their intervals in the traced window (1 = no overlap)."""

SOURCE = "device_trace"
UNIT = "x"
MOVES = "fps"


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.op_seconds / ctx.trace.busy_s
