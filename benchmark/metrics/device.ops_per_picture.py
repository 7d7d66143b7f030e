"""Device glue (ops/*.py) and kernels: device operations (kernels, copies
and memsets, whatever launched them) in the traced window per picture
handed on."""

SOURCE = "device_trace"
UNIT = "ops/picture"
MOVES = "fps"


def read(ctx):
    if not ctx.n_pictures or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.n_pictures
