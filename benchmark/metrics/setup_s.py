"""Process start to the window's start: imports, the kernels' and the
front-end's load or build, stream generation, warm-up and captures."""

SOURCE = "host_clock"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
