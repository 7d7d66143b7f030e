"""Decoded pictures of all streams handed on in the window over the
window's seconds; the window ends in torch.cuda.synchronize()."""

SOURCE = "host_clock"
UNIT = "frames/s"


def read(ctx):
    return ctx.window.n / ctx.window.seconds
