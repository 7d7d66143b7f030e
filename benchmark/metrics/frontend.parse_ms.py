"""Host front-end (frontend/, Decoder._prepare): milliseconds per picture
of the C++ parse and the blob build alone, on one thread, over every
distinct GOP of the cell's streams, with no device work: the benchmark's
own span around the program's front-end, timed by the host clock
(tools/profile_torch_port.py's method)."""

SOURCE = "host_clock"
UNIT = "ms"
MOVES = "fps"


def read(ctx):
    return ctx.parse_ms
