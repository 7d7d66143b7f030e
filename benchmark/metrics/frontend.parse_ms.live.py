"""Host front-end in the paced cell: as frontend.parse_ms, on the paced
stream's GOPs."""

SOURCE = "host_clock"
UNIT = "ms"
MOVES = "latency_p50_ms"


def read(ctx):
    return ctx.parse_ms
