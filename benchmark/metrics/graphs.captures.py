"""Graphs (models/graphs.py): CUDA graph captures made inside the
window, STATS["graph_captures"] read before and after it; 0 once every
frame shape of the stream was captured in the warm-up."""

SOURCE = "program_counter"
UNIT = "count"
MOVES = "fps"


def read(ctx):
    return ctx.graph_captures
