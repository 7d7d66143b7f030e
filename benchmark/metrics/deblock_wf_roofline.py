"""Kernels (csrc/deblock_wf.cu): the deblocking kernel's share of its
bytes bound over the traced window. Bytes: per picture handed on, the
samples the filter must read (every sample of a line across an edge with
bS > 0, each once) and those it changes, counted by the reference from
the cell's own pictures. Time: the device time of deblock_wf_kernel."""

from roofline import share

SOURCE = "device_trace"
UNIT = "%"
MOVES = "fps"
KERNEL = "deblock_wf_kernel"


def read(ctx):
    n = sum(c["deblock_read"] + c["deblock_written"]
            for c in ctx.picture_counts)
    return share(n, ctx.trace.kernel_seconds(KERNEL))
