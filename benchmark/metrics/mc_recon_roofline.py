"""Kernels (csrc/mc.cu): the inter-reconstruction kernel's share of its
bytes bound over the traced window. Bytes: per P picture handed on, the
reference samples luma and chroma prediction must read (per reference
picture, each sample once, by the footprint of each block's fractional
MV) and the samples of the inter MBs it writes, counted by the reference
from the cell's own pictures. Time: the device time of mc_recon_kernel."""

from roofline import share

SOURCE = "device_trace"
UNIT = "%"
MOVES = "fps"
KERNEL = "mc_recon_kernel"


def read(ctx):
    n = sum(c["mc_read"] + c["mc_written"] for c in ctx.picture_counts)
    return share(n, ctx.trace.kernel_seconds(KERNEL))
