"""Peaks of the card and a kernel's share of its roofline.

A share is the least time the card could take for the work, bytes over
the peak HBM bandwidth, over the kernel's device time. The bytes are
counted from the cell's own pictures by the reference
(reference.h264.decode_pictures: the samples the stage must read, each
once, and the samples it must write), never from the program's own
tensors, so the count holds whatever implements the stage. Operations
are not counted: the only int32 rate for the H100 is one derived from
SMs x lanes x clock, not a published peak, so every share here is
against the bytes bound alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3 at the 700 W limit
PEAK_HBM_BYTES_PER_S = 3.35e12


def share(n_bytes: float, seconds: float):
    """Percent of the bytes bound that `seconds` of kernel time reached,
    or None with no kernel time to read."""
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / PEAK_HBM_BYTES_PER_S / seconds
