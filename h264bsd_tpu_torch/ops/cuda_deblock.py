"""Raster deblocking kernel (K8): wrapper and plain version.

Counterpart of the JAX package's ops/pallas_deblock.py
(deblock_frame_pallas_from_bs :335). The kernel is deblock_raster_kernel
in csrc/deblock_wf.cu: one thread block stages bands of MB rows in shared
memory, loading the next band while one warp filters the MBs of this one
in raster order. The wavefront wrapper (ops/cuda_deblock_wf.py) hands
it the frames under 3 MBs wide, which have too few MBs per diagonal to
gain from the wavefront; it takes no wider frame.
"""

from __future__ import annotations

import torch

from . import _kernels
from .deblock import deblock_frame_with_bs


def deblock_raster_plain(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr,
                         width_mbs, height_mbs):
    """The plain PyTorch version: the raster walk of ops/deblock.py."""
    return deblock_frame_with_bs(y, cb, cr, bs_left, bs_top, luma_thr,
                                 chroma_thr, width_mbs, height_mbs)


def deblock_args(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr,
                 width_mbs, height_mbs):
    """Checked device pointers of the deblocking entry points' arguments,
    in their order (csrc/deblock_wf.cu). The planes are read and written
    as 4-byte words (K8)."""
    n = width_mbs * height_mbs
    H, W = 16 * height_mbs, 16 * width_mbs
    u8, i32 = torch.uint8, torch.int32
    ptrs = [_kernels.ptr(y, u8, (H, W), "y", 4),
            _kernels.ptr(cb, u8, (H // 2, W // 2), "cb", 4),
            _kernels.ptr(cr, u8, (H // 2, W // 2), "cr", 4),
            _kernels.ptr(bs_left, i32, (n, 16), "bs_left"),
            _kernels.ptr(bs_top, i32, (n, 16), "bs_top")]
    for name, thr in (("luma", luma_thr), ("chroma", chroma_thr)):
        alpha, beta, tc0 = thr
        ptrs += [_kernels.ptr(alpha, i32, (n, 3), name + " alpha"),
                 _kernels.ptr(beta, i32, (n, 3), name + " beta"),
                 _kernels.ptr(tc0, i32, (n, 3, 3), name + " tc0")]
    return ptrs + [width_mbs, height_mbs]


def deblock_frame_cuda_from_bs(y, cb, cr, bs_left, bs_top, luma_thr,
                               chroma_thr, width_mbs, height_mbs):
    """Deblock the uint8 planes in place in raster MB order (K8) from the
    frame's boundary strengths and (alpha, beta, tc0) thresholds, as
    returned by ops.deblock.deblock_params; returns the planes. CPU
    tensors run the plain version."""
    if width_mbs > 2:
        raise ValueError(f"the raster deblock takes frames under 3 MBs "
                         f"wide, not {width_mbs}")
    if y.device.type == "cpu":
        return deblock_raster_plain(y, cb, cr, bs_left, bs_top, luma_thr,
                                    chroma_thr, width_mbs, height_mbs)
    _kernels.launch("h264_deblock_raster", y.device,
                    *deblock_args(y, cb, cr, bs_left, bs_top, luma_thr,
                                  chroma_thr, width_mbs, height_mbs))
    return y, cb, cr
