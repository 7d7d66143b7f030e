"""Wavefront deblocking kernel (K1): wrapper and plain version.

Counterpart of the JAX package's ops/pallas_deblock_wf.py
(deblock_frame_wavefront :592, deblock_frame_wavefront_from_bs :616).
The kernel is deblock_wf_kernel in csrc/deblock_wf.cu: one launch, one
thread block per MB, each taking MBs in raster order from a ticket
counter and waiting on the done flags of its left, above and above-right
MBs (csrc/mb_sync.cuh) instead of a launch per anti-diagonal. The MBs
that rule lets run together are those of one anti-diagonal
(ops.deblock.anti_diagonals). The boundary strengths and thresholds are
plain PyTorch on the device (ops/deblock.py), as they are XLA outside
the TPU kernel.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_deblock import deblock_args, deblock_frame_cuda_from_bs
from .deblock import anti_diagonals, deblock_params, deblock_walk


def deblock_wavefront_plain(y, cb, cr, bs_left, bs_top, luma_thr,
                            chroma_thr, width_mbs, height_mbs):
    """The plain PyTorch version: the MBs of each anti-diagonal filtered
    as one batch, diagonal after diagonal (the same result as the raster
    walk, see ops.deblock.anti_diagonals)."""
    return deblock_walk(y, cb, cr, anti_diagonals(width_mbs, height_mbs),
                        bs_left, bs_top, luma_thr, chroma_thr, width_mbs)


def deblock_frame_wavefront_from_bs(y, cb, cr, bs_left, bs_top, luma_thr,
                                    chroma_thr, width_mbs, height_mbs):
    """Deblock the uint8 planes in place (K1) from the frame's boundary
    strengths and thresholds; returns the planes. Frames under 3 MBs
    wide go to the raster kernel (K8), as in the JAX package
    (pallas_deblock_wf.py:625-628). CPU tensors run the plain version."""
    if width_mbs < 3:
        return deblock_frame_cuda_from_bs(y, cb, cr, bs_left, bs_top,
                                          luma_thr, chroma_thr, width_mbs,
                                          height_mbs)
    if y.device.type == "cpu":
        return deblock_wavefront_plain(y, cb, cr, bs_left, bs_top, luma_thr,
                                       chroma_thr, width_mbs, height_mbs)
    args = deblock_args(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr,
                        width_mbs, height_mbs)
    # the kernel's scratch: each MB's done flag, then the ticket counter
    sync = torch.zeros(width_mbs * height_mbs + 1, dtype=torch.int32,
                       device=y.device)
    _kernels.launch("h264_deblock_wavefront", y.device, *args[:-2],
                    sync.data_ptr(), *args[-2:])
    return y, cb, cr


def deblock_frame_wavefront(y, cb, cr, mb_class, nnz, mv, ref_slot,
                            slice_id, disable_dblk, qp_y, filter_off_a,
                            filter_off_b, chroma_qp_offset, width_mbs,
                            height_mbs):
    """Filter the whole picture in place (reference h264bsdFilterPicture
    deblocking.c:575-640); returns (y, cb, cr)."""
    bs_left, bs_top, lt, ct = deblock_params(
        mb_class, nnz, mv, ref_slot, slice_id, disable_dblk, qp_y,
        filter_off_a, filter_off_b, chroma_qp_offset, width_mbs, height_mbs)
    return deblock_frame_wavefront_from_bs(y, cb, cr, bs_left, bs_top, lt,
                                           ct, width_mbs, height_mbs)
