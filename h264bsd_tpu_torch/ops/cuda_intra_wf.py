"""Intra wavefront kernel (K7): wrapper and plain version.

Counterpart of the JAX package's ops/pallas_intra_wf.py
(intra_pass_wavefront_pallas :600). The kernel is intra_wf_kernel in
csrc/intra_wf.cu: K2's per-MB device code (csrc/intra_mb.cuh), launched
once per anti-diagonal w = 2r + c with one thread block per MB on it.
It runs on frames with more than WF_THRESH intra MBs.
"""

from __future__ import annotations

from . import _kernels
from .cuda_intra import intra_args, intra_pass_cuda
from .deblock import anti_diagonals
from .intra import intra_walk


def intra_pass_wavefront_plain(y, cb, cr, mb_class, i4_modes, i4_avail,
                               mb_avail, i16_mode, chroma_mode, resid_luma,
                               resid_chroma, width_mbs, height_mbs):
    """The plain PyTorch version: the intra MBs of each anti-diagonal
    reconstructed as one batch, diagonal after diagonal (the same result
    as the raster walk, see ops.deblock.anti_diagonals)."""
    intra = ((mb_class == 3) | (mb_class == 4)).tolist()
    groups = [[i for i in diag if intra[i]]
              for diag in anti_diagonals(width_mbs, height_mbs)]
    return intra_walk(y, cb, cr, groups, mb_class, i4_modes, i4_avail,
                      mb_avail, i16_mode, chroma_mode, resid_luma,
                      resid_chroma, width_mbs)


def intra_pass_wavefront_cuda(y, cb, cr, mb_class, i4_modes, i4_avail,
                              mb_avail, i16_mode, chroma_mode, resid_luma,
                              resid_chroma, width_mbs, height_mbs):
    """Reconstruct every intra MB (class 3/4) in place (K7) and return the
    uint8 planes. Frames under 3 MBs wide go to the list kernel (K2)
    over all MBs, as in the JAX package (pallas_intra_wf.py:609-613).
    CPU tensors run the plain version."""
    args = (y, cb, cr, mb_class, i4_modes, i4_avail, mb_avail, i16_mode,
            chroma_mode, resid_luma, resid_chroma, width_mbs, height_mbs)
    if width_mbs < 3:
        return intra_pass_cuda(*args)
    if y.device.type == "cpu":
        return intra_pass_wavefront_plain(*args)
    ptrs, _keep = intra_args(*args)
    _kernels.launch("h264_intra_wavefront", y.device, *ptrs, width_mbs,
                    height_mbs)
    return y, cb, cr
