"""Intra list kernel (K2): wrapper and plain version.

Counterpart of the JAX package's ops/pallas_intra.py (intra_pass_pallas
:379). The kernel is intra_list_kernel in csrc/intra_list.cu: one thread
block reconstructs the listed intra MBs in list (decode) order, with the
per-MB device code of csrc/intra_mb.cuh. It runs on frames with at most
WF_THRESH intra MBs and on every frame under 3 MBs wide.
"""

from __future__ import annotations

import torch

from . import _kernels
from .intra import i4_weights, intra_pass, intra_pass_list


def intra_args(y, cb, cr, mb_class, i4_modes, i4_avail, mb_avail, i16_mode,
               chroma_mode, resid_luma, resid_chroma, width_mbs, height_mbs):
    """Checked device pointers of the intra entry points' common
    arguments, in their order (csrc/intra_mb.cuh IntraArgs). Per-MB
    inputs are made int32 and contiguous here (copies where needed)."""
    n = width_mbs * height_mbs
    H, W = 16 * height_mbs, 16 * width_mbs
    u8, i32 = torch.uint8, torch.int32
    # keep the int32 copies alive until the launch has been enqueued; the
    # caching allocator keeps their memory for the stream's pending work
    as32 = [t.to(i32).contiguous() for t in
            (mb_class, i4_modes, i4_avail, mb_avail, i16_mode, chroma_mode,
             resid_luma, resid_chroma)]
    shapes = [(n,), (n, 16), (n, 16), (n,), (n,), (n,), (n, 16, 16),
              (n, 2, 8, 8)]
    names = ["mb_class", "i4_modes", "i4_avail", "mb_avail", "i16_mode",
             "chroma_mode", "resid_luma", "resid_chroma"]
    ptrs = [_kernels.ptr(y, u8, (H, W), "y"),
            _kernels.ptr(cb, u8, (H // 2, W // 2), "cb"),
            _kernels.ptr(cr, u8, (H // 2, W // 2), "cr")]
    ptrs += [_kernels.ptr(t, i32, s, name)
             for t, s, name in zip(as32, shapes, names)]
    w = i4_weights(y.device)
    ptrs.append(_kernels.ptr(w, i32, (9, 16, 13), "i4_weights"))
    return ptrs, as32


def intra_pass_cuda(y, cb, cr, mb_class, i4_modes, i4_avail, mb_avail,
                    i16_mode, chroma_mode, resid_luma, resid_chroma,
                    width_mbs, height_mbs, intra_ids=None):
    """Reconstruct the intra MBs (class 3/4) in place (K2) and return the
    uint8 planes. With intra_ids (decode-ordered MB ids, padded with ids
    outside 0..nMB-1) only those MBs are walked; without, every MB in
    raster order. CPU tensors run the plain version."""
    if y.device.type == "cpu":
        if intra_ids is None:
            return intra_pass(y, cb, cr, mb_class, i4_modes, i4_avail,
                              mb_avail, i16_mode, chroma_mode, resid_luma,
                              resid_chroma, width_mbs)
        return intra_pass_list(y, cb, cr, intra_ids, mb_class, i4_modes,
                               i4_avail, mb_avail, i16_mode, chroma_mode,
                               resid_luma, resid_chroma, width_mbs)
    if intra_ids is None:
        intra_ids = torch.arange(width_mbs * height_mbs, device=y.device)
    ids = intra_ids.reshape(-1).to(torch.int32).contiguous()
    ptrs, _keep = intra_args(y, cb, cr, mb_class, i4_modes, i4_avail,
                             mb_avail, i16_mode, chroma_mode, resid_luma,
                             resid_chroma, width_mbs, height_mbs)
    _kernels.launch("h264_intra_list", y.device, *ptrs,
                    _kernels.ptr(ids, torch.int32, ids.shape, "intra_ids"),
                    ids.shape[0], width_mbs, height_mbs)
    return y, cb, cr
