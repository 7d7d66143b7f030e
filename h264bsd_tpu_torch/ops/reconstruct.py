"""Whole-frame reconstruction: residual + inter MC + I_PCM + intra
prediction.

Counterpart of the JAX package's ops/reconstruct.py (reconstruct_frame
:44, reconstruct_frame_fast :110, non-rowtile branch). The phase passes
replace the reference's per-macroblock interleaved loop
(h264bsd_slice_data.c:131-220):

  1. dequant+IDCT: sparse (the residual stage, K9's body) on the main
     path's blob, dense (K9 itself, ops.cuda_transform.idct_blocks) on
     the front-end's dense per-MB tensors
  2. one pass (K3-K6, ops.cuda_mc.mc_recon_cuda) writes the planes:
     motion compensation from the DPB ring and the inter combine
     clip(pred + res) on P and P_Skip MBs (image.c:172), the I_PCM raw
     samples (macroblock_layer.c:992-1022), 0 on the other MBs
  3. intra prediction + residual + clip       (K7 wavefront or K2 list)

The output planes are the pre-deblocking picture.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import as_tensor
from .cuda_intra import intra_pass_cuda
from .cuda_intra_wf import intra_pass_wavefront_cuda
from .cuda_mc import mc_recon_cuda
from .cuda_transform import (residual_planes_sparse_cuda,
                             residual_transform_cuda)
from .inter import mb_grid_to_plane, plane_to_mb_grid  # noqa: F401
from .transform import mb_residual_planes
from .unpack import unpack_meta

# intra-MB count above which a frame runs the anti-diagonal wavefront
# intra kernel (K7) instead of the list kernel (K2); the JAX package's
# threshold (models/decoder.py:48), so both take the same caps and blob
# shapes
WF_THRESH = 2048


def reconstruct_frame(tensors, dpb_y, dpb_cb, dpb_cr, width_mbs,
                      height_mbs):
    """Reconstruct the pre-deblock picture from the front-end's dense
    per-MB tensors and the DPB ring (the JAX package's dense
    reconstruct_frame).

    tensors: the dict of FrontendDecoder.tensors plus pcm_y (nMB, 16, 16)
    and pcm_cb / pcm_cr (nMB, 8, 8) uint8 I_PCM samples (zeros where
    absent), numpy arrays or tensors. They go to the ring's device. The
    intra stage is chosen by the main path's rule: K7 over the whole
    frame above WF_THRESH intra MBs, else K2 on the raster list of the
    intra MBs, both counted on the host copy of mb_class (a numpy
    mb_class needs no device read). Returns (y, cb, cr, t): uint8 planes
    and the frame's tensors on the device, for the deblocking filter."""
    dev = dpb_y.device
    cls = tensors["mb_class"]
    cls = cls if isinstance(cls, np.ndarray) else cls.cpu().numpy()
    intra_ids = np.flatnonzero((cls == 3) | (cls == 4))
    t = {k: as_tensor(v, dev) for k, v in tensors.items()}
    mb_class = t["mb_class"]
    res, _ = residual_transform_cuda(
        t["coeff"], t["luma_dc"], t["chroma_dc"], t["qp_y"],
        t["chroma_qp_offset"], t["nnz"], t["nnz_dc"], mb_class == 4)
    res_l, res_c = (r.contiguous() for r in mb_residual_planes(res))
    y, cb, cr = mc_recon_cuda(dpb_y, dpb_cb, dpb_cr, t["mv"], t["ref_slot"],
                              mb_class, res_l, res_c,
                              (t["pcm_y"], t["pcm_cb"], t["pcm_cr"]),
                              width_mbs, height_mbs)
    intra_args = (mb_class, t["i4_modes"], t["i4_avail"], t["mb_avail"],
                  t["i16_mode"], t["chroma_mode"], res_l, res_c, width_mbs,
                  height_mbs)
    if len(intra_ids) > WF_THRESH:
        y, cb, cr = intra_pass_wavefront_cuda(y, cb, cr, *intra_args)
    else:
        y, cb, cr = intra_pass_cuda(
            y, cb, cr, *intra_args,
            intra_ids=torch.from_numpy(intra_ids.astype(np.int32)).to(dev))
    return y, cb, cr, t


def build_pcm_tensors(n_mbs, ipcm_mb, ipcm_data):
    """Host-side: densify the sparse I_PCM list (mb indices + 384-byte
    blobs) into (nMB,16,16)/(nMB,8,8) uint8 arrays."""
    pcm_y = np.zeros((n_mbs, 16, 16), np.uint8)
    pcm_cb = np.zeros((n_mbs, 8, 8), np.uint8)
    pcm_cr = np.zeros((n_mbs, 8, 8), np.uint8)
    for i, mb in enumerate(np.asarray(ipcm_mb)):
        blob = np.asarray(ipcm_data[i], np.uint8)
        pcm_y[mb] = blob[:256].reshape(16, 16)
        pcm_cb[mb] = blob[256:320].reshape(8, 8)
        pcm_cr[mb] = blob[320:].reshape(8, 8)
    return pcm_y, pcm_cb, pcm_cr


def reconstruct_frame_fast(packed, slice_table, sparse_ids, sparse_levels,
                           mv_exc_ids, mv_exc_payload, intra_mbs,
                           intra_payload, pcm, dpb, width_mbs, height_mbs,
                           intra_wavefront=False, slice_ids=None):
    """Unpack the per-MB metadata, transform the sparse residual and
    reconstruct the picture. `pcm` is the (pcm_y, pcm_cb, pcm_cr) uint8
    tensors of build_pcm_tensors, or None for a picture without I_PCM
    MBs; `dpb` the (y, cb, cr) ring the inter MBs predict from. The
    intra stage walks the intra-MB list (K2) or the anti-diagonal
    wavefront (K7), chosen by the caller from the frame's intra-MB
    count. Returns (y, cb, cr, tensors)."""
    n_mb = width_mbs * height_mbs
    t = unpack_meta(packed, slice_table, mv_exc_ids, mv_exc_payload,
                    intra_mbs, intra_payload, n_mb, slice_ids,
                    sparse_ids=sparse_ids)
    mb_class = t["mb_class"]
    res_l, res_c = residual_planes_sparse_cuda(
        sparse_ids.reshape(-1), sparse_levels, t["qp_y"],
        t["chroma_qp_offset"], t["nnz_dc"], mb_class == 4, n_mb)

    # inter MBs clip(pred + res), I_PCM samples, every other MB 0; intra
    # MBs are overwritten below. I_PCM lands before the intra pass because
    # intra neighbours may predict from it (macroblock_layer.c:992-1022
    # writes it inline)
    y, cb, cr = mc_recon_cuda(*dpb, t["mv"], t["ref_slot"], mb_class, res_l,
                              res_c, pcm, width_mbs, height_mbs)

    intra_args = (mb_class, t["i4_modes"], t["i4_avail"], t["mb_avail"],
                  t["i16_mode"], t["chroma_mode"], res_l, res_c, width_mbs,
                  height_mbs)
    if intra_wavefront:
        y, cb, cr = intra_pass_wavefront_cuda(y, cb, cr, *intra_args)
    else:
        y, cb, cr = intra_pass_cuda(y, cb, cr, *intra_args,
                                    intra_ids=intra_mbs.reshape(-1))
    return y, cb, cr, t
