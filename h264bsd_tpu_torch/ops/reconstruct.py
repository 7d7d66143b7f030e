"""Whole-frame reconstruction: residual + inter MC + I_PCM + intra
prediction.

Counterpart of the JAX package's ops/reconstruct.py (reconstruct_frame_fast
:110, non-rowtile branch). The phase passes replace the reference's
per-macroblock interleaved loop (h264bsd_slice_data.c:131-220):

  1. sparse dequant+IDCT                      (K9, ops.cuda_transform)
  2. one pass (K3-K6, ops.cuda_mc.mc_recon_cuda) writes the planes:
     motion compensation from the DPB ring and the inter combine
     clip(pred + res) on P and P_Skip MBs (image.c:172), the I_PCM raw
     samples (macroblock_layer.c:992-1022), 0 on the other MBs
  3. intra prediction + residual + clip       (K7 wavefront or K2 list)

The output planes are the pre-deblocking picture.
"""

from __future__ import annotations

import numpy as np

from .cuda_intra import intra_pass_cuda
from .cuda_intra_wf import intra_pass_wavefront_cuda
from .cuda_mc import mc_recon_cuda
from .cuda_transform import residual_planes_sparse_cuda
from .unpack import unpack_meta


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
