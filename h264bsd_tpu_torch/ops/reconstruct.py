"""Whole-frame reconstruction of an intra picture: residual + I_PCM +
intra prediction.

Counterpart of the JAX package's ops/reconstruct.py (reconstruct_frame_fast
:110, non-rowtile branch). The phase passes replace the reference's
per-macroblock interleaved loop (h264bsd_slice_data.c:131-220):

  1. sparse dequant+IDCT                      (ops.transform)
  2. I_PCM raw-sample merge                   (macroblock_layer.c:992-1022)
  3. intra prediction + residual + clip       (K7 wavefront or K2 list)

No motion compensation runs here: the decoder admits only pictures that
reference no DPB slot, so no MB is inter and the JAX package's inter
combine (clip(pred + res) where inter) selects nothing. The output planes
are the pre-deblocking picture.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_intra import intra_pass_cuda
from .cuda_intra_wf import intra_pass_wavefront_cuda
from .transform import residual_planes_sparse
from .unpack import unpack_meta


def mb_grid_to_plane(mbs, width_mbs, height_mbs):
    """(nMB, S, S) -> (height_mbs*S, width_mbs*S), contiguous."""
    s = mbs.shape[-1]
    x = mbs.reshape(height_mbs, width_mbs, s, s).permute(0, 2, 1, 3)
    return x.reshape(height_mbs * s, width_mbs * s).contiguous()


def plane_to_mb_grid(plane, size):
    h, w = plane.shape
    x = plane.reshape(h // size, size, w // size, size).permute(0, 2, 1, 3)
    return x.reshape(-1, size, size)


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
                           intra_payload, pcm, width_mbs, height_mbs,
                           intra_wavefront=False, slice_ids=None):
    """Unpack the per-MB metadata, transform the sparse residual and
    reconstruct the intra picture. `pcm` is the (pcm_y, pcm_cb, pcm_cr)
    uint8 tensors of build_pcm_tensors, or None for a picture without
    I_PCM MBs. The intra stage walks the intra-MB list (K2) or the
    anti-diagonal wavefront (K7), chosen by the caller from the frame's
    intra-MB count. Returns (y, cb, cr, tensors)."""
    n_mb = width_mbs * height_mbs
    dev = packed.device
    t = unpack_meta(packed, slice_table, mv_exc_ids, mv_exc_payload,
                    intra_mbs, intra_payload, n_mb, slice_ids,
                    sparse_ids=sparse_ids)
    mb_class = t["mb_class"]
    res_l, res_c = residual_planes_sparse(
        sparse_ids.reshape(-1), sparse_levels, t["qp_y"],
        t["chroma_qp_offset"], t["nnz_dc"], mb_class == 4, n_mb)

    # every MB but I_PCM starts at 0 and intra MBs are overwritten below;
    # I_PCM samples land first because intra neighbours may predict from
    # them (macroblock_layer.c:992-1022 writes them inline)
    H, W = 16 * height_mbs, 16 * width_mbs
    if pcm is None:
        y = torch.zeros((H, W), dtype=torch.uint8, device=dev)
        cb = torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev)
        cr = torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev)
    else:
        is_pcm = (mb_class == 5)[:, None, None]
        y, cb, cr = (mb_grid_to_plane(torch.where(is_pcm, p, 0), width_mbs,
                                      height_mbs) for p in pcm)

    intra_args = (mb_class, t["i4_modes"], t["i4_avail"], t["mb_avail"],
                  t["i16_mode"], t["chroma_mode"], res_l, res_c, width_mbs,
                  height_mbs)
    if intra_wavefront:
        y, cb, cr = intra_pass_wavefront_cuda(y, cb, cr, *intra_args)
    else:
        y, cb, cr = intra_pass_cuda(y, cb, cr, *intra_args,
                                    intra_ids=intra_mbs.reshape(-1))
    return y, cb, cr, t
