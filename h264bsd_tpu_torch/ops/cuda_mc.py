"""Motion compensation (K3-K6): the kernels' wrappers and plain versions.

Counterpart of the JAX package's ops/pallas_mc.py (mc_predict_grids :409,
_mc_predict_group :457) and of its inter combine (ops/reconstruct.py
:168-218). The kernels are in csrc/mc.cu.

The main path runs mc_recon_cuda: one launch of mc_recon_kernel per
picture predicts every 4x4 block of the inter MBs from the dense
per-block motion, adds and clips the residual, takes the I_PCM samples
and writes the planes. Predicting every block with its own MV and slot is
exact: the front-end lists a quad as an exception exactly when one of its
blocks differs from block 0, so the dense motion is block 0's with the
exception quads scattered in.

mc_predict_grids keeps the TPU kernels' own signature, off the main path:
mc_uniform_kernel predicts every MB whole with block 0's MV and slot (the
TPU's _uniform_luma_kernel and _uniform_chroma_kernel), then
mc_exception_kernel predicts the listed 8x8 quads block by block (the
TPU's _exc_luma_kernel and _exc_chroma_kernel) and writes them over the
uniform result.

Every function takes mb_row_offset, the first MB row's position in the
reference frame, as the TPU kernels do (pallas_mc.py:411): the
row-sharded path (parallel/rowshard.py) predicts a stripe of
height_mbs MB rows from whole reference frames, whose height is the
ring's own; the main path passes 0.

Every kernel reads the DPB ring in place, each block from its own slot,
so there is no padded copy of the referenced slots and no pass per group
of slots (pallas_mc.py:406-454 has no counterpart). The plain versions
are built from ops/inter.py, the CPU path and oracle.
"""

from __future__ import annotations

import torch

from . import _kernels
from .inter import (block_positions, inter_predict_frame,
                    mb_grid_to_plane, predict_blocks)

# raster blocks of each 8x8 quadrant (front-end kQuadBlocks)
QUAD_BLOCKS = ((0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15))


def stripe_exc_ids(exc_ids, first_mb, n_mbs):
    """The frame's quad exception ids (mb*4 + q) rebased onto the stripe
    of n_mbs MBs from MB first_mb; entries outside it become padding (ids
    n_mbs*4), as the JAX row-sharded step rebases them
    (h264bsd_tpu/parallel/rowshard.py:133-137). mc_recon needs no list:
    it reads every block's own motion."""
    local = exc_ids.reshape(-1).long() - 4 * first_mb
    return torch.where((local >= 0) & (local < 4 * n_mbs), local,
                       4 * n_mbs).to(exc_ids.dtype)


def mc_uniform_plain(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, width_mbs,
                     height_mbs, mb_row_offset=0):
    """Every MB predicted whole with block 0's MV and slot: ops.inter with
    that MV and slot on all 16 blocks. Returns u8 (nMB,16,16), (nMB,8,8),
    (nMB,8,8)."""
    return tuple(g.to(torch.uint8) for g in inter_predict_frame(
        dpb_y, dpb_cb, dpb_cr, mv[:, :1].expand(-1, 16, -1),
        ref_slot[:, :1].expand(-1, 16), width_mbs, height_mbs,
        mb_row_offset))


def mc_exception_plain(grid_y, grid_cb, grid_cr, dpb_y, dpb_cb, dpb_cr, mv,
                       ref_slot, exc_ids, width_mbs, height_mbs, n_exc=None,
                       mb_row_offset=0):
    """Predict the listed quads (ids mb*4 + q; ids >= nMB*4 are padding;
    only the first n_exc entries when given) block by block through
    ops.inter and write them over the grids, in place. Returns the
    grids."""
    n_mb = width_mbs * height_mbs
    dev = dpb_y.device
    ids = exc_ids.reshape(-1).long()
    if n_exc is not None:
        ids = ids[:n_exc]
    ids = ids[(ids >= 0) & (ids < n_mb * 4)]
    mb = ids // 4
    quad = torch.as_tensor(QUAD_BLOCKS, device=dev)[ids % 4]   # (k, 4)
    mbb = mb[:, None].expand(-1, 4).reshape(-1)
    b = quad.reshape(-1)
    bx, by = block_positions(mbb, b, width_mbs, dev)
    by = by + 16 * mb_row_offset
    m = mv.long()[mbb, b]
    pred, pcb, pcr = predict_blocks(dpb_y, dpb_cb, dpb_cr, bx, by, m[:, 0],
                                    m[:, 1], ref_slot.long()[mbb, b])
    # each block's pels at their place in the MB grid
    r4 = torch.arange(4, device=dev)
    r2 = torch.arange(2, device=dev)
    rows = (b // 4 * 4)[:, None, None] + r4[None, :, None]
    cols = (b % 4 * 4)[:, None, None] + r4[None, None, :]
    grid_y[mbb[:, None, None], rows, cols] = pred.to(torch.uint8)
    rows = (b // 4 * 2)[:, None, None] + r2[None, :, None]
    cols = (b % 4 * 2)[:, None, None] + r2[None, None, :]
    grid_cb[mbb[:, None, None], rows, cols] = pcb.to(torch.uint8)
    grid_cr[mbb[:, None, None], rows, cols] = pcr.to(torch.uint8)
    return grid_y, grid_cb, grid_cr


def _mc_args(dpb_y, dpb_cb, dpb_cr, mv32, ref32, grids, width_mbs,
             height_mbs):
    n = width_mbs * height_mbs
    H, W = dpb_y.shape[1], 16 * width_mbs
    s = dpb_y.shape[0]
    u8, i32 = torch.uint8, torch.int32
    return [_kernels.ptr(dpb_y, u8, (s, H, W), "dpb_y"),
            _kernels.ptr(dpb_cb, u8, (s, H // 2, W // 2), "dpb_cb"),
            _kernels.ptr(dpb_cr, u8, (s, H // 2, W // 2), "dpb_cr"),
            _kernels.ptr(mv32, i32, (n, 16, 2), "mv"),
            _kernels.ptr(ref32, i32, (n, 16), "ref_slot"),
            _kernels.ptr(grids[0], u8, (n, 16, 16), "pred_y"),
            _kernels.ptr(grids[1], u8, (n, 8, 8), "pred_cb"),
            _kernels.ptr(grids[2], u8, (n, 8, 8), "pred_cr")]


def mc_uniform_cuda(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, width_mbs,
                    height_mbs, mb_row_offset=0):
    """K3+K4: the uniform prediction of every MB (see mc_uniform_plain).
    CPU tensors run the plain version."""
    if dpb_y.device.type == "cpu":
        return mc_uniform_plain(dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                                width_mbs, height_mbs, mb_row_offset)
    n = width_mbs * height_mbs
    dev = dpb_y.device
    # int16 MVs / int8 slots from unpack_meta, widened to contiguous int32;
    # the copies stay alive until the launch has been enqueued
    mv32 = mv.to(torch.int32).contiguous()
    ref32 = ref_slot.to(torch.int32).contiguous()
    grids = (torch.empty((n, 16, 16), dtype=torch.uint8, device=dev),
             torch.empty((n, 8, 8), dtype=torch.uint8, device=dev),
             torch.empty((n, 8, 8), dtype=torch.uint8, device=dev))
    _kernels.launch("h264_mc_uniform", dev,
                    *_mc_args(dpb_y, dpb_cb, dpb_cr, mv32, ref32, grids,
                              width_mbs, height_mbs),
                    dpb_y.shape[0], width_mbs, height_mbs, dpb_y.shape[1],
                    mb_row_offset)
    return grids


def mc_exception_cuda(grid_y, grid_cb, grid_cr, dpb_y, dpb_cb, dpb_cr, mv,
                      ref_slot, exc_ids, width_mbs, height_mbs, n_exc=None,
                      mb_row_offset=0):
    """K5+K6: the listed quads over the grids, in place (see
    mc_exception_plain); one thread block per entry of the first n_exc
    (all when None), no launch when there is none. CPU tensors run the
    plain version."""
    if dpb_y.device.type == "cpu":
        return mc_exception_plain(grid_y, grid_cb, grid_cr, dpb_y, dpb_cb,
                                  dpb_cr, mv, ref_slot, exc_ids, width_mbs,
                                  height_mbs, n_exc, mb_row_offset)
    ids = exc_ids.reshape(-1).to(torch.int32).contiguous()
    n = ids.shape[0] if n_exc is None else min(int(n_exc), ids.shape[0])
    if n == 0:
        return grid_y, grid_cb, grid_cr
    dev = dpb_y.device
    mv32 = mv.to(torch.int32).contiguous()
    ref32 = ref_slot.to(torch.int32).contiguous()
    args = _mc_args(dpb_y, dpb_cb, dpb_cr, mv32, ref32,
                    (grid_y, grid_cb, grid_cr), width_mbs, height_mbs)
    _kernels.launch("h264_mc_exception", dev, *args,
                    _kernels.ptr(ids, torch.int32, ids.shape, "exc_ids"), n,
                    dpb_y.shape[0], width_mbs, height_mbs, dpb_y.shape[1],
                    mb_row_offset)
    return grid_y, grid_cb, grid_cr


def mc_predict_grids(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, exc_ids,
                     width_mbs, height_mbs, n_exc=None, mb_row_offset=0):
    """Motion compensation of the whole frame.

    dpb_*: the DPB ring (slots, H, W) / (slots, H/2, W/2) uint8; mv:
    (nMB, 16, 2) quarter-pel; ref_slot: (nMB, 16) (negative reads slot
    0); exc_ids: quad-grained exception ids mb*4 + q, padded with ids >=
    nMB*4; n_exc: the real entries at the head of exc_ids, when the
    caller knows it (no launch for 0); mb_row_offset: see the module
    docstring. Returns u8 grids (nMB,16,16), (nMB,8,8), (nMB,8,8),
    meaningful for inter MBs."""
    grids = mc_uniform_cuda(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, width_mbs,
                            height_mbs, mb_row_offset)
    return mc_exception_cuda(*grids, dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                             exc_ids, width_mbs, height_mbs, n_exc,
                             mb_row_offset)


def mc_recon_plain(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l,
                   res_c, pcm, width_mbs, height_mbs, mb_row_offset=0):
    """The picture before its intra pass: clip(pred + res) on the inter
    MBs (mb_class 1 or 2), each 4x4 block predicted by ops.inter with its
    own MV and slot; the I_PCM samples on class-5 MBs when pcm, the
    (pcm_y, pcm_cb, pcm_cr) uint8 grids of build_pcm_tensors, is given;
    0 on every other MB. res_l (nMB,16,16) and res_c (nMB,2,8,8) int32;
    mb_row_offset: see the module docstring. Returns u8 planes (H, W),
    (H/2, W/2), (H/2, W/2), H = 16 * height_mbs."""
    pred = inter_predict_frame(dpb_y, dpb_cb, dpb_cr, mv, ref_slot,
                               width_mbs, height_mbs, mb_row_offset)
    inter = ((mb_class == 1) | (mb_class == 2))[:, None, None]
    res = (res_l, res_c[:, 0], res_c[:, 1])
    grids = [torch.where(inter, (p + r).clamp(0, 255), 0).to(torch.uint8)
             for p, r in zip(pred, res)]
    if pcm is not None:
        is_pcm = (mb_class == 5)[:, None, None]
        grids = [torch.where(is_pcm, p, g) for p, g in zip(pcm, grids)]
    return tuple(mb_grid_to_plane(g, width_mbs, height_mbs) for g in grids)


def mc_recon_cuda(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l,
                  res_c, pcm, width_mbs, height_mbs, mb_row_offset=0):
    """The main path's MC stage (see mc_recon_plain) as one launch of
    mc_recon_kernel, or of mc_recon_stripe_kernel (counted as
    mc_recon_stripe) for a stripe of a taller ring or at a non-zero
    mb_row_offset, on the tensors as unpack_meta and the residual stage
    return them: mv int16 (nMB,16,2), ref_slot int8 (nMB,16), mb_class
    uint8 (nMB,), res_l / res_c int32; no casts, no copies. CPU tensors
    run the plain version."""
    if dpb_y.device.type == "cpu":
        return mc_recon_plain(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class,
                              res_l, res_c, pcm, width_mbs, height_mbs,
                              mb_row_offset)
    n = width_mbs * height_mbs
    H, W = 16 * height_mbs, 16 * width_mbs
    s, ref_h = dpb_y.shape[0], dpb_y.shape[1]
    dev = dpb_y.device
    u8, p = torch.uint8, _kernels.ptr
    planes = (torch.empty((H, W), dtype=u8, device=dev),
              torch.empty((H // 2, W // 2), dtype=u8, device=dev),
              torch.empty((H // 2, W // 2), dtype=u8, device=dev))
    pcm_ptrs = [None] * 3 if pcm is None else [
        p(g, u8, shape, name, 4) for g, shape, name in
        zip(pcm, ((n, 16, 16), (n, 8, 8), (n, 8, 8)),
            ("pcm_y", "pcm_cb", "pcm_cr"))]
    whole = mb_row_offset == 0 and ref_h == H
    _kernels.launch(
        "h264_mc_recon" if whole else "h264_mc_recon_stripe", dev,
        p(dpb_y, u8, (s, ref_h, W), "dpb_y", 16),
        p(dpb_cb, u8, (s, ref_h // 2, W // 2), "dpb_cb", 8),
        p(dpb_cr, u8, (s, ref_h // 2, W // 2), "dpb_cr", 8),
        p(mv, torch.int16, (n, 16, 2), "mv", 4),
        p(ref_slot, torch.int8, (n, 16), "ref_slot"),
        p(mb_class, u8, (n,), "mb_class"),
        p(res_l, torch.int32, (n, 16, 16), "res_l", 16),
        p(res_c, torch.int32, (n, 2, 8, 8), "res_c", 16),
        *pcm_ptrs,
        *(p(pl, u8, tuple(pl.shape), name, 4)
          for pl, name in zip(planes, ("y", "cb", "cr"))),
        s, width_mbs, height_mbs,
        *(() if whole else (ref_h, mb_row_offset)))
    return planes
