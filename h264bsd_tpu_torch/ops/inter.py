"""Inter prediction: 6-tap half/quarter-pel luma motion compensation and
1/8-pel bilinear chroma, batched over 4x4 blocks.

Counterpart of the JAX package's ops/inter.py (luma_predict_blocks :40,
inter_predict_frame :87). Behavioral parity: reference
h264bsd_reconstruct.c — fractional-position dispatch
(h264bsdPredictSamples :1818-1940 over lumaFracPos :72), the eight luma
interpolators (:490-1817, all reducible to the spec's b/h/j half-pel
values plus (x+y+1)>>1 averaging), chroma bilinear (:109-470), and border
overfill (h264bsdFillBlock :2244 == per-sample coordinate clamping).

This is the CPU path of motion compensation and the plain version (the
oracle) of the MC kernels of ops/cuda_mc.py: every block gathers a 9x9
luma window and a 3x3 chroma window from its own reference slot, all 16
fractional luma cases are evaluated and one is selected. Shifts and masks
of MVs are on signed tensors, so >> is arithmetic and & 3 / & 7 are the
two's-complement masks, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_X = np.array([0, 4, 8, 12] * 4, np.int32)
BLOCK_Y = np.repeat(np.arange(4) * 4, 4).astype(np.int32)


def _clip8(x):
    return x.clamp(0, 255)


def _tap6(p0, p1, p2, p3, p4, p5):
    """(1,-5,20,20,-5,1) kernel, unshifted."""
    return p0 - 5 * p1 + 20 * p2 + 20 * p3 - 5 * p4 + p5


def _avg(a, b):
    return (a + b + 1) >> 1


def luma_predict_blocks(win):
    """All 16 fractional predictions for (nB, 9, 9) int32 windows whose
    (2,2) corner is the integer sample position. Returns (nB, 16, 4, 4)
    indexed by frac position code xFrac*4 + yFrac (reference lumaFracPos)."""
    # horizontal 6-tap at half positions between cols j+2 and j+3
    hor = _tap6(win[..., :, 0:4], win[..., :, 1:5], win[..., :, 2:6],
                win[..., :, 3:7], win[..., :, 4:8], win[..., :, 5:9])
    b_full = _clip8((hor + 16) >> 5)            # (nB, 9, 4) rows -2..6
    # vertical 6-tap at half positions between rows i+2 and i+3
    ver = _tap6(win[..., 0:4, :], win[..., 1:5, :], win[..., 2:6, :],
                win[..., 3:7, :], win[..., 4:8, :], win[..., 5:9, :])
    h_full = _clip8((ver + 16) >> 5)            # (nB, 4, 9) cols -2..6
    # center: vertical 6-tap over unclipped horizontal intermediates
    mid = _tap6(hor[..., 0:4, :], hor[..., 1:5, :], hor[..., 2:6, :],
                hor[..., 3:7, :], hor[..., 4:8, :], hor[..., 5:9, :])
    j = _clip8((mid + 512) >> 10)               # (nB, 4, 4)

    g = win[..., 2:6, 2:6]      # integer G
    g_right = win[..., 2:6, 3:7]
    g_down = win[..., 3:7, 2:6]
    b0 = b_full[..., 2:6, :]    # horizontal half at integer rows
    b1 = b_full[..., 3:7, :]    # ... one row below
    h0 = h_full[..., :, 2:6]    # vertical half at integer cols
    h1 = h_full[..., :, 3:7]    # ... one col right

    # frac position code = xFrac*4 + yFrac (lumaFracPos reconstruct.c:72)
    cases = [
        g,               # 0  G
        _avg(g, h0),     # 1  d
        h0,              # 2  h
        _avg(g_down, h0),  # 3  n
        _avg(g, b0),     # 4  a
        _avg(b0, h0),    # 5  e
        _avg(h0, j),     # 6  i
        _avg(b1, h0),    # 7  p
        b0,              # 8  b
        _avg(b0, j),     # 9  f
        j,               # 10 j
        _avg(b1, j),     # 11 q
        _avg(g_right, b0),  # 12 c
        _avg(b0, h1),    # 13 g
        _avg(h1, j),     # 14 k
        _avg(b1, h1),    # 15 r
    ]
    return torch.stack(cases, dim=1)


def predict_blocks(dpb_y, dpb_cb, dpb_cr, bx, by, mvx, mvy, slot):
    """Prediction of independent 4x4 luma blocks and their 2x2 chroma.

    bx, by: (nB,) luma position of each block's top-left pel; mvx, mvy:
    (nB,) quarter-pel MV; slot: (nB,) DPB slot (negative reads slot 0,
    as inter.py:113; indices past the ring clamp like a JAX gather).
    Returns int32 (nB, 4, 4) luma and (nB, 2, 2) Cb and Cr."""
    dev = dpb_y.device
    H, W = dpb_y.shape[1], dpb_y.shape[2]
    slot = slot.long().clamp(0, dpb_y.shape[0] - 1)
    mvx, mvy = mvx.long(), mvy.long()
    bx, by = bx.long(), by.long()

    # ---- luma ----
    x_int = bx + (mvx >> 2)
    y_int = by + (mvy >> 2)
    frac = (mvx & 3) * 4 + (mvy & 3)
    # border overfill == per-sample coordinate clamp (h264bsdFillBlock)
    r9 = torch.arange(9, device=dev)
    ys = (y_int[:, None] - 2 + r9[None, :]).clamp(0, H - 1)
    xs = (x_int[:, None] - 2 + r9[None, :]).clamp(0, W - 1)
    win = dpb_y[slot[:, None, None], ys[:, :, None],
                xs[:, None, :]].to(torch.int32)
    cases = luma_predict_blocks(win)                      # (nB, 16, 4, 4)
    pred = torch.gather(cases, 1, frac[:, None, None, None]
                        .expand(-1, 1, 4, 4))[:, 0]       # (nB, 4, 4)

    # ---- chroma (2x2 per 4x4 luma block, 1/8-pel bilinear) ----
    cx_int = (bx >> 1) + (mvx >> 3)
    cy_int = (by >> 1) + (mvy >> 3)
    xf = (mvx & 7)[:, None, None].to(torch.int32)
    yf = (mvy & 7)[:, None, None].to(torch.int32)
    r3 = torch.arange(3, device=dev)
    cys = (cy_int[:, None] + r3[None, :]).clamp(0, H // 2 - 1)
    cxs = (cx_int[:, None] + r3[None, :]).clamp(0, W // 2 - 1)

    def bilinear(plane):
        w = plane[slot[:, None, None], cys[:, :, None],
                  cxs[:, None, :]].to(torch.int32)        # (nB, 3, 3)
        a_ = w[:, 0:2, 0:2]
        b_ = w[:, 0:2, 1:3]
        c_ = w[:, 1:3, 0:2]
        d_ = w[:, 1:3, 1:3]
        return ((8 - xf) * (8 - yf) * a_ + xf * (8 - yf) * b_ +
                (8 - xf) * yf * c_ + xf * yf * d_ + 32) >> 6

    return pred, bilinear(dpb_cb), bilinear(dpb_cr)


def block_positions(mb, b, width_mbs, device):
    """Luma (bx, by) of raster block b of MB mb (int64 tensors)."""
    bxt = torch.as_tensor(BLOCK_X, device=device).long()
    byt = torch.as_tensor(BLOCK_Y, device=device).long()
    return ((mb % width_mbs) * 16 + bxt[b], (mb // width_mbs) * 16 + byt[b])


def inter_predict_frame(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, width_mbs,
                        height_mbs, mb_row_offset=0):
    """Motion-compensated prediction for every 4x4 block of the frame.

    Args:
      dpb_y: (nSlots, H, W) uint8; dpb_cb/dpb_cr: (nSlots, H/2, W/2) uint8.
      mv: (nMB, 16, 2) quarter-pel, raster blocks; ref_slot (nMB, 16).
      mb_row_offset: the first MB row's position in the reference frame
        (the row-sharded path, parallel/rowshard.py, predicts a stripe of
        the frame from whole reference frames: every coordinate clamps
        into the reference planes).

    Returns:
      pred_y (nMB, 16, 16), pred_cb/pred_cr (nMB, 8, 8) int32 predictions
      (valid only for inter MBs; garbage elsewhere, caller masks).
    """
    n_mb = mv.shape[0]
    n_blk = n_mb * 16
    dev = dpb_y.device
    blk = torch.arange(n_blk, device=dev)
    bx, by = block_positions(blk // 16, blk % 16, width_mbs, dev)
    by = by + 16 * mb_row_offset
    pred, pcb, pcr = predict_blocks(
        dpb_y, dpb_cb, dpb_cr, bx, by, mv.reshape(n_blk, 2)[:, 0],
        mv.reshape(n_blk, 2)[:, 1], ref_slot.reshape(n_blk))
    pred_y = pred.reshape(n_mb, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
    pred_y = pred_y.reshape(n_mb, 16, 16)

    def assemble(out):
        # (nMB, 8, 8) from 16 blocks' 2x2 patches
        out = out.reshape(n_mb, 4, 4, 2, 2).permute(0, 1, 3, 2, 4)
        return out.reshape(n_mb, 8, 8)

    return pred_y, assemble(pcb), assemble(pcr)


def mb_grid_to_plane(mbs, width_mbs, height_mbs):
    """(nMB, S, S) -> (height_mbs*S, width_mbs*S), contiguous."""
    s = mbs.shape[-1]
    x = mbs.reshape(height_mbs, width_mbs, s, s).permute(0, 2, 1, 3)
    return x.reshape(height_mbs * s, width_mbs * s).contiguous()


def plane_to_mb_grid(plane, size):
    h, w = plane.shape
    x = plane.reshape(h // size, size, w // size, size).permute(0, 2, 1, 3)
    return x.reshape(-1, size, size)
