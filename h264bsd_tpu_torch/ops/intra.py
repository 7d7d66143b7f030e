"""Intra prediction (Intra_4x4, Intra_16x16, chroma): the plain PyTorch
version of the intra kernels.

Behavioral parity: reference h264bsd_intra_prediction.c — the nine 4x4
modes (:1486-1825), four 16x16 modes (:993-1153), four chroma modes
(:1160-1380), neighbour-pel gathering (:545-614 / :1390-1470) and
prediction+residual+clip combining (h264bsdAddResidual :927).

The host has already resolved per-block modes and availability
(mbparse.cpp), so this stage is pure pixel math. A 4x4 block predicts
from the reconstructed pels of its left/above neighbours, which
serializes the blocks of an MB (zigzag order) and the MBs along
anti-diagonals t = 2r + c. The functions here take a BATCH of MBs whose
reads and writes are independent (one MB, or the intra MBs of one
anti-diagonal) and write it in place into uint8 planes; intra_pass and
intra_pass_list walk the MBs in decode order, one MB per step.

Every neighbour read clamps its address into the picture as the JAX
package does; the clamped pels feed only unavailable-neighbour paths.
Arithmetic is int32; planes are uint8.

The eight directional 4x4 modes are fixed integer stencils over the 13
neighbour pels n = [D, above*4, above-right*4, left*4]: every output pel
is (w . n + 2) >> 2 with weights summing to 4 ((x + y + 1) >> 1 is
(2x + 2y + 2) >> 2, a copy is (4x + 2) >> 2). I4_WEIGHTS holds them; the
CUDA kernels read the same table.
"""

from __future__ import annotations

import numpy as np
import torch

# raster block position within the MB (x, y) in pels
BLOCK_X = np.array([0, 4, 8, 12] * 4, np.int32)
BLOCK_Y = np.repeat(np.arange(4) * 4, 4).astype(np.int32)
# zigzag processing order -> raster block index
ZIG2RAS = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
                   np.int32)

AVAIL_A, AVAIL_B, AVAIL_C, AVAIL_D = 1, 2, 4, 8


def _build_i4_weights() -> np.ndarray:
    """(9, 16, 13) int32: per mode, per raster pel (4*y + x), weights on
    n = [D, A1..A8, L1..L4] (DC, mode 2, is all zeros and computed
    separately). Transcribed from the reference formulas (see the
    per-mode line anchors in the module docstring of the JAX package's
    ops/intra.py)."""
    def e(i):
        v = np.zeros(13, np.int32)
        v[i] = 1
        return v

    A = lambda k: k                  # above row: A(0) is the corner D
    L = lambda k: 0 if k == 0 else 8 + k   # left column: L(0) is D
    m = lambda x, y, z: e(x) + 2 * e(y) + e(z)      # (x + 2y + z + 2) >> 2
    h2 = lambda x, y: 2 * e(x) + 2 * e(y)           # (x + y + 1) >> 1
    cp = lambda x: 4 * e(x)                         # copy

    w = np.zeros((9, 4, 4, 13), np.int32)
    for yy in range(4):
        for xx in range(4):
            w[0, yy, xx] = cp(A(1 + xx))                         # vertical
            w[1, yy, xx] = cp(L(1 + yy))                         # horizontal
    # diagonal down-left (:1598)
    p = [A(1 + k) for k in range(8)]
    f = [m(p[k], p[k + 1], p[k + 2]) for k in range(6)]
    f.append(e(p[6]) + 3 * e(p[7]))
    for yy in range(4):
        for xx in range(4):
            w[3, yy, xx] = f[xx + yy]
    # diagonal down-right (:1637): index 3 + x - y
    diag = [m(L(2), L(3), L(4)), m(L(1), L(2), L(3)), m(L(0), L(1), L(2)),
            m(A(1), A(0), L(1)), m(A(0), A(1), A(2)), m(A(1), A(2), A(3)),
            m(A(2), A(3), A(4))]
    for yy in range(4):
        for xx in range(4):
            w[4, yy, xx] = diag[3 + xx - yy]
    # vertical-right (:1672)
    ev = [h2(A(k), A(k + 1)) for k in range(4)]
    od = [m(A(1), A(0), L(1)), m(A(0), A(1), A(2)), m(A(1), A(2), A(3)),
          m(A(2), A(3), A(4))]
    r8 = m(L(2), L(1), L(0))
    r12 = m(L(3), L(2), L(1))
    rows = [ev, od, [r8] + ev[:3], [r12] + od[:3]]
    w[5] = np.array(rows)
    # horizontal-down (:1707)
    eh = [h2(L(k), L(k + 1)) for k in range(4)]
    oh = [m(A(1), A(0), L(1)), m(L(0), L(1), L(2)), m(L(1), L(2), L(3)),
          m(L(2), L(3), L(4))]
    t2 = m(A(2), A(1), A(0))
    t3 = m(A(3), A(2), A(1))
    w[6] = np.array([[eh[0], oh[0], t2, t3], [eh[1], oh[1], eh[0], oh[0]],
                     [eh[2], oh[2], eh[1], oh[1]],
                     [eh[3], oh[3], eh[2], oh[2]]])
    # vertical-left (:1762)
    p = [A(1 + k) for k in range(7)]
    hv = [h2(p[k], p[k + 1]) for k in range(5)]
    mv = [m(p[k], p[k + 1], p[k + 2]) for k in range(5)]
    w[7] = np.array([hv[0:4], mv[0:4], hv[1:5], mv[1:5]])
    # horizontal-up (:1802)
    p = [L(1 + k) for k in range(4)]
    v = [h2(p[0], p[1]), m(p[0], p[1], p[2]), h2(p[1], p[2]),
         m(p[1], p[2], p[3]), h2(p[2], p[3]), e(p[2]) + 3 * e(p[3]),
         cp(p[3])]
    w[8] = np.array([[v[0], v[1], v[2], v[3]], [v[2], v[3], v[4], v[5]],
                     [v[4], v[5], v[6], v[6]], [v[6], v[6], v[6], v[6]]])
    w = w.reshape(9, 16, 13)
    sums = w.sum(-1)
    assert (sums[[0, 1, 3, 4, 5, 6, 7, 8]] == 4).all() and (sums[2] == 0).all()
    return w


I4_WEIGHTS = _build_i4_weights()

_CONSTS: dict = {}


def _const(name, arr, device):
    key = (name, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(arr, device=device)
    return _CONSTS[key]


def i4_weights(device) -> torch.Tensor:
    """I4_WEIGHTS as a contiguous int32 tensor on `device`, cached."""
    return _const("i4w", I4_WEIGHTS, device)


def _clip8(x):
    return x.clamp(0, 255)


def _dc_select(avail, both, only_a, only_b):
    a = (avail & AVAIL_A) != 0
    b = (avail & AVAIL_B) != 0
    return torch.where(a & b, both, torch.where(
        a, only_a, torch.where(b, only_b, 128)))


# ---------------------------------------------------------------------------
# Predictors, batched over a leading dimension B.
# ---------------------------------------------------------------------------

def predict_4x4(mode, n, avail):
    """mode, avail: (B,) int; n: (B, 13) int32 neighbours [D, above*4,
    above-right*4, left*4]. Returns (B, 4, 4) int32. When above-right is
    unavailable the reference replicates above[3] into it (:794-797,
    :817-820); applied for all modes (only modes 3/7 read it). Mode
    indices clamp into 0..8 as lax.switch does."""
    b = n.shape[0]
    avail_c = ((avail & AVAIL_C) != 0)[:, None]
    n = torch.cat([n[:, :5], torch.where(avail_c, n[:, 5:9], n[:, 4:5]),
                   n[:, 9:]], dim=1)
    mode = mode.long().clamp(0, 8)
    w = i4_weights(n.device)[mode]                        # (B, 16, 13)
    lin = ((w * n[:, None, :]).sum(-1) + 2) >> 2
    sa = n[:, 1:5].sum(1)
    sl = n[:, 9:13].sum(1)
    dc = _dc_select(avail, (sa + sl + 4) >> 3, (sl + 2) >> 2, (sa + 2) >> 2)
    out = torch.where((mode == 2)[:, None], dc[:, None], lin)
    return out.to(torch.int32).reshape(b, 4, 4)


def predict_16x16(mode, above, left, avail):
    """above: (B, 17) [D, above*16]; left: (B, 16). Returns (B, 16, 16)
    int32: 0 vertical, 1 horizontal, 2 DC, 3 plane (:993-1153)."""
    a = above[:, 1:]
    bsz = a.shape[0]
    dev = a.device
    x = torch.arange(16, device=dev)
    sa = a.sum(1)
    sl = left.sum(1)
    dc = _dc_select(avail, (sa + sl + 16) >> 5, (sl + 8) >> 4, (sa + 8) >> 4)
    # plane (:1107-1152): the i=7 terms of both gradients read the corner
    av = 16 * (a[:, 15] + left[:, 15])
    rev = torch.arange(6, -1, -1, device=dev)
    k = torch.arange(1, 9, device=dev)
    apad = torch.cat([a[:, rev], above[:, :1]], dim=1)
    bg = ((5 * (k * (a[:, 8:16] - apad)).sum(1) + 32) >> 6)
    lpad = torch.cat([left[:, rev], above[:, :1]], dim=1)
    cg = ((5 * (k * (left[:, 8:16] - lpad)).sum(1) + 32) >> 6)
    plane = _clip8((av[:, None, None] + bg[:, None, None] * (x[None, None, :] - 7)
                    + cg[:, None, None] * (x[None, :, None] - 7) + 16) >> 5)
    mode = mode.long().clamp(0, 3)[:, None, None]
    out = torch.where(mode == 0, a[:, None, :].expand(bsz, 16, 16),
                      torch.where(mode == 1, left[:, :, None].expand(
                          bsz, 16, 16),
                          torch.where(mode == 2, dc[:, None, None], plane)))
    return out.to(torch.int32)


def predict_chroma(mode, above, left, avail):
    """above: (B, 9) [D, above*8]; left: (B, 8). Returns (B, 8, 8) int32:
    0 DC, 1 horizontal, 2 vertical, 3 plane (:1160-1380)."""
    a = above[:, 1:]
    bsz = a.shape[0]
    dev = a.device
    av_a = ((avail & AVAIL_A) != 0)
    av_b = ((avail & AVAIL_B) != 0)
    sa0, sa1 = a[:, 0:4].sum(1), a[:, 4:8].sum(1)
    sl0, sl1 = left[:, 0:4].sum(1), left[:, 4:8].sum(1)
    w = torch.where
    # quadrant DC with the reference's availability preferences
    tl = w(av_a & av_b, (sa0 + sl0 + 4) >> 3,
           w(av_b, (sa0 + 2) >> 2, w(av_a, (sl0 + 2) >> 2, 128)))
    tr = w(av_b, (sa1 + 2) >> 2, w(av_a, (sl0 + 2) >> 2, 128))
    bl = w(av_a, (sl1 + 2) >> 2, w(av_b, (sa0 + 2) >> 2, 128))
    br = w(av_a & av_b, (sa1 + sl1 + 4) >> 3,
           w(av_a, (sl1 + 2) >> 2, w(av_b, (sa1 + 2) >> 2, 128)))
    x = torch.arange(8, device=dev)
    top = (x < 4)[None, :, None]
    lft = (x < 4)[None, None, :]
    dc = w(top, w(lft, tl[:, None, None], tr[:, None, None]),
           w(lft, bl[:, None, None], br[:, None, None]))
    # plane (:1327-1380)
    avg = 16 * (a[:, 7] + left[:, 7])
    corner = above[:, 0]
    bg = (a[:, 4] - a[:, 2]) + 2 * (a[:, 5] - a[:, 1]) + \
        3 * (a[:, 6] - a[:, 0]) + 4 * (a[:, 7] - corner)
    bg = (17 * bg + 16) >> 5
    cg = (left[:, 4] - left[:, 2]) + 2 * (left[:, 5] - left[:, 1]) + \
        3 * (left[:, 6] - left[:, 0]) + 4 * (left[:, 7] - corner)
    cg = (17 * cg + 16) >> 5
    plane = _clip8((avg[:, None, None] + 16
                    + bg[:, None, None] * (x[None, None, :] - 3)
                    + cg[:, None, None] * (x[None, :, None] - 3)) >> 5)
    mode = mode.long().clamp(0, 3)[:, None, None]
    out = w(mode == 0, dc,
            w(mode == 1, left[:, :, None].expand(bsz, 8, 8),
              w(mode == 2, a[:, None, :].expand(bsz, 8, 8), plane)))
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# Per-MB reconstruction of a batch of independent MBs, in place.
# ---------------------------------------------------------------------------

def _edges(plane, x0, y0, size):
    """(above (B, size+1) [corner, above*size], left (B, size)) int32 of
    the size x size squares at pel positions (x0, y0), addresses clamped
    into the plane."""
    dev = plane.device
    ar = torch.arange(size, device=dev)
    top = (y0 - 1).clamp(min=0)
    lc = (x0 - 1).clamp(min=0)
    corner = plane[top, lc].int()[:, None]
    above = plane[top[:, None], x0[:, None] + ar].int()
    left = plane[y0[:, None] + ar, lc[:, None]].int()
    return torch.cat([corner, above], dim=1), left


def _store(plane, x0, y0, vals):
    """Write (B, s, s) int32 values at pel positions (x0, y0), in place."""
    s = vals.shape[-1]
    ar = torch.arange(s, device=plane.device)
    plane[(y0[:, None, None] + ar[None, :, None]),
          (x0[:, None, None] + ar[None, None, :])] = vals.to(torch.uint8)


def intra_mb_luma(y, mb_x, mb_y, is_i4, i4_modes, i4_avail, i16_mode,
                  mb_avail, resid_luma):
    """Reconstruct the luma of a batch of intra MBs in place on the
    (H, W) uint8 plane. mb_x/mb_y: (B,) pel positions; is_i4: (B,) bool;
    i4_modes/i4_avail: (B, 16); resid_luma: (B, 16, 16) int32."""
    height, width = y.shape
    dev = y.device
    sel = torch.nonzero(is_i4).flatten()
    if sel.numel():
        x0, y0 = mb_x[sel], mb_y[sel]
        modes, avail, res = i4_modes[sel], i4_avail[sel], resid_luma[sel]
        ar9 = torch.arange(9, device=dev)
        ar4 = torch.arange(4, device=dev)
        for r in ZIG2RAS.tolist():
            bxo, byo = int(BLOCK_X[r]), int(BLOCK_Y[r])
            bx, by = x0 + bxo, y0 + byo
            # a: [corner, above*4, above-right*4] from row by-1 with
            # clamped columns; l: column bx-1 (never overflows rows)
            row = (by - 1).clamp(min=0)
            a = y[row[:, None], (bx[:, None] - 1 + ar9).clamp(0, width - 1)]
            left = y[by[:, None] + ar4, (bx - 1).clamp(min=0)[:, None]]
            n = torch.cat([a, left], dim=1).int()
            pred = predict_4x4(modes[:, r], n, avail[:, r].int())
            out = _clip8(pred + res[:, byo:byo + 4, bxo:bxo + 4])
            _store(y, bx, by, out)
    sel = torch.nonzero(~is_i4).flatten()
    if sel.numel():
        x0, y0 = mb_x[sel], mb_y[sel]
        above, left = _edges(y, x0, y0, 16)
        pred = predict_16x16(i16_mode[sel], above, left, mb_avail[sel].int())
        _store(y, x0, y0, _clip8(pred + resid_luma[sel]))


def intra_mb_chroma(plane, cb_x, cb_y, mode, mb_avail, resid):
    """One chroma plane of a batch of intra MBs, in place. cb_x/cb_y:
    (B,) chroma pel positions; resid: (B, 8, 8) int32."""
    above, left = _edges(plane, cb_x, cb_y, 8)
    pred = predict_chroma(mode, above, left, mb_avail.int())
    _store(plane, cb_x, cb_y, _clip8(pred + resid))


def intra_mbs(y, cb, cr, ids, mb_class, i4_modes, i4_avail, mb_avail,
              i16_mode, chroma_mode, resid_luma, resid_chroma, width_mbs):
    """Reconstruct the MBs `ids` ((B,) long, all intra, reads and writes
    independent of each other) in place."""
    mb_x = (ids % width_mbs) * 16
    mb_y = (ids // width_mbs) * 16
    intra_mb_luma(y, mb_x, mb_y, mb_class[ids] == 3, i4_modes[ids],
                  i4_avail[ids], i16_mode[ids], mb_avail[ids],
                  resid_luma[ids])
    for p, plane in enumerate((cb, cr)):
        intra_mb_chroma(plane, mb_x // 2, mb_y // 2, chroma_mode[ids],
                        mb_avail[ids], resid_chroma[ids, p])


def _is_intra(mb_class):
    return (mb_class == 3) | (mb_class == 4)


def intra_walk(y, cb, cr, groups, mb_class, i4_modes, i4_avail, mb_avail,
               i16_mode, chroma_mode, resid_luma, resid_chroma, width_mbs):
    """Reconstruct the groups (lists of MB ids, each group independent,
    groups in dependency order) in place; returns the planes."""
    dev = y.device
    for g in groups:
        if g:
            intra_mbs(y, cb, cr, torch.as_tensor(g, device=dev), mb_class,
                      i4_modes, i4_avail, mb_avail, i16_mode, chroma_mode,
                      resid_luma, resid_chroma, width_mbs)
    return y, cb, cr


def intra_pass(y_plane, cb_plane, cr_plane, mb_class, i4_modes, i4_avail,
               mb_avail, i16_mode, chroma_mode, resid_luma, resid_chroma,
               width_mbs):
    """Sequential raster pass: intra MBs (class 3/4) are reconstructed in
    place, one MB per step; everything else is untouched."""
    ids = torch.nonzero(_is_intra(mb_class)).flatten().tolist()
    return intra_walk(y_plane, cb_plane, cr_plane, [[i] for i in ids],
                      mb_class, i4_modes, i4_avail, mb_avail, i16_mode,
                      chroma_mode, resid_luma, resid_chroma, width_mbs)


def intra_pass_list(y_plane, cb_plane, cr_plane, intra_mbs_, mb_class,
                    i4_modes, i4_avail, mb_avail, i16_mode, chroma_mode,
                    resid_luma, resid_chroma, width_mbs):
    """Sequential pass over an explicit decode-ordered intra-MB id list
    (padded with ids outside 0..nMB-1, which are skipped)."""
    n_mbs = mb_class.shape[0]
    intra = _is_intra(mb_class).tolist()
    ids = [i for i in intra_mbs_.reshape(-1).tolist()
           if 0 <= i < n_mbs and intra[i]]
    return intra_walk(y_plane, cb_plane, cr_plane, [[i] for i in ids],
                      mb_class, i4_modes, i4_avail, mb_avail, i16_mode,
                      chroma_mode, resid_luma, resid_chroma, width_mbs)
