"""In-loop deblocking filter over the whole picture: boundary strengths,
thresholds, and the plain PyTorch version of the deblocking kernels.

Behavioral parity: reference h264bsd_deblocking.c — per-MB filtering flags
(GetMbFilteringFlags :280 with slice-boundary handling), boundary strengths
(GetBoundaryStrengths :1187-1379; the mb-type specializations reduce to one
uniform rule because blocks of one partition share mv/ref), alpha/beta/tc0
thresholds from (possibly averaged) QP (:1390-1512), and the weak/strong
edge filters (FilterVerLumaEdge :656, FilterHorLuma(/Edge) :765/:840,
FilterVerChromaEdge :961, FilterHorChroma(/Edge) :1036/:1083).

bS values, filter flags and thresholds depend only on per-MB tensors and
are computed for every edge of the frame at once. Pixel filtering is
order-dependent (raster MB order, vertical edges left to right, then
horizontal top to bottom; later edges read pels written by earlier ones).
deblock_mbs filters a BATCH of MBs whose 20x20 windows are disjoint (one
MB, or the MBs of one anti-diagonal w = 2r + c: see
ops/cuda_deblock_wf.py), on int32 planes with a 4-pixel top/left pad so
every edge window stays in bounds; the pad is never filtered (edge bS is
0 at picture borders).
"""

from __future__ import annotations

import numpy as np
import torch

from .consts import const
from .transform import table

# threshold tables, spec Table 8-16 (reference deblocking.c:78-121)
ALPHAS = np.array([0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,4,4,5,6,7,8,9,10,12,13,
                   15,17,20,22,25,28,32,36,40,45,50,56,63,71,80,90,101,113,
                   127,144,162,182,203,226,255,255], np.int32)
BETAS = np.array([0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,2,2,2,3,3,3,3,4,4,4,6,6,
                  7,7,8,8,9,9,10,10,11,11,12,12,13,13,14,14,15,15,16,16,17,
                  17,18,18], np.int32)
TC0 = np.array([
    [0,0,0]]*17 + [[0,0,1],[0,0,1],[0,0,1],[0,0,1],[0,1,1],[0,1,1],[1,1,1],
    [1,1,1],[1,1,1],[1,1,1],[1,1,2],[1,1,2],[1,1,2],[1,1,2],[1,2,3],[1,2,3],
    [2,2,3],[2,2,4],[2,3,4],[2,3,4],[3,3,5],[3,4,6],[3,4,6],[4,5,7],[4,5,8],
    [4,6,9],[5,7,10],[6,8,11],[6,8,13],[7,10,14],[8,11,16],[9,12,18],
    [10,13,20],[11,15,23],[13,17,25]], np.int32)


def _is_intra_class(mb_class):
    # intra for deblocking: I4x4, I16x16, I_PCM, concealed
    return (mb_class >= 3) & (mb_class <= 6)


def _shift_prev(x, dim):
    """x shifted by one along `dim` of the MB grid, edge-replicated (the
    left/top neighbour of every MB; the border row/col repeats itself)."""
    first = x.narrow(dim, 0, 1)
    return torch.cat([first, x.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def boundary_strengths(mb_class, nnz, mv, ref_slot, slice_id, disable_dblk,
                       width_mbs, height_mbs):
    """Per-4x4-block boundary strengths for the whole frame.

    Returns bs_left, bs_top: (nMB, 16) int32 in raster block order
    (bS[k].left / bS[k].top of the reference, deblocking.c:1187-1379),
    already zeroed where the MB's filtering flags disable the edge.
    """
    n_mb = mb_class.shape[0]
    dev = mb_class.device
    grid = lambda x: x.reshape((height_mbs, width_mbs) + tuple(x.shape[1:]))
    cls = grid(mb_class.long())
    nnz_l = grid(nnz[:, :16] != 0)
    mvg = grid(mv.long())
    ref = grid(ref_slot.long())
    sid = grid(slice_id.long())
    dis = grid(disable_dblk.long())
    intra = _is_intra_class(cls)

    def pair_bs(n1, m1, r1, n2, m2, r2):
        # uniform InnerBoundaryStrength/EdgeBoundaryStrength rule
        # (deblocking.c:324-419): coeffs -> 2; mv/ref mismatch -> 1; else 0
        mv_diff = ((m1[..., 0] - m2[..., 0]).abs() >= 4) | \
                  ((m1[..., 1] - m2[..., 1]).abs() >= 4) | (r1 != r2)
        return torch.where(n1 | n2, 2, torch.where(mv_diff, 1, 0))

    # inner edges (within MB)
    blocks = torch.arange(16, device=dev)
    left_nb = (blocks - 1) % 16          # used only where col > 0
    top_nb = (blocks - 4) % 16           # used only where row > 0
    inner_left = pair_bs(nnz_l, mvg, ref, nnz_l[..., left_nb],
                         mvg[..., left_nb, :], ref[..., left_nb])
    inner_top = pair_bs(nnz_l, mvg, ref, nnz_l[..., top_nb],
                        mvg[..., top_nb, :], ref[..., top_nb])
    inner_left = torch.where(intra[..., None], 3, inner_left)
    inner_top = torch.where(intra[..., None], 3, inner_top)

    # MB-edge values. left edge: blocks {0,4,8,12} vs A's {3,7,11,15}
    cur_l = torch.arange(0, 16, 4, device=dev)
    nb_l = cur_l + 3
    a_cls, a_nnz, a_mv, a_ref, a_sid = (_shift_prev(x, 1) for x in
                                        (cls, nnz_l, mvg, ref, sid))
    edge_left = pair_bs(nnz_l[..., cur_l], mvg[..., cur_l, :],
                        ref[..., cur_l], a_nnz[..., nb_l],
                        a_mv[..., nb_l, :], a_ref[..., nb_l])
    edge_left = torch.where((intra | _is_intra_class(a_cls))[..., None], 4,
                            edge_left)
    # top edge: blocks {0,1,2,3} vs B's {12,13,14,15}
    cur_t = torch.arange(4, device=dev)
    nb_t = cur_t + 12
    b_cls, b_nnz, b_mv, b_ref, b_sid = (_shift_prev(x, 0) for x in
                                        (cls, nnz_l, mvg, ref, sid))
    edge_top = pair_bs(nnz_l[..., cur_t], mvg[..., cur_t, :],
                       ref[..., cur_t], b_nnz[..., nb_t],
                       b_mv[..., nb_t, :], b_ref[..., nb_t])
    edge_top = torch.where((intra | _is_intra_class(b_cls))[..., None], 4,
                           edge_top)

    # filtering flags (GetMbFilteringFlags :280)
    col = torch.arange(width_mbs, device=dev)[None, :]
    row = torch.arange(height_mbs, device=dev)[:, None]
    enabled = dis != 1
    f_left = enabled & (col > 0) & ((dis != 2) | (sid == a_sid))
    f_top = enabled & (row > 0) & ((dis != 2) | (sid == b_sid))

    bs_left = torch.where(enabled[..., None], inner_left, 0)
    bs_left[..., cur_l] = torch.where(f_left[..., None], edge_left, 0)
    bs_top = torch.where(enabled[..., None], inner_top, 0)
    bs_top[..., cur_t] = torch.where(f_top[..., None], edge_top, 0)
    return (bs_left.reshape(n_mb, 16).to(torch.int32).contiguous(),
            bs_top.reshape(n_mb, 16).to(torch.int32).contiguous())


def edge_thresholds(qp_y, slice_id, filter_off_a, filter_off_b,
                    chroma_qp_offset, width_mbs, height_mbs, chroma):
    """(alpha, beta, tc0) per MB for the INNER/TOP/LEFT edge classes
    (GetLumaEdgeThresholds :1390 / GetChromaEdgeThresholds :1462):
    (nMB, 3) / (nMB, 3) / (nMB, 3, 3) int32, indexed [mb, cls] with
    cls 0=inner, 1=top, 2=left."""
    dev = qp_y.device
    grid = lambda x: x.long().reshape(height_mbs, width_mbs)
    qp = grid(qp_y)
    offa = grid(filter_off_a)
    offb = grid(filter_off_b)
    qp_a = _shift_prev(qp, 1)
    qp_b = _shift_prev(qp, 0)

    def qmap(q):
        if chroma:
            off = grid(chroma_qp_offset)
            return table("QP_C", dev)[(q + off).clamp(0, 51)]
        return q

    qp_inner = qmap(qp)
    # averaged QP across MB edges; the reference averages the *mapped*
    # chroma QPs (GetChromaEdgeThresholds :1478-1484)
    qp_top = (qp_inner + qmap(qp_b) + 1) >> 1
    qp_left = (qp_inner + qmap(qp_a) + 1) >> 1
    qps = torch.stack([qp_inner, qp_top, qp_left], dim=-1)   # (h, w, 3)
    idx_a = (qps + offa[..., None]).clamp(0, 51)
    idx_b = (qps + offb[..., None]).clamp(0, 51)
    alpha = const("ALPHAS", ALPHAS, dev, torch.int64)[idx_a].reshape(-1, 3)
    beta = const("BETAS", BETAS, dev, torch.int64)[idx_b].reshape(-1, 3)
    tc0 = const("TC0", TC0, dev, torch.int64)[idx_a].reshape(-1, 3, 3)
    return (alpha.to(torch.int32).contiguous(),
            beta.to(torch.int32).contiguous(),
            tc0.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Edge filters, vectorized over the pels along the edges.
# p/q: (N, 4) int with p[:, k] = p_k, q[:, k] = q_k; bs, alpha, beta,
# tc0v: (N,) with tc0v = tc0[cls][clip(bs-1, 0, 2)]. Return new (p, q).
# ---------------------------------------------------------------------------

def _filter_luma_edge(p, q, bs, alpha, beta, tc0v):
    p0, p1, p2, p3 = p.unbind(1)
    q0, q1, q2, q3 = q.unbind(1)
    w = torch.where
    on = (bs > 0) & ((p0 - q0).abs() < alpha) & \
         ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)

    # weak filter (bS < 4), FilterVerLumaEdge :681-722
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    avg = (p0 + q0 + 1) >> 1
    p1w = p1 + torch.clamp((p2 + avg - p1 * 2) >> 1, -tc0v, tc0v)
    q1w = q1 + torch.clamp((q2 + avg - q1 * 2) >> 1, -tc0v, tc0v)
    tc = tc0v + ap.int() + aq.int()
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0w = (p0 + delta).clamp(0, 255)
    q0w = (q0 - delta).clamp(0, 255)

    # strong filter (bS == 4), :723-759
    sflag = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = sflag & ap
    sq = sflag & aq
    tp = p1 + p0 + q0
    p0s = w(sp, (p2 + 2 * tp + q1 + 4) >> 3, (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = w(sp, (p2 + tp + 2) >> 2, p1)
    p2s = w(sp, (2 * p3 + 3 * p2 + tp + 4) >> 3, p2)
    tq = p0 + q0 + q1
    q0s = w(sq, (p1 + 2 * tq + q2 + 4) >> 3, (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = w(sq, (tq + q2 + 2) >> 2, q1)
    q2s = w(sq, (2 * q3 + 3 * q2 + tq + 4) >> 3, q2)

    strong = bs == 4
    new_p = (w(strong, p0s, p0w), w(strong, p1s, w(ap, p1w, p1)),
             w(strong, p2s, p2))
    new_q = (w(strong, q0s, q0w), w(strong, q1s, w(aq, q1w, q1)),
             w(strong, q2s, q2))
    p = torch.stack([w(on, a, b) for a, b in zip(new_p, (p0, p1, p2))]
                    + [p3], 1)
    q = torch.stack([w(on, a, b) for a, b in zip(new_q, (q0, q1, q2))]
                    + [q3], 1)
    return p, q


def _filter_chroma_edge(p, q, bs, alpha, beta, tc0v):
    # FilterVerChromaEdge :961-1030: 2-pel reach, tc = tc0 + 1
    p0, p1 = p[:, 0], p[:, 1]
    q0, q1 = q[:, 0], q[:, 1]
    w = torch.where
    on = (bs > 0) & ((p0 - q0).abs() < alpha) & \
         ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    tc = tc0v + 1
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0w = (p0 + delta).clamp(0, 255)
    q0w = (q0 - delta).clamp(0, 255)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    strong = bs == 4
    new_p0 = w(on, w(strong, p0s, p0w), p0)
    new_q0 = w(on, w(strong, q0s, q0w), q0)
    return (torch.stack([new_p0, p1], 1), torch.stack([new_q0, q1], 1))


# ---------------------------------------------------------------------------
# Batched per-MB filtering on padded int32 planes.
# ---------------------------------------------------------------------------

def _tc_for(tc0, cls, bs):
    """tc0[mb][cls][clip(bs-1, 0, 2)] for (B, k) bs and (B,) tc0 rows."""
    return torch.gather(tc0[:, cls], 1, (bs - 1).clamp(0, 2))


def _edge_pass(plane, ys, xs, reach, bs, alpha, beta, tc0v, vertical,
               filt):
    """Filter one edge of every MB in the batch. The edge runs along
    `bs.shape[1]` pels; ys/xs: (B,) padded-plane coordinates of the
    first q pel. p_k sits `k+1` pels before the edge, q_k `k` after."""
    b, n = bs.shape
    dev = plane.device
    along = torch.arange(n, device=dev)
    k = torch.arange(reach, device=dev)
    if vertical:
        rows = (ys[:, None, None] + along[None, :, None]).expand(b, n, reach)
        pc = xs[:, None, None] - 1 - k[None, None, :]
        qc = xs[:, None, None] + k[None, None, :]
        pi, qi = (rows, pc.expand(b, n, reach)), (rows, qc.expand(b, n, reach))
    else:
        cols = (xs[:, None, None] + along[None, :, None]).expand(b, n, reach)
        pr = ys[:, None, None] - 1 - k[None, None, :]
        qr = ys[:, None, None] + k[None, None, :]
        pi, qi = (pr.expand(b, n, reach), cols), (qr.expand(b, n, reach), cols)
    p = plane[pi].reshape(b * n, reach)
    q = plane[qi].reshape(b * n, reach)
    rep = lambda v: v[:, None].expand(b, n).reshape(-1)
    p, q = filt(p, q, bs.reshape(-1), rep(alpha), rep(beta),
                tc0v.reshape(-1))
    plane[pi] = p.reshape(b, n, reach)
    plane[qi] = q.reshape(b, n, reach)


def deblock_mbs(yp, cp, ids, bs_left, bs_top, luma_thr, chroma_thr,
                width_mbs):
    """Filter the MBs `ids` ((B,) long; 20x20 windows pairwise disjoint)
    in place. yp: (H+4, W+4) int32 padded luma; cp: (2, Hc+4, Wc+4)
    int32 padded [cb, cr]."""
    l_alpha, l_beta, l_tc0 = (t[ids] for t in luma_thr)
    c_alpha, c_beta, c_tc0 = (t[ids] for t in chroma_thr)
    bl, bt = bs_left[ids].long(), bs_top[ids].long()
    mx = (ids % width_mbs) * 16 + 4
    my = (ids // width_mbs) * 16 + 4
    dev = yp.device
    r16 = torch.arange(16, device=dev)
    r8 = torch.arange(8, device=dev)
    # luma: vertical edges left to right, then horizontal top to bottom;
    # each 4-pel group of an edge takes the bS of its block
    for e in range(4):
        cls = 2 if e == 0 else 0
        bs = bl[:, r16 // 4 * 4 + e]
        _edge_pass(yp, my, mx + 4 * e, 4, bs, l_alpha[:, cls],
                   l_beta[:, cls], _tc_for(l_tc0, cls, bs), True,
                   _filter_luma_edge)
    for v in range(4):
        cls = 1 if v == 0 else 0
        bs = bt[:, v * 4 + r16 // 4]
        _edge_pass(yp, my + 4 * v, mx, 4, bs, l_alpha[:, cls],
                   l_beta[:, cls], _tc_for(l_tc0, cls, bs), False,
                   _filter_luma_edge)
    # chroma (cb and cr stacked as one batch): edges at chroma cols/rows
    # 0 and 4; each luma block-row bS covers 2 chroma pels
    cx = (mx - 4) // 2 + 4
    cy = (my - 4) // 2 + 4
    for plane in (cp[0], cp[1]):
        for e in range(2):
            cls = 2 if e == 0 else 0
            bs = bl[:, (r8 // 2) * 4 + e * 2]
            _edge_pass(plane, cy, cx + 4 * e, 2, bs, c_alpha[:, cls],
                       c_beta[:, cls], _tc_for(c_tc0, cls, bs), True,
                       _filter_chroma_edge)
        for v in range(2):
            cls = 1 if v == 0 else 0
            bs = bt[:, v * 2 * 4 + r8 // 2]
            _edge_pass(plane, cy + 4 * v, cx, 2, bs, c_alpha[:, cls],
                       c_beta[:, cls], _tc_for(c_tc0, cls, bs), False,
                       _filter_chroma_edge)


def pad_planes(y, cb, cr):
    """int32 planes with the 4-pixel top/left pad (yp, cp[2])."""
    pad = lambda p: torch.nn.functional.pad(p.int(), (4, 0, 4, 0))
    return pad(y), torch.stack([pad(cb), pad(cr)])


def unpad_into(y, cb, cr, yp, cp):
    """Store padded int32 planes back into the uint8 planes, in place."""
    y.copy_(yp[4:, 4:])
    cb.copy_(cp[0, 4:, 4:])
    cr.copy_(cp[1, 4:, 4:])
    return y, cb, cr


def deblock_walk(y, cb, cr, groups, bs_left, bs_top, luma_thr, chroma_thr,
                 width_mbs):
    """Filter the MB groups (each group's windows disjoint, groups in
    dependency order) in place on the uint8 planes; returns them."""
    yp, cp = pad_planes(y, cb, cr)
    dev = y.device
    for g in groups:
        if g:
            deblock_mbs(yp, cp, torch.as_tensor(g, device=dev), bs_left,
                        bs_top, luma_thr, chroma_thr, width_mbs)
    return unpad_into(y, cb, cr, yp, cp)


def anti_diagonals(width_mbs, height_mbs):
    """MB ids of every anti-diagonal w = 2r + c, in order of w. Each
    dependency of an MB (left, above-left, above, above-right) lies on an
    earlier diagonal, and the MBs of one diagonal are (+1 row, -2 cols)
    apart, so neither their deblocking windows nor their intra read
    rectangles overlap the pels another MB of the diagonal writes."""
    return [[r * width_mbs + w - 2 * r
             for r in range(max(0, (w - width_mbs + 2) // 2),
                            min(height_mbs - 1, w // 2) + 1)]
            for w in range(2 * (height_mbs - 1) + width_mbs)]


def deblock_frame_with_bs(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr,
                          width_mbs, height_mbs):
    """The order-dependent pixel half of deblock_frame: filters MB by MB
    in raster order, in place."""
    groups = [[i] for i in range(width_mbs * height_mbs)]
    return deblock_walk(y, cb, cr, groups, bs_left, bs_top, luma_thr,
                        chroma_thr, width_mbs)


def deblock_params(mb_class, nnz, mv, ref_slot, slice_id, disable_dblk,
                   qp_y, filter_off_a, filter_off_b, chroma_qp_offset,
                   width_mbs, height_mbs):
    """(bs_left, bs_top, luma_thr, chroma_thr) of a frame."""
    bs_left, bs_top = boundary_strengths(
        mb_class, nnz, mv, ref_slot, slice_id, disable_dblk, width_mbs,
        height_mbs)
    thr = [edge_thresholds(qp_y, slice_id, filter_off_a, filter_off_b,
                           chroma_qp_offset, width_mbs, height_mbs, c)
           for c in (False, True)]
    return bs_left, bs_top, thr[0], thr[1]


def deblock_frame(y, cb, cr, mb_class, nnz, mv, ref_slot, slice_id,
                  disable_dblk, qp_y, filter_off_a, filter_off_b,
                  chroma_qp_offset, width_mbs, height_mbs):
    """Filter the whole picture in place (reference h264bsdFilterPicture
    deblocking.c:575-640), raster order. Returns (y, cb, cr) uint8."""
    bs_left, bs_top, lt, ct = deblock_params(
        mb_class, nnz, mv, ref_slot, slice_id, disable_dblk, qp_y,
        filter_off_a, filter_off_b, chroma_qp_offset, width_mbs, height_mbs)
    return deblock_frame_with_bs(y, cb, cr, bs_left, bs_top, lt, ct,
                                 width_mbs, height_mbs)
