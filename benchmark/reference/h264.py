"""Plain NumPy reference of H.264 Baseline picture reconstruction (ITU-T
H.264 (08/2021) clauses 8.2.4-8.2.5, 8.3.1-8.3.4, 8.4, 8.5.12 and 8.7),
for the pictures the benchmark's streams carry.

It decodes again, from the syntax record that streamgen.make_motion_gop
kept of every element it wrote, what the program decodes from the bytes:
motion-vector prediction (8.4.1), luma and chroma sample interpolation
(8.4.2.2), dequantisation and the inverse transform (8.5.12), Intra_4x4
and chroma DC prediction (8.3.1.2.3, 8.3.4.1-3), the deblocking filter
with its boundary strengths (8.7), and sliding-window reference marking
with descending-PicNum reference lists (8.2.4-8.2.5). Pictures are output
in decoding order (pic_order_cnt_type 2).

It covers what the records hold and refuses the rest (NotImplementedError):
one slice per picture, all P or I, CAVLC, no weighted prediction, the
deblocking filter on with zero offsets, chroma_qp_index_offset 0, every
I_4x4 block on its predicted mode, no chroma residual. With every I_4x4
block of every picture on its predicted mode and the first picture all
I_4x4, every Intra4x4PredMode is DC (8.3.1.1: an unavailable or non-I_4x4
neighbour counts as DC, and min(DC, DC) is DC), so DC is the one 4x4 mode
built here.

Nothing here imports the program. Motion-vector prediction is plain
Python per picture (it needs no samples, so pictures go to worker
processes); the pixel stages are plain torch on any device, picture k
of several GOPs of one size at once (an IDR picture clears the DPB, so
GOPs are independent).

control=True is the benchmark's control: the luma centre half-sample j
filtered from 8-bit (clipped) horizontal half-samples instead of the
spec's unclipped intermediates, the lower-precision step a faster
interpolation would be tempted to take.
"""

from __future__ import annotations

import numpy as np
import torch

from streamgen import I4X4

# -- tables ------------------------------------------------------------------

# Table 8-16: alpha' and beta' by indexA / indexB
ALPHA = np.array([0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20,
                             22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71,
                             80, 90, 101, 113, 127, 144, 162, 182, 203,
                             226, 255, 255], np.int32)
BETA = np.array([0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                            9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
                            15, 15, 16, 16, 17, 17, 18, 18], np.int32)
# Table 8-17: tC0 by indexA (rows) and bS 1..3 (columns)
TC0 = np.array([[0, 0, 0]] * 17 + [
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
    [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
    [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14],
    [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23], [13, 17, 25]],
    np.int32)
# Table 8-15: QPc by qPI
QPC = np.array(list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35,
                                  36, 36, 37, 37, 37, 38, 38, 38, 39, 39,
                                  39, 39], np.int32)
# 8.5.9 normAdjust4x4(m, i, j): v0 at (even, even), v1 at (odd, odd),
# v2 elsewhere
_V = np.array([[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18],
               [16, 25, 20], [18, 29, 23]], np.int32)
_POS_CLASS = np.array([[0 if i % 2 == 0 and j % 2 == 0 else
                        1 if i % 2 == 1 and j % 2 == 1 else 2
                        for j in range(4)] for i in range(4)])

# -- the pixel stages, in plain torch, batched over pictures of one size --------
#
# Pixel arrays are int32 tensors with a leading batch axis: picture k of
# each of B GOPs of one size is reconstructed together.

def clip1(x):
    return x.clamp(0, 255)


def _tap(a, axis):
    """The 6-tap filter (1, -5, 20, 20, -5, 1) along `axis` of length L:
    L - 5 outputs, output k centred between inputs k+2 and k+3."""
    n = a.shape[axis] - 5

    def sl(k):
        return a.narrow(axis, k, n)
    return sl(0) - 5 * sl(1) + 20 * sl(2) + 20 * sl(3) - 5 * sl(4) + sl(5)


def luma_pred(refs, b, r, x, y, fx, fy, control=False):
    """Luma prediction (8.4.2.2.1) of 4x4 blocks whose top-left sample
    plus the integer part of the MV is (x, y), from refs[b, r] (B, R, H,
    W), fractions fx, fy: (N, 4, 4) int32."""
    hp, wp = refs.shape[2:]
    ar = torch.arange(9, device=x.device)
    xs = (x[:, None] - 2 + ar).clamp(0, wp - 1)
    ys = (y[:, None] - 2 + ar).clamp(0, hp - 1)
    win = refs[b[:, None, None], r[:, None, None], ys[:, :, None],
               xs[:, None, :]].int()                  # (N, 9, 9)
    b1 = _tap(win, 2)                                  # (N, 9, 4)
    h1 = _tap(win, 1)                                  # (N, 4, 9)
    if control:
        j1 = _tap(clip1((b1 + 16) >> 5), 1) * 32       # 8-bit intermediate
    else:
        j1 = _tap(b1, 1)                               # (N, 4, 4)
    G = win[:, 2:6, 2:6]
    Hs = win[:, 2:6, 3:7]
    M = win[:, 3:7, 2:6]
    bh = clip1((b1[:, 2:6] + 16) >> 5)
    s = clip1((b1[:, 3:7] + 16) >> 5)
    h = clip1((h1[:, :, 2:6] + 16) >> 5)
    m = clip1((h1[:, :, 3:7] + 16) >> 5)
    j = clip1((j1 + 512) >> 10)

    def avg(u, v):
        return (u + v + 1) >> 1
    # Table 8-12: the sample at each (xFrac, yFrac)
    table = {(0, 0): lambda: G, (0, 1): lambda: avg(G, h),
             (0, 2): lambda: h, (0, 3): lambda: avg(M, h),
             (1, 0): lambda: avg(G, bh), (1, 1): lambda: avg(bh, h),
             (1, 2): lambda: avg(h, j), (1, 3): lambda: avg(h, s),
             (2, 0): lambda: bh, (2, 1): lambda: avg(bh, j),
             (2, 2): lambda: j, (2, 3): lambda: avg(j, s),
             (3, 0): lambda: avg(Hs, bh), (3, 1): lambda: avg(bh, m),
             (3, 2): lambda: avg(j, m), (3, 3): lambda: avg(m, s)}
    cls = fx * 4 + fy
    out = torch.zeros_like(G)
    for (a, c), f in table.items():
        out = torch.where((cls == a * 4 + c)[:, None, None], f(), out)
    return out


def chroma_pred(refs, b, r, x, y, fx, fy):
    """Chroma prediction (8-266) of 2x2 blocks: (N, 2, 2) int32."""
    hp, wp = refs.shape[2:]
    ar = torch.arange(3, device=x.device)
    xs = (x[:, None] + ar).clamp(0, wp - 1)
    ys = (y[:, None] + ar).clamp(0, hp - 1)
    win = refs[b[:, None, None], r[:, None, None], ys[:, :, None],
               xs[:, None, :]].int()
    fx, fy = fx[:, None, None], fy[:, None, None]
    return ((8 - fx) * (8 - fy) * win[:, :2, :2] + fx * (8 - fy) *
            win[:, :2, 1:] + (8 - fx) * fy * win[:, 1:, :2] +
            fx * fy * win[:, 1:, 1:] + 32) >> 6


def dequant_idct(c, qp):
    """Residual (8.5.12) of 4x4 coefficient blocks c (N, 4, 4) int32 at
    the per-block QPs qp (N,)."""
    v = torch.as_tensor(_V, device=c.device)[qp % 6][
        :, torch.as_tensor(_POS_CLASS, device=c.device)]
    d = (c * v) << (qp // 6)[:, None, None]

    def rows(d):
        e0 = d[..., 0] + d[..., 2]
        e1 = d[..., 0] - d[..., 2]
        e2 = (d[..., 1] >> 1) - d[..., 3]
        e3 = d[..., 1] + (d[..., 3] >> 1)
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    f = rows(d)
    h = rows(f.transpose(1, 2)).transpose(1, 2)
    return ((h + 32) >> 6).int()


def _waves(intra):
    """Wave of each True cell of intra (B, H, W) numpy bool: one more than
    the largest wave of its left and upper True neighbours (0 elsewhere),
    so cells of one wave depend only on earlier waves."""
    bsz, h, w = intra.shape
    wave = np.zeros((bsz, h, w), np.int64)
    col = np.arange(w)
    big = 4 * (h + w + 1)
    for y in range(h):
        on = intra[:, y]
        top = wave[:, y - 1] if y else np.zeros((bsz, w), np.int64)
        # within a run of True cells: wave[x] = x + 1 + max over the run's
        # cells k <= x of (top[k] - k)
        run = np.cumsum(~on, axis=1)
        v = np.where(on, top - col + run * big, -big)
        best = np.maximum.accumulate(v, axis=1) - run * big
        wave[:, y] = np.where(on, col + 1 + best, 0)
    return wave


def _by_wave(wave, device):
    """(indices (3, n) of the cells sorted by wave, host bounds per wave)."""
    b, y, x = np.nonzero(wave)
    k = wave[b, y, x]
    order = np.argsort(k, kind="stable")
    bounds = np.searchsorted(k[order], np.arange(1, k.max(initial=0) + 2))
    idx = torch.as_tensor(np.stack([b, y, x])[:, order], device=device)
    return idx, bounds.tolist()


def intra_luma(y, res, intra_mb):
    """Intra_4x4 DC (8.3.1.2.3) of every 4x4 block of the intra MBs,
    wave by wave, plus the residual."""
    blk = np.repeat(np.repeat(intra_mb, 4, 1), 4, 2)
    idx, bounds = _by_wave(_waves(blk), y.device)
    ar = torch.arange(4, device=y.device)
    for k in range(len(bounds) - 1):
        b, by, bx = idx[:, bounds[k]:bounds[k + 1]]
        x0, y0 = 4 * bx, 4 * by
        top_ok, left_ok = by > 0, bx > 0
        cols = x0[:, None] + ar
        rows = y0[:, None] + ar
        st = y[b[:, None], (y0 - 1).clamp(min=0)[:, None], cols].sum(1)
        sl = y[b[:, None], rows, (x0 - 1).clamp(min=0)[:, None]].sum(1)
        pred = torch.where(top_ok & left_ok, (st + sl + 4) >> 3,
                           torch.where(top_ok, (st + 2) >> 2,
                                       torch.where(left_ok, (sl + 2) >> 2,
                                                   128)))
        bb, yy, xx = b[:, None, None], rows[:, :, None], cols[:, None, :]
        y[bb, yy, xx] = clip1(pred[:, None, None] + res[bb, yy, xx]).int()


def intra_chroma(planes, intra_mb):
    """Chroma DC prediction (8.3.4.1-3) of the intra MBs, in waves of
    MBs; there is no chroma residual."""
    idx, bounds = _by_wave(_waves(intra_mb), planes[0].device)
    ar = torch.arange(8, device=planes[0].device)
    a4 = torch.arange(4, device=planes[0].device)
    for k in range(len(bounds) - 1):
        b, my, mx = idx[:, bounds[k]:bounds[k + 1]]
        top_ok, left_ok = my > 0, mx > 0
        for c in planes:
            top = c[b[:, None], (8 * my - 1).clamp(min=0)[:, None],
                    8 * mx[:, None] + ar]
            left = c[b[:, None], 8 * my[:, None] + ar,
                     (8 * mx - 1).clamp(min=0)[:, None]]
            t0, t1 = top[:, :4].sum(1), top[:, 4:].sum(1)
            l0, l1 = left[:, :4].sum(1), left[:, 4:].sum(1)

            def corner(st, sl):
                return torch.where(
                    top_ok & left_ok, (st + sl + 4) >> 3,
                    torch.where(left_ok, (sl + 2) >> 2,
                                torch.where(top_ok, (st + 2) >> 2, 128)))
            blocks = {(0, 0): corner(t0, l0), (1, 1): corner(t1, l1),
                      (1, 0): torch.where(top_ok, (t1 + 2) >> 2, torch.where(
                          left_ok, (l0 + 2) >> 2, 128)),
                      (0, 1): torch.where(left_ok, (l1 + 2) >> 2, torch.where(
                          top_ok, (t0 + 2) >> 2, 128))}
            for (bx, by), v in blocks.items():
                rows = 8 * my[:, None] + 4 * by + a4
                cols = 8 * mx[:, None] + 4 * bx + a4
                c[b[:, None, None], rows[:, :, None], cols[:, None, :]] = \
                    v[:, None, None].int()


# -- deblocking (8.7) ------------------------------------------------------------

class Geometry:
    """The deblocking filter's lines of one picture size, in a flat
    buffer per picture: luma, Cb, Cr, then 8 scratch samples. A luma line
    is p3..q3 across one edge; a chroma line p1 p0 q0 q1, with its p3 p2
    q2 q3 pointing at the scratch (read, never used). MB (mx, my) filters
    its edges e (0-3 vertical left to right, 4-7 horizontal top to
    bottom; chroma edges 0, 2, 4, 6) at steps t = 8 mx + 5 my + e: the
    edges of one step touch disjoint samples, and every edge comes after
    each edge before it in the spec's order (MBs in raster order, vertical
    edges before horizontal ones) that touches its samples, so filtering
    step by step gives the spec's result."""

    def __init__(self, width_mbs: int, height_mbs: int):
        self.w_mbs, self.h_mbs = width_mbs, height_mbs
        wl, hl = 16 * width_mbs, 16 * height_mbs
        wc, hc = wl // 2, hl // 2
        self.n_luma, self.n_chroma = wl * hl, wc * hc
        scratch = self.n_luma + 2 * self.n_chroma
        self.size = scratch + 8
        mx, my, e, l = (a.ravel() for a in np.meshgrid(
            np.arange(width_mbs), np.arange(height_mbs), np.arange(8),
            np.arange(16), indexing="ij"))
        keep = ~(((e == 0) & (mx == 0)) | ((e == 4) & (my == 0)))
        mx, my, e, l = mx[keep], my[keep], e[keep], l[keep]
        vert = e < 4
        off = np.where(vert, e, e - 4) * 4
        x = np.where(vert, 16 * mx + off, 16 * mx + l)
        y = np.where(vert, 16 * my + l, 16 * my + off)
        step = np.where(vert, 1, wl)
        luma = (y * wl + x)[:, None] + step[:, None] * np.arange(-4, 4)
        # 4x4 blocks (by, bx) holding q0 and p0
        q_blk = np.stack([y // 4, x // 4])
        p_blk = np.stack([np.where(vert, y, y - 1) // 4,
                          np.where(vert, x - 1, x) // 4])
        luma_id = np.full((width_mbs, height_mbs, 8, 16), -1, np.int64)
        luma_id[mx, my, e, l] = np.arange(len(mx))
        # chroma: 8 lines per edge and plane; chroma line k takes the bS
        # of luma line 2k of the same edge (8.7.2.1)
        cmx, cmy, ce, cl, pl = (a.ravel() for a in np.meshgrid(
            np.arange(width_mbs), np.arange(height_mbs),
            np.array([0, 2, 4, 6]), np.arange(8), np.arange(2),
            indexing="ij"))
        keep = ~(((ce == 0) & (cmx == 0)) | ((ce == 4) & (cmy == 0)))
        cmx, cmy, ce, cl, pl = (a[keep] for a in (cmx, cmy, ce, cl, pl))
        cvert = ce < 4
        coff = np.where(cvert, ce, ce - 4) * 2
        cx = np.where(cvert, 8 * cmx + coff, 8 * cmx + cl)
        cy = np.where(cvert, 8 * cmy + cl, 8 * cmy + coff)
        cstep = np.where(cvert, 1, wc)
        cq0 = self.n_luma + pl * self.n_chroma + cy * wc + cx
        chroma = np.full((len(cq0), 8), scratch, np.int64)
        chroma[:, 2:6] = cq0[:, None] + cstep[:, None] * np.arange(-2, 2)
        self.lines = np.concatenate([luma, chroma])
        self.t = np.concatenate([8 * mx + 5 * my + e,
                                 8 * cmx + 5 * cmy + ce])
        self.is_luma = np.arange(len(self.t)) < len(luma)
        # the luma line whose bS each line takes
        self.bs_of = np.concatenate([np.arange(len(luma)),
                                     luma_id[cmx, cmy, ce, 2 * cl]])
        self.q_blk, self.p_blk = q_blk, p_blk
        self.mb_edge = off == 0
        self.n_steps = int(self.t.max(initial=0)) + 1
        self._dev = {}

    def on(self, device):
        """The arrays boundary_strength reads, as tensors on device."""
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            self._dev[key] = dict(q_blk=t(self.q_blk), p_blk=t(self.p_blk),
                                  mb_edge=t(self.mb_edge))
        return self._dev[key]


_GEOMETRIES: dict = {}


def geometry(width_mbs, height_mbs) -> Geometry:
    key = (width_mbs, height_mbs)
    if key not in _GEOMETRIES:
        _GEOMETRIES[key] = Geometry(width_mbs, height_mbs)
    return _GEOMETRIES[key]


def boundary_strength(gd, intra_mb, nz_blk, mv, ref_pic):
    """bS (8.7.2.1) of every luma line, (B, n): 4 on an MB edge with an
    intra side, 3 inside an intra MB, 2 where either 4x4 block has
    coefficients, 1 on different reference pictures or an MV component
    4 quarter samples apart or more, else 0 (frames)."""
    (pby, pbx), (qby, qbx) = gd["p_blk"], gd["q_blk"]
    intra = intra_mb[:, pby // 4, pbx // 4] | intra_mb[:, qby // 4, qbx // 4]
    coef = nz_blk[:, pby, pbx] | nz_blk[:, qby, qbx]
    dmv = (mv[:, pby, pbx] - mv[:, qby, qbx]).abs().amax(-1) >= 4
    motion = (ref_pic[:, pby, pbx] != ref_pic[:, qby, qbx]) | dmv
    return torch.where(intra, torch.where(gd["mb_edge"], 4, 3),
                       torch.where(coef, 2, torch.where(motion, 1, 0)))


def _filter(flat, idx, strong, alpha, beta, tc0, luma):
    """8.7.2.3-4 on lines idx (8, n) of the numpy array flat, all with
    bS < 4 or all with bS == 4 (strong): p3 p2 p1 p0 q0 q1 q2 q3 for luma,
    p1 p0 q0 q1 in the middle four for chroma (luma False)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = flat[idx]
    on = (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) & \
        (np.abs(q1 - q0) < beta)
    ap = (np.abs(p2 - p0) < beta) & luma
    aq = (np.abs(q2 - q0) < beta) & luma
    if not strong:
        tc = tc0 + np.where(luma, ap.astype(np.int32) + aq, 1)
        delta = np.minimum(np.maximum(
            (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc)
        avg = (p0 + q0 + 1) >> 1
        new = (p2,
               np.where(on & ap, p1 + np.minimum(np.maximum(
                   (p2 + avg - (p1 << 1)) >> 1, -tc0), tc0), p1),
               np.where(on, np.minimum(np.maximum(p0 + delta, 0), 255), p0),
               np.where(on, np.minimum(np.maximum(q0 - delta, 0), 255), q0),
               np.where(on & aq, q1 + np.minimum(np.maximum(
                   (q2 + avg - (q1 << 1)) >> 1, -tc0), tc0), q1),
               q2)
    else:
        small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp, sq = on & ap & small, on & aq & small
        new = (np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2),
               np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1),
               np.where(on, np.where(
                   sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   (2 * p1 + p0 + q1 + 2) >> 2), p0),
               np.where(on, np.where(
                   sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                   (2 * q1 + q0 + p1 + 2) >> 2), q0),
               np.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, q1),
               np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2))
    flat[idx[1:7]] = np.stack(new)


def deblock(g: Geometry, y, cb, cr, bs_luma, qp, counts=None):
    """Filter the planes (B pictures, tensors on any device) in place.
    qp (B,): each picture's QP_Y (every MB's). The filter's steps run in
    numpy on the host: thousands of small sequential steps, where a
    host array operation costs a fraction of a device launch. counts,
    when a list of B dicts: adds the samples the filter reads (the union
    of the lines with bS > 0) and changes."""
    bsz = y.shape[0]
    flat = torch.cat([y.reshape(bsz, -1), cb.reshape(bsz, -1),
                      cr.reshape(bsz, -1),
                      torch.zeros(bsz, 8, dtype=y.dtype, device=y.device)],
                     1).cpu().numpy().reshape(-1)
    before = flat.copy() if counts is not None else None
    bs = bs_luma.cpu().numpy()[:, g.bs_of]                    # (B, n)
    pic, line = np.nonzero(bs > 0)
    bsel = bs[pic, line]
    key = g.t[line] * 2 + (bsel == 4)
    order = np.argsort(key, kind="stable")
    pic, line, bsel, key = pic[order], line[order], bsel[order], key[order]
    bounds = np.searchsorted(key, np.arange(2 * g.n_steps + 1))
    luma = g.is_luma[line]
    qpl = qp.cpu().numpy()[pic]
    ia = np.where(luma, qpl, QPC[qpl])
    alpha, beta = ALPHA[ia], BETA[ia]
    tc0 = np.concatenate([np.zeros((52, 1), np.int32), TC0,
                          np.zeros((52, 1), np.int32)], 1)[ia, bsel]
    idx = np.ascontiguousarray((g.lines[line] + (pic * g.size)[:, None]).T)
    for k in range(2 * g.n_steps):
        a, b = bounds[k], bounds[k + 1]
        if a < b:
            _filter(flat, idx[:, a:b], k % 2 == 1, alpha[a:b], beta[a:b],
                    tc0[a:b], luma[a:b])
    flat = flat.reshape(bsz, g.size)
    out = torch.from_numpy(flat).to(y.device)
    y.copy_(out[:, :g.n_luma].view(y.shape))
    cb.copy_(out[:, g.n_luma:g.n_luma + g.n_chroma].view(cb.shape))
    cr.copy_(out[:, g.n_luma + g.n_chroma:-8].view(cr.shape))
    if counts is not None:
        seen = np.zeros(bsz * g.size, bool)
        seen[idx.reshape(-1)] = True
        seen = seen.reshape(bsz, g.size)[:, :-8].sum(1)
        changed = (flat != before.reshape(bsz, g.size))[:, :-8].sum(1)
        for c, s_, w_ in zip(counts, seen.tolist(), changed.tolist()):
            c["deblock_read"], c["deblock_written"] = s_, w_


# -- pictures ----------------------------------------------------------------------

def _mv_footprint():
    """The samples of the 9x9 window (origin 2 left of and above the
    block) that luma prediction reads, per (xFrac, yFrac)."""
    def box(r0, r1, c0, c1):
        m = np.zeros((9, 9), bool)
        m[r0:r1, c0:c1] = True
        return m
    G, M, Hs = box(2, 6, 2, 6), box(3, 7, 2, 6), box(2, 6, 3, 7)
    b, s = box(2, 6, 0, 9), box(3, 7, 0, 9)
    h, m, j = box(0, 9, 2, 6), box(0, 9, 3, 7), box(0, 9, 0, 9)
    uses = {(0, 0): G, (0, 1): G | h, (0, 2): h, (0, 3): M | h,
            (1, 0): G | b, (1, 1): b | h, (1, 2): j, (1, 3): h | s,
            (2, 0): b, (2, 1): j, (2, 2): j, (2, 3): j,
            (3, 0): Hs | b, (3, 1): b | m, (3, 2): j, (3, 3): m | s}
    return {k: np.argwhere(v) for k, v in uses.items()}


_FOOTPRINT = _mv_footprint()


def _count_mc_reads(shape, b, r, x, y, fx, fy, cx, cy, cfx, cfy, bsz):
    """Reference samples that luma and chroma prediction read, each once,
    per picture of the batch."""
    n_b, n_ref, hp, wp = shape
    seen = torch.zeros((n_b, n_ref, hp, wp), dtype=torch.bool,
                       device=x.device)
    for (a, c), pts in _FOOTPRINT.items():
        sel = (fx == a) & (fy == c)
        for dy, dx in pts.tolist():
            seen[b[sel], r[sel], (y[sel] - 2 + dy).clamp(0, hp - 1),
                 (x[sel] - 2 + dx).clamp(0, wp - 1)] = True
    cseen = torch.zeros((n_b, n_ref, hp // 2, wp // 2), dtype=torch.bool,
                        device=x.device)
    for dy in range(3):
        for dx in range(3):
            # the third row or column weighs 0 at a zero fraction
            need = ((cfx > 0) | (dx < 2)) & ((cfy > 0) | (dy < 2))
            cseen[b[need], r[need], (cy[need] + dy).clamp(0, hp // 2 - 1),
                  (cx[need] + dx).clamp(0, wp // 2 - 1)] = True
    return (seen.flatten(1).sum(1) + 2 * cseen.flatten(1).sum(1)).tolist()


def decode_pictures(pics, motion, dpbs, width_mbs, height_mbs, device,
                    control=False, counts=None):
    """Picture k of B GOPs of one size: (y, cb, cr) int32 (B, ...) on
    device, deblocked. motion[b]: derive_motion's (mv, ref_idx) of P
    picture b. dpbs[b]: its short-term references, oldest first, each
    (frame_num, y, cb, cr, picture id) with planes (H, W) uint8."""
    g = geometry(width_mbs, height_mbs)
    bsz = len(pics)
    h4, w4 = 4 * height_mbs, 4 * width_mbs
    hl, wl = 16 * height_mbs, 16 * width_mbs
    dev = torch.device(device)
    intra_np = np.stack([p.kind == I4X4 for p in pics]).reshape(
        bsz, height_mbs, width_mbs)
    intra_mb = torch.as_tensor(intra_np, device=dev)
    qp = torch.as_tensor([p.qp for p in pics], dtype=torch.int32, device=dev)
    y = torch.zeros((bsz, hl, wl), dtype=torch.int32, device=dev)
    cb = torch.zeros((bsz, hl // 2, wl // 2), dtype=torch.int32, device=dev)
    cr = torch.zeros_like(cb)
    # residual: luma block 0 of each MB with a coefficient
    res = torch.zeros_like(y)
    nz_blk = torch.zeros((bsz, h4, w4), dtype=torch.bool, device=dev)
    dc = torch.as_tensor(np.stack([p.dc for p in pics]), device=dev)
    pb, mbs = torch.nonzero(dc, as_tuple=True)
    if len(mbs):
        c = torch.zeros((len(mbs), 4, 4), dtype=torch.int32, device=dev)
        c[:, 0, 0] = dc[pb, mbs].int()
        my, mx = mbs // width_mbs, mbs % width_mbs
        ar = torch.arange(4, device=dev)
        rr = 16 * my[:, None] + ar
        cc = 16 * mx[:, None] + ar
        res[pb[:, None, None], rr[:, :, None], cc[:, None, :]] = \
            dequant_idct(c, qp[pb])
        nz_blk[pb, 4 * my, 4 * mx] = True
    mv = torch.zeros((bsz, h4, w4, 2), dtype=torch.int32, device=dev)
    ref_pic = torch.full((bsz, h4, w4), -1, dtype=torch.int64, device=dev)
    if counts is not None:
        for c in counts:
            c["mc_read"] = c["mc_written"] = 0
    if not all(p.idr for p in pics):
        if any(p.idr for p in pics) or \
                len({p.n_active for p in pics}) != 1:
            raise NotImplementedError("a batch of unlike pictures")
        n_active = pics[0].n_active
        orders, refs_np = [], [[], [], []]
        for p, dpb in zip(pics, dpbs):
            if len(dpb) < n_active:
                raise NotImplementedError("fewer references than active")
            # 8.2.4.2.1: short-term references by descending PicNum
            wrap = [(fn if fn <= p.frame_num else fn - 16, i)
                    for i, (fn, *_) in enumerate(dpb)]
            order = [i for _, i in sorted(wrap, reverse=True)][:n_active]
            orders.append([dpb[i][4] for i in order])
            for k in range(3):
                refs_np[k].append(torch.stack([dpb[i][k + 1]
                                               for i in order]))
        refs = [torch.stack(r) for r in refs_np]        # (B, R, H, W)
        mv = torch.as_tensor(np.stack([m[0] for m in motion]), device=dev)
        ref_idx = torch.as_tensor(np.stack([m[1] for m in motion]),
                                  device=dev).long()
        inter = ref_idx >= 0
        ids = torch.as_tensor(orders, device=dev)
        ref_pic = torch.where(inter, torch.gather(
            ids, 1, ref_idx.clamp(min=0).flatten(1)).view(ref_idx.shape), -1)
        b, by, bx = torch.nonzero(inter, as_tuple=True)
        r = ref_idx[b, by, bx]
        mvx, mvy = mv[b, by, bx, 0], mv[b, by, bx, 1]
        lx, ly = 4 * bx + (mvx >> 2), 4 * by + (mvy >> 2)
        pred = luma_pred(refs[0], b, r, lx, ly, mvx & 3, mvy & 3, control)
        a4 = torch.arange(4, device=dev)
        rows = 4 * by[:, None] + a4
        cols = 4 * bx[:, None] + a4
        bb, yy, xx = b[:, None, None], rows[:, :, None], cols[:, None, :]
        y[bb, yy, xx] = clip1(pred + res[bb, yy, xx])
        cx, cy = 2 * bx + (mvx >> 3), 2 * by + (mvy >> 3)
        a2 = torch.arange(2, device=dev)
        crows = (2 * by[:, None] + a2)[:, :, None]
        ccols = (2 * bx[:, None] + a2)[:, None, :]
        for plane, refc in zip((cb, cr), refs[1:]):
            plane[bb, crows, ccols] = chroma_pred(refc, b, r, cx, cy,
                                                  mvx & 7, mvy & 7)
        if counts is not None:
            reads = _count_mc_reads(refs[0].shape, b, r, lx, ly, mvx & 3,
                                    mvy & 3, cx, cy, mvx & 7, mvy & 7, bsz)
            written = (inter.flatten(1).sum(1) * 24).tolist()
            for c, rd, wr in zip(counts, reads, written):
                c["mc_read"], c["mc_written"] = rd, wr
    intra_luma(y, res, intra_np)
    intra_chroma((cb, cr), intra_np)
    bs = boundary_strength(g.on(dev), intra_mb, nz_blk, mv, ref_pic)
    deblock(g, y, cb, cr, bs, qp, counts)
    return y, cb, cr


def decode_gops(gops, motion, width_mbs, height_mbs, device,
                num_ref_frames=4, control=False, counts=None):
    """Decode B GOPs of one size in lockstep (each an IDR picture, then
    P pictures, every picture a reference). motion[b][k]: derive_motion
    of picture k of GOP b (None for an I picture). Yields, per picture
    index, the B pictures' (y, cb, cr) uint8 (B, ...) in output order.
    counts: a list that gets, per picture index, a list of B dicts."""
    n = len(gops[0])
    if any(len(g) != n for g in gops):
        raise NotImplementedError("GOPs of unlike lengths")
    dpbs = [[] for _ in gops]
    for k in range(n):
        pics = [g[k] for g in gops]
        for b, p in enumerate(pics):
            if p.idr:
                dpbs[b] = []
            elif k == 0:
                raise NotImplementedError("a GOP starts with an IDR picture")
        c = [{} for _ in gops] if counts is not None else None
        planes = decode_pictures(pics, [m[k] for m in motion], dpbs,
                                 width_mbs, height_mbs, device, control, c)
        if counts is not None:
            counts.append(c)
        planes = tuple(p.to(torch.uint8) for p in planes)
        # sliding-window marking (8.2.5.3)
        for b, p in enumerate(pics):
            dpbs[b].append((p.frame_num, planes[0][b], planes[1][b],
                            planes[2][b], k))
            if len(dpbs[b]) > num_ref_frames:
                dpbs[b].pop(0)
        yield planes
