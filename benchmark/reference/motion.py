"""Motion-vector prediction (ITU-T H.264 clause 8.4.1) of the benchmark's
P pictures, from their syntax record (streamgen.Picture): plain Python,
one picture at a time, with no samples needed, so the pictures of a run
go to worker processes. Imports numpy only. Part of the plain reference
(h264.py holds the pixel stages)."""

from __future__ import annotations

import numpy as np

from streamgen import I4X4, P8X8, P8X16, P16X8, P16X16, SKIP, Picture

# (x, y, width, height) in 4x4 blocks of each partition, decoding order
MB_PARTS = {P16X16: ((0, 0, 4, 4),), P16X8: ((0, 0, 4, 2), (0, 2, 4, 2)),
            P8X16: ((0, 0, 2, 4), (2, 0, 2, 4))}
SUB_PARTS = (((0, 0, 2, 2),), ((0, 0, 2, 1), (0, 1, 2, 1)),
             ((0, 0, 1, 2), (1, 0, 1, 2)),
             ((0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)))


# -- motion vectors (8.4.1) ----------------------------------------------------

def _median(a, b, c):
    return a + b + c - min(a, b, c) - max(a, b, c)


def derive_motion(pic: Picture, width_mbs: int, height_mbs: int):
    """(mv (H4, W4, 2) int32, ref_idx (H4, W4) int8, -1 in intra MBs) of
    one P picture, per 4x4 block, in decoding order of MBs and of their
    partitions."""
    w4, h4 = 4 * width_mbs, 4 * height_mbs
    n = w4 * h4
    mvx, mvy, ref = [0] * n, [0] * n, [-1] * n
    done = [False] * n            # the block's partition is decoded
    kinds, subs = pic.kind.tolist(), pic.sub.tolist()
    refs, mvds = pic.ref.tolist(), pic.mvd.tolist()

    def nb(bx, by):
        """(available, refIdx, mvx, mvy) of the block holding luma
        location (4bx, 4by): not available outside the picture or not yet
        decoded; an intra block is available with refIdx -1, mv 0."""
        if bx < 0 or by < 0 or bx >= w4 or by >= h4:
            return False, -1, 0, 0
        i = by * w4 + bx
        if not done[i]:
            return False, -1, 0, 0
        return True, ref[i], mvx[i], mvy[i]

    def mvp(x, y, w, r, shape, part):
        aa, ra, xa, ya = nb(x - 1, y)
        ab, rb, xb, yb = nb(x, y - 1)
        ac, rc, xc, yc = nb(x + w, y - 1)
        if not ac:
            ac, rc, xc, yc = nb(x - 1, y - 1)
        if shape == P16X8:
            if part == 0 and rb == r:
                return xb, yb
            if part == 1 and ra == r:
                return xa, ya
        elif shape == P8X16:
            if part == 0 and ra == r:
                return xa, ya
            if part == 1 and rc == r:
                return xc, yc
        if not ab and not ac and aa:
            rb = rc = ra
            xb = xc = xa
            yb = yc = ya
        m = (ra == r) + (rb == r) + (rc == r)
        if m == 1:
            if ra == r:
                return xa, ya
            if rb == r:
                return xb, yb
            return xc, yc
        return _median(xa, xb, xc), _median(ya, yb, yc)

    def store(x, y, w, h, r, vx, vy):
        for by in range(y, y + h):
            base = by * w4
            for bx in range(x, x + w):
                i = base + bx
                mvx[i], mvy[i], ref[i], done[i] = vx, vy, r, True

    for mb, kind in enumerate(kinds):
        my, mx = divmod(mb, width_mbs)
        x0, y0 = 4 * mx, 4 * my
        if kind == I4X4:
            store(x0, y0, 4, 4, -1, 0, 0)
        elif kind == SKIP:
            aa, ra, xa, ya = nb(x0 - 1, y0)
            ab, rb, xb, yb = nb(x0, y0 - 1)
            if not aa or not ab or (ra == 0 and xa == 0 and ya == 0) or \
                    (rb == 0 and xb == 0 and yb == 0):
                vx = vy = 0
            else:
                vx, vy = mvp(x0, y0, 4, 0, P16X16, 0)
            store(x0, y0, 4, 4, 0, vx, vy)
        elif kind == P8X8:
            k = 0
            for q in range(4):
                qx, qy = x0 + 2 * (q % 2), y0 + 2 * (q // 2)
                r = refs[mb][q]
                for sx, sy, w, h in SUB_PARTS[subs[mb][q]]:
                    px, py = qx + sx, qy + sy
                    vx, vy = mvp(px, py, w, r, P8X8, 0)
                    dx, dy = mvds[mb][k]
                    k += 1
                    store(px, py, w, h, r, vx + dx, vy + dy)
        else:
            for part, (sx, sy, w, h) in enumerate(MB_PARTS[kind]):
                r = refs[mb][part]
                vx, vy = mvp(x0 + sx, y0 + sy, w, r, kind, part)
                dx, dy = mvds[mb][part]
                store(x0 + sx, y0 + sy, w, h, r, vx + dx, vy + dy)
    mv = np.stack([np.array(mvx, np.int32), np.array(mvy, np.int32)], -1)
    return mv.reshape(h4, w4, 2), np.array(ref, np.int8).reshape(h4, w4)


def motion_task(args):
    """derive_motion of (picture, width_mbs, height_mbs); None for an I
    picture (a worker-process task)."""
    pic, w, h = args
    return None if pic.idr else derive_motion(pic, w, h)
