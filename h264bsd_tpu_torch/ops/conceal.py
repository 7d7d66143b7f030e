"""Exact error concealment for partially lost pictures.

A copy of the JAX package's ops/conceal.py (numpy only, no JAX); the
port's decoder calls it between reconstruction and deblocking of a
partially lost picture without a usable reference.

Behavioral parity: reference h264bsd_conceal.c — the concealment order
(row of the first properly decoded MB leftwards then rightwards, the rows
above bottom-up per column, then the rows below in raster order,
conceal.c:200-254), the per-MB neighbour-DC/gradient synthesis
(ConcealMb :258-595) and its simplified transform (:592-639).

This is the error path (only corrupt streams reach it), and the synthesis
is inherently sequential in the spiral order (later MBs read pels of
earlier-concealed ones), so it runs in numpy on downloaded planes; the
decoder wraps it between a reconstruct-only and a deblock-only device
step. P-type concealment with an available reference is a co-located copy
(PredictSamples with a zero MV, conceal.c:318-338) and is handled on
device; this module also implements it for the mixed case where some MBs
conceal from the reference and the picture still needs the spiral.
"""

from __future__ import annotations

import numpy as np


def _transform(fp):
    """reference Transform conceal.c:592-639; fp: int array (16,)."""
    if fp[1] == 0 and fp[4] == 0:
        fp[1:16] = fp[0]
        return fp
    t0, t1 = fp[0], fp[1]
    fp[0] = t0 + t1
    fp[1] = t0 + (t1 >> 1)
    fp[2] = t0 - (t1 >> 1)
    fp[3] = t0 - t1
    t0 = fp[4]
    fp[5] = t0
    fp[6] = t0
    fp[7] = t0
    for col in range(4):
        t0, t1 = fp[col], fp[col + 4]
        fp[col] = t0 + t1
        fp[col + 4] = t0 + (t1 >> 1)
        fp[col + 8] = t0 - (t1 >> 1)
        fp[col + 12] = t0 - t1
    return fp


def _synth_plane(plane, r, c, size, decoded, w, h, shifts):
    """Neighbour-DC synthesis for one MB of one plane (luma size=16,
    chroma size=8). shifts = (grad_shift_base, dc_shifts[j])."""
    y0, x0 = r * size, c * size
    q = size // 4  # pels per fp cell: 4 luma, 2 chroma
    fp = np.zeros(16, np.int64)
    a = np.zeros(4, np.int64)
    b = np.zeros(4, np.int64)
    l = np.zeros(4, np.int64)
    rr = np.zeros(4, np.int64)
    A = B = L = R = False
    j = hor = ver = 0

    if r > 0 and decoded[(r - 1) * w + c]:
        A = True
        row = plane[y0 - 1, x0:x0 + size].astype(np.int64)
        a[:] = row.reshape(4, q).sum(1)
        j += 1
        hor += 1
        fp[0] += a.sum()
        fp[1] += a[0] + a[1] - a[2] - a[3]
    if r != h - 1 and decoded[(r + 1) * w + c]:
        B = True
        row = plane[y0 + size, x0:x0 + size].astype(np.int64)
        b[:] = row.reshape(4, q).sum(1)
        j += 1
        hor += 1
        fp[0] += b.sum()
        fp[1] += b[0] + b[1] - b[2] - b[3]
    if c > 0 and decoded[r * w + c - 1]:
        L = True
        col = plane[y0:y0 + size, x0 - 1].astype(np.int64)
        l[:] = col.reshape(4, q).sum(1)
        j += 1
        ver += 1
        fp[0] += l.sum()
        fp[4] += l[0] + l[1] - l[2] - l[3]
    if c != w - 1 and decoded[r * w + c + 1]:
        R = True
        col = plane[y0:y0 + size, x0 + size].astype(np.int64)
        rr[:] = col.reshape(4, q).sum(1)
        j += 1
        ver += 1
        fp[0] += rr.sum()
        fp[4] += rr[0] + rr[1] - rr[2] - rr[3]

    if j == 0:
        return  # caller guarantees at least one decoded MB in the picture

    # shifts = (fallback_shift, accum_shift_base, dc_shift_base, magic)
    # luma (5, 3, 4, 10), chroma (4, 2, 3, 9) — conceal.c:420-455 / :530-560
    fallback, accum, dc_base, magic = shifts
    if not hor and L and R:
        fp[1] = (l.sum() - rr.sum()) >> fallback
    elif hor:
        fp[1] >>= accum + hor
    if not ver and A and B:
        fp[4] = (a.sum() - b.sum()) >> fallback
    elif ver:
        fp[4] >>= accum + ver

    if j == 1:
        fp[0] >>= dc_base
    elif j == 2:
        fp[0] >>= dc_base + 1
    elif j == 3:
        fp[0] = (21 * fp[0]) >> magic
    else:
        fp[0] >>= dc_base + 2

    _transform(fp)
    vals = np.clip(fp.reshape(4, 4), 0, 255).astype(np.uint8)
    plane[y0:y0 + size, x0:x0 + size] = np.repeat(np.repeat(vals, q, 0), q, 1)


def _conceal_mb(y, cb, cr, r, c, decoded, w, h, is_p, ref):
    if is_p and ref is not None:
        # zero-MV prediction == co-located copy (conceal.c:318-338)
        ry, rcb, rcr = ref
        y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = \
            ry[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]
        cb[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = \
            rcb[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
        cr[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] = \
            rcr[r * 8:(r + 1) * 8, c * 8:(c + 1) * 8]
        return
    _synth_plane(y, r, c, 16, decoded, w, h, (5, 3, 4, 10))
    _synth_plane(cb, r, c, 8, decoded, w, h, (4, 2, 3, 9))
    _synth_plane(cr, r, c, 8, decoded, w, h, (4, 2, 3, 9))


def conceal_picture(y, cb, cr, decoded, width_mbs, height_mbs, is_p_type,
                    ref_planes):
    """Conceal all undecoded MBs in place (reference h264bsdConceal
    :124-254 ordering). decoded: (nMB,) bool of properly decoded MBs;
    modified in place as concealment proceeds. Caller handles the
    whole-picture-lost case."""
    w, h = width_mbs, height_mbs
    first = int(np.argmax(decoded))
    row, col = first // w, first % w

    def do(r, c):
        _conceal_mb(y, cb, cr, r, c, decoded, w, h, is_p_type, ref_planes)
        decoded[r * w + c] = True

    # the row containing the first decoded MB: leftwards, then rightwards
    for j in range(col - 1, -1, -1):
        do(row, j)
    for j in range(col + 1, w):
        if not decoded[row * w + j]:
            do(row, j)
    # rows above, column by column, bottom-up
    if row:
        for j in range(w):
            for i in range(row - 1, -1, -1):
                do(i, j)
    # rows below, raster order
    for i in range(row + 1, h):
        for j in range(w):
            if not decoded[i * w + j]:
                do(i, j)
    return y, cb, cr
