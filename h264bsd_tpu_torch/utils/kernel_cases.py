"""Seeded random inputs for the deblocking, intra, MC and transform
kernels.

The deblocking and intra generators draw, with numpy and in the same
order, the inputs of the JAX package's kernel parity tests
(tests/test_pallas_deblock.py and _gen_case of
tests/test_pallas_intra.py), so one seed gives both packages the same
arrays. The MC and transform cases are the port's own. chip_smoke.py
and the tests hold each CUDA kernel against its plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import from_numpy
from ..ops.cuda_mc import stripe_exc_ids
from ..ops.deblock import deblock_params
from ..parallel.rowshard import deblock_stripe_args, intra_stripe_args


def deblock_case(seed, w_mbs, h_mbs) -> dict:
    """Random planes and per-MB state of a frame: mixed intra / inter /
    skip / concealed MBs, small MVs, varied QPs, slices and filter
    controls."""
    rng = np.random.default_rng(seed)
    n = w_mbs * h_mbs
    H, W = h_mbs * 16, w_mbs * 16
    return dict(
        y=rng.integers(0, 255, (H, W), dtype=np.uint8),
        cb=rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8),
        cr=rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8),
        mb_class=rng.integers(0, 7, n).astype(np.uint8),
        nnz=rng.integers(0, 3, (n, 24)).astype(np.int32),
        mv=rng.integers(-8, 8, (n, 16, 2)).astype(np.int16),
        ref_slot=rng.integers(-1, 2, (n, 16)).astype(np.int8),
        slice_id=(np.arange(n) // 13).astype(np.uint32),
        disable_dblk=rng.integers(0, 3, n).astype(np.uint8),
        qp_y=rng.integers(10, 51, n).astype(np.uint8),
        filter_off_a=rng.integers(-4, 5, n).astype(np.int8),
        filter_off_b=rng.integers(-4, 5, n).astype(np.int8),
        chroma_qp_offset=rng.integers(-6, 7, n).astype(np.int8))


DEBLOCK_STATE = ("mb_class", "nnz", "mv", "ref_slot", "slice_id",
                 "disable_dblk", "qp_y", "filter_off_a", "filter_off_b",
                 "chroma_qp_offset")


def deblock_inputs(case, w_mbs, h_mbs, device):
    """(y, cb, cr, bs_left, bs_top, luma_thr, chroma_thr) on `device`: the
    arguments of the deblocking kernels' wrappers."""
    t = from_numpy(case, device)
    return (t["y"], t["cb"], t["cr"],
            *deblock_params(*(t[k] for k in DEBLOCK_STATE), w_mbs, h_mbs))


def intra_case(seed, w_mbs, h_mbs, all_intra=False,
               intra_share=None) -> dict:
    """Random conformant intra frame state: availability consistent with
    the grid plus random above-right drops, and only modes whose
    neighbours are available (what an encoder can emit). all_intra
    redraws the MB classes from {I4x4, I16x16} after the JAX test's
    draws, for a picture with no inter MB; intra_share instead makes
    that share of the MBs intra and the rest inter (class 2), as in a P
    picture."""
    rng = np.random.default_rng(seed)
    n = w_mbs * h_mbs
    H, W = h_mbs * 16, w_mbs * 16
    y = rng.integers(0, 255, (H, W), dtype=np.uint8)
    cb = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(0, 255, (H // 2, W // 2), dtype=np.uint8)
    mb_class = rng.integers(2, 5, n).astype(np.int32)     # inter/i4/i16 mix
    r, c = np.arange(n) // w_mbs, np.arange(n) % w_mbs
    mb_avail = ((c > 0) * 1 | (r > 0) * 2 | ((r > 0) & (c > 0)) * 8
                ).astype(np.int32)
    i4_avail = np.zeros((n, 16), np.int32)
    i4_modes = np.zeros((n, 16), np.int32)
    NEED_A = {1, 4, 5, 6, 8}      # left
    NEED_B = {0, 3, 4, 5, 6, 7}   # above
    for b in range(16):
        bx, by = b % 4, b // 4
        a = ((bx > 0) | (c > 0)) * 1 | ((by > 0) | (r > 0)) * 2
        cc = rng.integers(0, 2, n) * 4
        d = ((bx > 0) | (c > 0)) & ((by > 0) | (r > 0))
        i4_avail[:, b] = a | cc | d * 8
        for i in range(n):
            av = int(i4_avail[i, b])
            ok = [m for m in range(9)
                  if (av & 1 or m not in NEED_A)
                  and (av & 2 or m not in NEED_B)]
            i4_modes[i, b] = ok[rng.integers(0, len(ok))]
    i16_mode = np.array([rng.integers(0, 4) if (av & 3) == 3 else 2
                         for av in mb_avail], np.int32)
    chroma_mode = np.array([rng.integers(0, 4) if (av & 3) == 3 else 0
                            for av in mb_avail], np.int32)
    resid_luma = rng.integers(-200, 200, (n, 16, 16)).astype(np.int32)
    resid_chroma = rng.integers(-200, 200, (n, 2, 8, 8)).astype(np.int32)
    if all_intra:
        mb_class = rng.integers(3, 5, n).astype(np.int32)
    elif intra_share is not None:
        mb_class = np.where(rng.random(n) < intra_share,
                            rng.integers(3, 5, n), 2).astype(np.int32)
    return dict(y=y, cb=cb, cr=cr, mb_class=mb_class, i4_modes=i4_modes,
                i4_avail=i4_avail, mb_avail=mb_avail, i16_mode=i16_mode,
                chroma_mode=chroma_mode, resid_luma=resid_luma,
                resid_chroma=resid_chroma)


INTRA_STATE = ("mb_class", "i4_modes", "i4_avail", "mb_avail", "i16_mode",
               "chroma_mode", "resid_luma", "resid_chroma")


def intra_inputs(case, device):
    """(y, cb, cr, *intra state) on `device`: the leading arguments of the
    intra kernels' wrappers (width_mbs and height_mbs follow)."""
    t = from_numpy(case, device)
    return (t["y"], t["cb"], t["cr"], *(t[k] for k in INTRA_STATE))


def _stripe_of(case, w_mbs, first_row, rows, device):
    """The case on `device` cut to the stripe of `rows` MB rows from MB
    row first_row: its per-MB arrays, and its planes' rows."""
    t = from_numpy(case, device)
    n = t["mb_class"].shape[0]
    cut = slice(first_row * w_mbs, (first_row + rows) * w_mbs)
    stripe = {k: v[cut] if v.shape[0] == n else v for k, v in t.items()}
    planes = tuple(t[k][first_row * s:(first_row + rows) * s]
                   for k, s in (("y", 16), ("cb", 8), ("cr", 8)))
    return t, stripe, planes


def intra_stripe_inputs(case, w_mbs, first_row, rows, device):
    """K2's arguments on the row-sharded path's halo-extended stripe
    (parallel.rowshard.intra_stripe_args; width_mbs and rows + 1 follow):
    the intra case's stripe of `rows` MB rows from MB row first_row below
    one dummy MB row whose bottom pel rows hold the frame's rows just
    above the stripe, the halo (none for the top stripe)."""
    t, stripe, planes = _stripe_of(case, w_mbs, first_row, rows, device)
    halo = None if first_row == 0 else tuple(
        t[k][first_row * s - 1] for k, s in (("y", 16), ("cb", 8),
                                             ("cr", 8)))
    return intra_stripe_args(stripe, stripe["resid_luma"],
                             stripe["resid_chroma"], planes, halo, w_mbs)


def deblock_stripe_inputs(case, w_mbs, first_row, rows, device):
    """K1's arguments on the row-sharded path's extended stripe
    (parallel.rowshard.deblock_stripe_args; width_mbs and rows + 1
    follow): the deblocking case's stripe of `rows` MB rows from MB row
    first_row below the frame's MB row above it with deblocking disabled,
    the bS and thresholds computed on that, and the frame's 4 luma / 2
    chroma pel rows above the stripe in the extended planes (none for the
    top stripe, whose first row gets no top edge)."""
    t, stripe, planes = _stripe_of(case, w_mbs, first_row, rows, device)
    above = halo4 = None
    if first_row:
        row = slice((first_row - 1) * w_mbs, first_row * w_mbs)
        above = {k: t[k][row] for k in DEBLOCK_STATE}
        halo4 = tuple(t[k][first_row * s - h:first_row * s]
                      for k, s, h in (("y", 16, 4), ("cb", 8, 2),
                                      ("cr", 8, 2)))
    return deblock_stripe_args(stripe, above, planes, halo4, w_mbs, rows)


def padded_intra_ids(case, pad, device, shuffle_seed=None) -> torch.Tensor:
    """The case's intra MB ids in raster order followed by `pad` padding
    ids (nMB), as the front-end's padded list arrives; with shuffle_seed
    the ids come in a seeded random order (one the front-end never
    ships, which the list kernel must walk all the same)."""
    mb_class = case["mb_class"]
    n = mb_class.shape[0]
    ids = np.flatnonzero((mb_class == 3) | (mb_class == 4))
    if shuffle_seed is not None:
        ids = np.random.default_rng(shuffle_seed).permutation(ids)
    ids = np.concatenate([ids, np.full(pad, n)]).astype(np.int32)
    return torch.from_numpy(ids).to(device)


# quarter-pel MV limits of the front-end's mv_in_range (mbparse.cpp:187-190)
MV_MIN_X, MV_MAX_X, MV_MIN_Y, MV_MAX_Y = -8192, 8191, -2048, 2047
MV_NEAR = 80     # |MV| of the near MVs, quarter pels


def mc_case(seed, w_mbs, h_mbs, n_slots, exc_share) -> dict:
    """Random DPB ring and motion of a frame for the MC kernels.

    Each MB has one MV and slot (block 0's), within +-MV_NEAR quarter
    pels, or, for a tenth of the MBs and one uniform MB per frame side,
    far outside the frame up to the front-end's MV limits; a twentieth
    have slot -1 (an intra MB: reads slot 0). A share exc_share of the MBs
    carry their own MV and slot in every 4x4 block and list all four of
    their quads in exc_ids (mb*4 + q, ascending), which is padded to
    about 1.5x its length with ids >= nMB*4, as the blob ladder pads it.
    The low three MV bits run through all 64 (x, y) combinations over
    the uniform MBs and the exception blocks in turn, so with 64 or more
    of them every luma fractional case and chroma weight occurs. mv is
    int16 and ref_slot int8, as unpack_meta returns them."""
    rng = np.random.default_rng(seed)
    n = w_mbs * h_mbs
    H, W = h_mbs * 16, w_mbs * 16
    ring = dict(
        dpb_y=rng.integers(0, 256, (n_slots, H, W), dtype=np.uint8),
        dpb_cb=rng.integers(0, 256, (n_slots, H // 2, W // 2),
                            dtype=np.uint8),
        dpb_cr=rng.integers(0, 256, (n_slots, H // 2, W // 2),
                            dtype=np.uint8))
    mv = np.zeros((n, 16, 2), np.int32)
    mv[:] = rng.integers(-MV_NEAR, MV_NEAR + 1, (n, 1, 2))
    far = rng.random(n) < 0.1
    mv[far, :, 0] = rng.integers(MV_MIN_X, MV_MAX_X + 1, (far.sum(), 1))
    mv[far, :, 1] = rng.integers(MV_MIN_Y, MV_MAX_Y + 1, (far.sum(), 1))
    ref_slot = np.repeat(rng.integers(0, n_slots, (n, 1)), 16, axis=1)
    ref_slot[rng.random(n) < 0.05] = -1

    is_exc = rng.random(n) < exc_share
    exc = np.flatnonzero(is_exc)
    mv[exc] = rng.integers(-MV_NEAR, MV_NEAR + 1, (len(exc), 16, 2))
    ref_slot[exc] = rng.integers(0, n_slots, (len(exc), 16))
    # fully outside on each side (left, right, top, bottom): uniform MBs
    for mb, (x, y) in zip(rng.permutation(np.flatnonzero(~is_exc))[:4],
                          [(MV_MIN_X, 0), (MV_MAX_X, 0), (0, MV_MIN_Y),
                           (0, MV_MAX_Y)]):
        mv[mb] = (x, y)
    # the 64 low-bit combinations, over the uniform MBs and the exception
    # blocks in MB order; & ~7 keeps every MV inside the limits
    units = [(mb, b) for mb in range(n)
             for b in (range(16) if is_exc[mb] else [slice(None)])]
    for k, (mb, b) in enumerate(units):
        mv[mb, b, 0] = (mv[mb, b, 0] & ~7) | (k & 7)
        mv[mb, b, 1] = (mv[mb, b, 1] & ~7) | ((k >> 3) & 7)

    ids = (exc[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
    pad = len(ids) // 2 + 1
    exc_ids = np.concatenate([ids, n * 4 + rng.integers(0, 8, pad)])
    return dict(**ring, mv=mv.astype(np.int16),
                ref_slot=ref_slot.astype(np.int8),
                exc_ids=exc_ids.astype(np.int32), n_exc=len(ids))


MC_STATE = ("dpb_y", "dpb_cb", "dpb_cr", "mv", "ref_slot", "exc_ids")


def mc_inputs(case, device):
    """(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, exc_ids) on `device`: the
    leading arguments of mc_predict_grids (width_mbs, height_mbs and
    n_exc follow)."""
    t = from_numpy(case, device)
    return tuple(t[k] for k in MC_STATE)


def _edge_targets(rng, pos, size, extent):
    """Per unit at luma position pos (size pels wide, in a plane extent
    pels long), a target position whose window (-2..+3 taps) crosses the
    plane's near or far edge, or lies beyond it."""
    near = rng.random(len(pos)) < 0.5
    return np.where(near, rng.integers(-size - 8, 1, len(pos)),
                    rng.integers(extent - size, extent + 8, len(pos)))


def mc_recon_case(seed, w_mbs, h_mbs, n_slots, exc_share, pcm=False,
                  motion="mixed") -> dict:
    """mc_case, plus what the MC stage of the main path takes beside the
    motion (ops.cuda_mc.mc_recon_cuda): mb_class per MB, mostly P_Skip
    (1) and P (2), a share Intra_4x4 / Intra_16x16 (3, 4) and concealed
    (6), with every slot -1 MB intra; int32 residuals res_l (nMB,16,16)
    and res_c (nMB,2,8,8), zero on most 4x4 blocks and up to +-300 on
    the rest, so sums clip on both sides; with pcm, random PCM grids and
    class 5 on a few MBs. motion "edge" moves every MB (every block of the
    exception MBs) so that its window crosses a left or right frame edge,
    and a top or bottom one where the vertical MV limit reaches it;
    "integer" rounds every MV to whole luma pels, half of them to whole
    chroma pels. The low MV bits of mc_case stay where they are
    fractional."""
    c = mc_case(seed, w_mbs, h_mbs, n_slots, exc_share)
    rng = np.random.default_rng(seed + 2000)
    n = w_mbs * h_mbs
    H, W = h_mbs * 16, w_mbs * 16
    mv = c["mv"].astype(np.int64)
    if motion == "edge":
        exc_mb = np.zeros(n, bool)
        exc_mb[c["exc_ids"][:c["n_exc"]] // 4] = True
        mb = np.repeat(np.arange(n), 16)
        b = np.tile(np.arange(16), n)
        blk = exc_mb[mb]
        # a uniform MB moves whole (block 0's unit), an exception MB per
        # block
        x = mb % w_mbs * 16 + np.where(blk, b % 4 * 4, 0)
        y = mb // w_mbs * 16 + np.where(blk, b // 4 * 4, 0)
        size = np.where(blk, 4, 16)
        unit = np.where(blk, mb * 16 + b, mb * 16)
        tx = _edge_targets(rng, x, size, W)[unit]
        ty = _edge_targets(rng, y, size, H)[unit]
        low = mv.reshape(-1, 2) & 7
        mvx = (tx - x) * 4
        mvy = np.clip((ty - y) * 4, MV_MIN_Y + 8, MV_MAX_Y - 8)
        mv = np.stack([mvx & ~7 | low[:, 0], mvy & ~7 | low[:, 1]],
                      axis=-1).reshape(n, 16, 2)
    elif motion == "integer":
        # per unit: a uniform MB rounds its one MV, a split MB each block's
        whole_chroma = rng.random((n, 16, 1)) < 0.5
        uniform = (mv == mv[:, :1]).all((1, 2))
        whole_chroma = np.where(uniform[:, None, None], whole_chroma[:, :1],
                                whole_chroma)
        mv = np.where(whole_chroma, mv & ~7, mv & ~3)
    cls = np.where(rng.random(n) < 0.5, 1, 2)
    roll = rng.random(n)
    cls = np.where(roll < 0.1, rng.integers(3, 5, n), cls)
    cls = np.where((roll >= 0.1) & (roll < 0.13), 6, cls)
    cls = np.where(c["ref_slot"][:, 0] == -1, rng.integers(3, 5, n), cls)
    if pcm:
        cls = np.where(rng.random(n) < 0.05, 5, cls)
        c.update(pcm_y=rng.integers(0, 256, (n, 16, 16), dtype=np.uint8),
                 pcm_cb=rng.integers(0, 256, (n, 8, 8), dtype=np.uint8),
                 pcm_cr=rng.integers(0, 256, (n, 8, 8), dtype=np.uint8))

    def residual(shape, blocks):
        on = rng.random(blocks) < 0.3
        vals = rng.integers(-300, 301, shape)
        mask = np.repeat(np.repeat(on, 4, axis=-2), 4, axis=-1)
        return (vals * mask).astype(np.int32)

    c.update(mv=mv.astype(np.int16), mb_class=cls.astype(np.uint8),
             res_l=residual((n, 16, 16), (n, 4, 4)),
             res_c=residual((n, 2, 8, 8), (n, 2, 2, 2)))
    return c


def mc_recon_kind_cases(w_mbs, h_mbs, seed=16):
    """Frames whose MBs all take one path of the MC stage's kernel, to time
    it path by path: [(label, case)] for all intra (each MB written 0),
    all inter with whole-pel MVs (no window), uniform with fractional
    MVs, split (every MB's blocks carry their own motion), and with every
    window across a frame edge; 4 reference slots."""
    out = []
    for label, share, motion, cls in (
            ("all intra", 0.0, "mixed", 3),
            ("all inter, whole-pel MVs", 0.0, "integer", 2),
            ("all inter, uniform", 0.0, "mixed", 2),
            ("all inter, split", 1.0, "mixed", 2),
            ("all inter, edge windows", 0.06, "edge", 2)):
        case = mc_recon_case(seed, w_mbs, h_mbs, 4, share, motion=motion)
        case["mb_class"][:] = cls
        out.append((label, case))
    return out


MC_RECON_STATE = ("dpb_y", "dpb_cb", "dpb_cr", "mv", "ref_slot",
                  "mb_class", "res_l", "res_c")


def mc_recon_inputs(case, device):
    """(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l, res_c, pcm)
    on `device`: the leading arguments of mc_recon_cuda (width_mbs and
    height_mbs follow); pcm is None for a case without PCM grids."""
    t = from_numpy(case, device)
    pcm = None
    if "pcm_y" in case:
        pcm = (t["pcm_y"], t["pcm_cb"], t["pcm_cr"])
    return tuple(t[k] for k in MC_RECON_STATE) + (pcm,)


def idct_case(seed, n) -> dict:
    """N random blocks for K9 (idct_blocks): int16-range levels as int32
    (within +-2048, so no int32 product or butterfly overflows), the
    dequant scales of a random QP per block, and an external DC on half
    of the blocks."""
    from ..ops.transform import LEVEL_SCALE_POS
    rng = np.random.default_rng(seed)
    qp = rng.integers(0, 52, n)
    return dict(
        coeff=rng.integers(-2048, 2048, (n, 16)).astype(np.int32),
        scales=(LEVEL_SCALE_POS[qp % 6] << (qp // 6)[:, None]).astype(
            np.int32),
        ext_dc=rng.integers(-40000, 40000, n).astype(np.int32),
        skip_dc=(rng.random(n) < 0.5).astype(np.int32))


IDCT_STATE = ("coeff", "scales", "ext_dc", "skip_dc")


def residual_case(seed, w_mbs, h_mbs, block_share=0.3) -> dict:
    """A random sparse residual stream as unpack_blob returns it: for each
    MB a class (a fifth Intra_16x16), a share of its 24 AC blocks with
    small random levels (position 0 included), luma DC entries (b = 24)
    on Intra_16x16 MBs and chroma DC entries (b = 25) where the MB's DC
    bits say so, in random order, padded to ~1.3x with padding ids
    (nMB*26) that carry garbage levels; random QPs, chroma QP offsets and
    nnz_dc bits."""
    rng = np.random.default_rng(seed)
    n = w_mbs * h_mbs
    mb_class = np.where(rng.random(n) < 0.2, 4,
                        rng.integers(0, 4, n)).astype(np.uint8)
    nnz_dc = rng.integers(0, 2, (n, 3)).astype(np.int32)
    ac = np.flatnonzero(rng.random(n * 24) < block_share)
    ids = [(ac // 24) * 26 + ac % 24]
    levels = [rng.integers(-30, 31, (len(ac), 16)) *
              (rng.random((len(ac), 16)) < 0.3)]
    i16 = np.flatnonzero(mb_class == 4)
    ids.append(i16 * 26 + 24)
    levels.append(rng.integers(-300, 301, (len(i16), 16)))
    cdc = np.flatnonzero(nnz_dc[:, 1:].any(1))
    ids.append(cdc * 26 + 25)
    levels.append(np.concatenate([rng.integers(-300, 301, (len(cdc), 8)),
                                  np.zeros((len(cdc), 8), np.int64)], 1))
    ids = np.concatenate(ids)
    levels = np.concatenate(levels)
    order = rng.permutation(len(ids))
    pad = len(ids) * 3 // 10 + 1
    return dict(
        sparse_ids=np.concatenate([ids[order], np.full(pad, n * 26)]),
        sparse_levels=np.concatenate(
            [levels[order], rng.integers(-99, 99, (pad, 16))]).astype(
            np.int16),
        qp_y=rng.integers(0, 52, n).astype(np.uint8),
        chroma_qp_offset=rng.integers(-12, 13, n).astype(np.int8),
        nnz_dc=nnz_dc, is_i16=mb_class == 4)


RESIDUAL_STATE = ("sparse_ids", "sparse_levels", "qp_y", "chroma_qp_offset",
                  "nnz_dc", "is_i16")


def residual_edge_case(seed, w_mbs, h_mbs, qp=None) -> dict:
    """residual_case with what the fused residual kernel must also get
    right: half of the Intra_16x16 MBs with their luma nnz_dc bit clear
    (their DC passes through untransformed), chroma QP offsets of -12 and
    +12 only, and the real ids in class order as the front-end writes
    them (four classes, each ascending, one after another: not sorted
    overall), padding after them; with qp, every MB's qp_y is qp."""
    case = residual_case(seed, w_mbs, h_mbs)
    rng = np.random.default_rng(seed + 1000)
    n = w_mbs * h_mbs
    i16 = np.flatnonzero(case["is_i16"])
    case["nnz_dc"][i16[rng.random(len(i16)) < 0.5], 0] = 0
    case["chroma_qp_offset"] = rng.choice([-12, 12], n).astype(np.int8)
    if qp is not None:
        case["qp_y"][:] = qp
    ids, levels = case["sparse_ids"], case["sparse_levels"]
    real = ids < n * 26
    order = np.lexsort((ids[real], rng.integers(0, 4, int(real.sum()))))
    case["sparse_ids"] = np.concatenate([ids[real][order], ids[~real]])
    case["sparse_levels"] = np.concatenate([levels[real][order],
                                            levels[~real]])
    return case


def case_inputs(case, names, device):
    """The case's arrays `names` as tensors on `device`, in that order."""
    t = from_numpy(case, device)
    return tuple(t[k] for k in names)


def mc_recon_stripe(args, w_mbs, first_row, rows):
    """mc_recon_cuda's arguments (mc_recon_inputs) cut to the stripe of
    `rows` MB rows from MB row first_row, over the same whole-frame ring:
    the stripe at mb_row_offset=first_row predicts what the frame does
    there."""
    cut = slice(first_row * w_mbs, (first_row + rows) * w_mbs)
    *ring, mv, ref, cls, res_l, res_c, pcm = args
    return (*ring, mv[cut], ref[cut], cls[cut], res_l[cut], res_c[cut],
            None if pcm is None else tuple(p[cut] for p in pcm))


def mc_stripe(args, w_mbs, first_row, rows):
    """mc_predict_grids' arguments (mc_inputs) cut to a stripe, as
    mc_recon_stripe, the exception ids rebased onto it."""
    cut = slice(first_row * w_mbs, (first_row + rows) * w_mbs)
    *ring, mv, ref, exc = args
    return (*ring, mv[cut], ref[cut],
            stripe_exc_ids(exc, first_row * w_mbs, rows * w_mbs))
