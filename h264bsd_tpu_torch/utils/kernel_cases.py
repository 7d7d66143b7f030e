"""Seeded random inputs for the deblocking and intra kernels.

The generators draw, with numpy and in the same order, the inputs of the
JAX package's kernel parity tests (tests/test_pallas_deblock.py and
_gen_case of tests/test_pallas_intra.py), so one seed gives both packages
the same arrays. chip_smoke.py and the tests hold each CUDA kernel
against its plain version on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import from_numpy
from ..ops.deblock import deblock_params


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


def intra_case(seed, w_mbs, h_mbs, all_intra=False) -> dict:
    """Random conformant intra frame state: availability consistent with
    the grid plus random above-right drops, and only modes whose
    neighbours are available (what an encoder can emit). all_intra
    redraws the MB classes from {I4x4, I16x16} after the JAX test's
    draws, for a picture with no inter MB."""
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


def padded_intra_ids(case, pad, device) -> torch.Tensor:
    """The case's intra MB ids in raster (decode) order followed by `pad`
    padding ids (nMB), as the front-end's padded list arrives."""
    mb_class = case["mb_class"]
    n = mb_class.shape[0]
    ids = np.flatnonzero((mb_class == 3) | (mb_class == 4))
    ids = np.concatenate([ids, np.full(pad, n)]).astype(np.int32)
    return torch.from_numpy(ids).to(device)
