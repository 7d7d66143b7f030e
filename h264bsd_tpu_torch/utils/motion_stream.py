"""A seeded H.264 Baseline stream with real motion: test data for motion
compensation.

Every P picture that utils/streamgen.py writes has zero motion (P_L0_16x16
with zero MVD, or all-skip pictures), so on those streams every MV is 0,
luma uses the integer case only and the front-end emits no motion
exception. make_motion_stream draws, from a seed, P pictures that use
every partitioning of the Baseline profile with small signed MVDs and up
to num_ref_frames references, so a decode exercises all fractional luma
cases, chroma weights, exception quads, several reference slots and
windows that leave the frame. It is built from streamgen's own helpers
and leaves that module unchanged.

Every coded 4x4 block carries at most one coefficient, so the CAVLC nC of
every block stays below 2 and one coeff_token table serves all of them,
whatever the mix of macroblock kinds (the property make_intra_in_p_stream
relies on too).
"""

from __future__ import annotations

import numpy as np

from .streamgen import (BitWriter, _i4_in_p_mb, _i4_mb, _luma_group0_residual,
                        _nal, _pps, _slice_header, _sps)

# P-slice mb_type values (reference macroblock_layer.c:158-169) and the
# number of motion partitions of each; P_8x8's come from its sub_mb_types
P_16X16, P_16X8, P_8X16, P_8X8 = 0, 1, 2, 3
N_SUB_PARTS = (1, 2, 2, 4)          # sub_mb_type 8x8, 8x4, 4x8, 4x4

# what each non-skipped MB becomes, with its probability
KINDS = ("p16x16", "p16x8", "p8x16", "p8x8", "intra")
KIND_P = (0.32, 0.2, 0.2, 0.25, 0.03)
SKIP_P = 0.15                        # chance that an MB is P_Skip
IDR_DC = (-20, -9, 4, 11, 26)        # DC levels of the IDR's MBs
RES_DC = (-7, -4, -2, 2, 3, 6)       # DC levels of coded inter residual
MVD_MAX = 6                          # |MVD| per component, quarter pels


def _ref_idx(w: BitWriter, ref: int, n_active: int):
    """ref_idx_l0 te(v): absent for one active reference, an inverted bit
    for two, ue(v) above (as streamgen._p16_mb writes it)."""
    if n_active == 2:
        w.u(1 if ref == 0 else 0, 1)
    elif n_active > 2:
        w.ue(ref)


def _mvd(w: BitWriter, rng):
    for _ in range(2):
        w.se(int(rng.integers(-MVD_MAX, MVD_MAX + 1)))


def _inter_mb(w: BitWriter, kind: str, n_active: int, rng):
    """One inter macroblock of `kind` (mb_pred or sub_mb_pred, then the
    coded block pattern): each partition a reference in [0, n_active)
    and a small signed MVD; half of the MBs code one luma DC coefficient
    (cbp 1), the rest none."""
    if kind == "p8x8":
        w.ue(P_8X8)
        subs = rng.integers(0, 4, 4)
        for s in subs:
            w.ue(int(s))                          # sub_mb_type
        for _ in range(4):
            _ref_idx(w, int(rng.integers(0, n_active)), n_active)
        for s in subs:
            for _ in range(N_SUB_PARTS[s]):
                _mvd(w, rng)
    else:
        mb_type, parts = {"p16x16": (P_16X16, 1), "p16x8": (P_16X8, 2),
                          "p8x16": (P_8X16, 2)}[kind]
        w.ue(mb_type)
        for _ in range(parts):
            _ref_idx(w, int(rng.integers(0, n_active)), n_active)
        for _ in range(parts):
            _mvd(w, rng)
    if rng.random() < 0.5:
        w.ue(0)                                   # me(v) codeNum 0: cbp 0
    else:
        w.ue(2)                                   # me(v) codeNum 2: cbp 1
        w.se(0)                                   # mb_qp_delta
        _luma_group0_residual(w, int(rng.choice(RES_DC)))


def make_motion_stream(width_mbs: int, height_mbs: int, n_frames: int,
                       seed: int, num_ref_frames: int = 4,
                       qp: int = 26) -> bytes:
    """IDR of I_4x4 MBs with a few distinct DC levels, then P pictures
    whose MBs are, drawn from numpy.random.default_rng(seed): P_L0_16x16,
    P_L0_L0_16x8, P_L0_L0_8x16, P_8x8 with a sub_mb_type of 0-3 per
    quadrant, runs of P_Skip (which take the predicted, non-zero MV) and
    about 3% intra MBs. P picture f has min(f, num_ref_frames) active
    references, so its first P picture has one and still carries
    exception quads from the partitions."""
    rng = np.random.default_rng(seed)
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2, num_ref_frames=num_ref_frames) + \
        _pps(qp)
    w = BitWriter()
    _slice_header(w, 0, 7, 0, True, 2, 0)
    for _ in range(n_mbs):
        _i4_mb(w, int(rng.choice(IDR_DC)))
    out += _nal(0x65, w)
    for f in range(1, n_frames):
        n_active = min(f, num_ref_frames)
        w = BitWriter()
        _slice_header(w, 0, 5, f % 16, False, 2, 0, n_active=n_active)
        skip = 0
        for _ in range(n_mbs):
            if rng.random() < SKIP_P:
                skip += 1
                continue
            w.ue(skip)                            # mb_skip_run
            skip = 0
            kind = KINDS[rng.choice(len(KINDS), p=KIND_P)]
            if kind == "intra":
                _i4_in_p_mb(w)
            else:
                _inter_mb(w, kind, n_active, rng)
        if skip:
            w.ue(skip)                            # trailing skipped MBs
        out += _nal(0x61, w)
    return out
