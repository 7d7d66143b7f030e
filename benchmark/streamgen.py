"""The benchmark's frozen copy of the port's seeded motion-stream writer
(h264bsd_tpu_torch/utils/streamgen.py and utils/motion_stream.py, as they
stood when the benchmark was written), so that a later change to the
program cannot change the benchmark's inputs.

make_motion_gop(width_mbs, height_mbs, n_frames, seed, qp) returns the
same bytes as the port's make_motion_stream(width_mbs, height_mbs,
n_frames, seed=seed, qp=qp) (benchmark/tests/test_harness_streamgen.py
holds the two equal) and, beside them, the record of every syntax element
it wrote: the decisions the plain reference (reference/h264.py) decodes
again. The bit writer packs whole bytes instead of a list of bits, and
emulation prevention is one regular-expression pass; both give the same
bytes as the port's, and the random draws are made in the same order.

Imports numpy only: generation runs in spawned worker processes.
"""

from __future__ import annotations

import re

import numpy as np

# macroblock kinds of the record
SKIP, P16X16, P16X8, P8X16, P8X8, I4X4 = range(6)
# P-slice mb_type values (reference macroblock_layer.c:158-169)
_MB_TYPE = {P16X16: 0, P16X8: 1, P8X16: 2, P8X8: 3}
N_SUB_PARTS = (1, 2, 2, 4)          # sub_mb_type 8x8, 8x4, 4x8, 4x4

KINDS = (P16X16, P16X8, P8X16, P8X8, I4X4)
KIND_P = (0.32, 0.2, 0.2, 0.25, 0.03)
SKIP_P = 0.15                        # chance that an MB is P_Skip
IDR_DC = (-20, -9, 4, 11, 26)        # DC levels of the IDR's MBs
RES_DC = (-7, -4, -2, 2, 3, 6)       # DC levels of coded inter residual
MVD_MAX = 6                          # |MVD| per component, quarter pels
LOG2_MAX_FRAME_NUM = 4


class BitWriter:
    """MSB-first bit writer with Exp-Golomb helpers."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0          # bits held in acc

    def u(self, value: int, n: int):
        if n:
            self.acc = (self.acc << n) | (value & ((1 << n) - 1))
            self.n += n
            if self.n >= 64:
                keep = self.n & 7
                self.out += (self.acc >> keep).to_bytes(self.n >> 3, "big")
                self.acc &= (1 << keep) - 1
                self.n = keep
        return self

    def ue(self, value: int):
        code = value + 1
        n = code.bit_length()
        return self.u(code, 2 * n - 1)

    def se(self, value: int):
        return self.ue(2 * value - 1 if value > 0 else -2 * value)

    def rbsp_trailing(self):
        self.u(1, 1)
        return self.u(0, -self.n & 7)

    def bytes_rbsp(self) -> bytes:
        if self.n & 7:
            raise ValueError("RBSP is not byte aligned")
        return bytes(self.out) + self.acc.to_bytes(self.n >> 3, "big")


_EMULATION = re.compile(b"\x00\x00(?=[\x00-\x03])", re.S)


def _ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (00 00 0x -> 00 00 03 0x)."""
    return _EMULATION.sub(b"\x00\x00\x03", rbsp)


def _nal(nal_header: int, payload: BitWriter) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([nal_header]) + \
        _ebsp(payload.rbsp_trailing().bytes_rbsp())


def _sps(width_mbs: int, height_mbs: int, num_ref_frames: int) -> bytes:
    w = BitWriter()
    w.u(66, 8)          # profile_idc baseline
    w.u(0, 8)           # constraint flags + reserved
    w.u(10, 8)          # level_idc
    w.ue(0)             # seq_parameter_set_id
    w.ue(LOG2_MAX_FRAME_NUM - 4)
    w.ue(2)             # pic_order_cnt_type 2: output in decoding order
    w.ue(num_ref_frames)
    w.u(0, 1)           # gaps_in_frame_num_value_allowed
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.u(1, 1)           # frame_mbs_only_flag
    w.u(0, 1)           # direct_8x8_inference
    w.u(0, 1)           # frame_cropping_flag
    w.u(0, 1)           # vui_parameters_present
    return _nal(0x67, w)


def _pps(init_qp: int) -> bytes:
    w = BitWriter()
    w.ue(0)             # pic_parameter_set_id
    w.ue(0)             # seq_parameter_set_id
    w.u(0, 1)           # entropy_coding_mode (CAVLC)
    w.u(0, 1)           # bottom_field_pic_order_in_frame_present
    w.ue(0)             # one slice group
    w.ue(0)             # num_ref_idx_l0_default_active_minus1
    w.ue(0)             # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)           # weighted_pred_flag
    w.u(0, 2)           # weighted_bipred_idc
    w.se(init_qp - 26)  # pic_init_qp_minus26
    w.se(0)             # pic_init_qs_minus26
    w.se(0)             # chroma_qp_index_offset
    w.u(0, 1)           # deblocking_filter_control_present: filter on
    w.u(0, 1)           # constrained_intra_pred
    w.u(0, 1)           # redundant_pic_cnt_present
    return _nal(0x68, w)


def _slice_header(w: BitWriter, frame_num: int, idr: bool, n_active: int):
    """One slice per picture, starting at MB 0; sliding-window marking."""
    w.ue(0)             # first_mb_in_slice
    w.ue(7 if idr else 5)  # slice_type I or P (every slice of the picture)
    w.ue(0)             # pic_parameter_set_id
    w.u(frame_num, LOG2_MAX_FRAME_NUM)
    if idr:
        w.ue(0)         # idr_pic_id
    if not idr:
        if n_active != 1:
            w.u(1, 1)   # num_ref_idx_active_override_flag
            w.ue(n_active - 1)
        else:
            w.u(0, 1)
        w.u(0, 1)       # ref_pic_list_reordering_flag_l0
    if idr:
        w.u(0, 1)       # no_output_of_prior_pics_flag
        w.u(0, 1)       # long_term_reference_flag
    else:
        w.u(0, 1)       # adaptive_ref_pic_marking_mode_flag
    w.se(0)             # slice_qp_delta


# CAVLC codes for TotalCoeff 0 and 1 at nC 0..1 (spec table 9-5) and
# total_zeros 0 at TotalCoeff 1 (table 9-7)
_COEFF_TOKEN_TC0 = (1, 1)
_COEFF_TOKEN_TC1_T10 = (0b000101, 6)
_TOTAL_ZEROS_0_TC1 = (1, 1)


def _write_level(w: BitWriter, level: int):
    """One level at suffixLength 0, first of a block with no trailing
    ones (spec 9.2.2.1: the decoder adds 2 to its levelCode)."""
    code = (2 * level - 2 if level > 0 else -2 * level - 1) - 2
    if code < 14:
        w.u(0, code).u(1, 1)
    elif code < 30:
        w.u(0, 14).u(1, 1).u(code - 14, 4)
    else:
        if code - 30 >= 1 << 12:
            raise ValueError(f"level {level} out of suffixLength-0 range")
        w.u(0, 15).u(1, 1).u(code - 30, 12)


def _luma_group0_residual(w: BitWriter, dc_level: int):
    """cbp 1: luma block 0 carries the single coefficient dc_level at scan
    position 0, blocks 1-3 none."""
    w.u(*_COEFF_TOKEN_TC1_T10)
    _write_level(w, dc_level)
    w.u(*_TOTAL_ZEROS_0_TC1)
    for _ in range(3):
        w.u(*_COEFF_TOKEN_TC0)


def _i4_mb(w: BitWriter, dc_level: int):
    """I_4x4 in an I slice: predicted modes, DC chroma, cbp 1."""
    w.ue(0)                                   # mb_type I_4x4
    for _ in range(16):
        w.u(1, 1)                             # prev_intra4x4_pred_mode_flag
    w.ue(0)                                   # intra_chroma_pred_mode DC
    w.ue(29)                                  # me(v): intra cbp 1
    w.se(0)                                   # mb_qp_delta
    _luma_group0_residual(w, dc_level)


def _i4_in_p_mb(w: BitWriter):
    """I_4x4 in a P slice (mb_type 5): predicted modes, DC chroma, cbp 0."""
    w.ue(5)
    for _ in range(16):
        w.u(1, 1)
    w.ue(0)
    w.ue(3)                                   # me(v): intra cbp 0


def _ref_idx(w: BitWriter, ref: int, n_active: int):
    """ref_idx_l0 te(v)."""
    if n_active == 2:
        w.u(1 if ref == 0 else 0, 1)
    elif n_active > 2:
        w.ue(ref)


class Picture:
    """The syntax record of one coded picture. Per MB: kind, sub_mb_type
    of P_8x8's quadrants, ref_idx_l0 per macroblock partition (up to 4),
    the MVDs in decoding order of the (sub-)partitions (up to 16), and
    the level of luma block 0's single coefficient (0: cbp 0). Every
    mb_qp_delta is 0 and every I_4x4 MB uses its predicted 4x4 modes and
    DC chroma prediction."""

    def __init__(self, n_mbs, idr, frame_num, n_active, qp):
        self.idr, self.frame_num = idr, frame_num
        self.n_active, self.qp = n_active, qp
        self.kind = np.full(n_mbs, SKIP, np.int8)
        self.sub = np.zeros((n_mbs, 4), np.int8)
        self.ref = np.zeros((n_mbs, 4), np.int8)
        self.mvd = np.zeros((n_mbs, 16, 2), np.int16)
        self.dc = np.zeros(n_mbs, np.int16)


def _inter_mb(w: BitWriter, pic: Picture, mb: int, kind: int,
              n_active: int, rng):
    pic.kind[mb] = kind
    mvds = pic.mvd[mb]
    k = 0
    if kind == P8X8:
        w.ue(_MB_TYPE[P8X8])
        subs = rng.integers(0, 4, 4)
        for q, s in enumerate(subs):
            w.ue(int(s))
            pic.sub[mb, q] = s
        for q in range(4):
            r = int(rng.integers(0, n_active))
            _ref_idx(w, r, n_active)
            pic.ref[mb, q] = r
        for s in subs:
            for _ in range(N_SUB_PARTS[s]):
                for c in range(2):
                    v = int(rng.integers(-MVD_MAX, MVD_MAX + 1))
                    w.se(v)
                    mvds[k, c] = v
                k += 1
    else:
        parts = 1 if kind == P16X16 else 2
        w.ue(_MB_TYPE[kind])
        for p in range(parts):
            r = int(rng.integers(0, n_active))
            _ref_idx(w, r, n_active)
            pic.ref[mb, p] = r
        for _ in range(parts):
            for c in range(2):
                v = int(rng.integers(-MVD_MAX, MVD_MAX + 1))
                w.se(v)
                mvds[k, c] = v
            k += 1
    if rng.random() < 0.5:
        w.ue(0)                                   # inter cbp 0
    else:
        w.ue(2)                                   # inter cbp 1
        w.se(0)                                   # mb_qp_delta
        level = int(rng.choice(RES_DC))
        _luma_group0_residual(w, level)
        pic.dc[mb] = level


def make_motion_gop(width_mbs: int, height_mbs: int, n_frames: int,
                    seed: int, qp: int = 26, num_ref_frames: int = 4):
    """(bytes, [Picture]): the port's make_motion_stream with its record.
    An IDR picture of I_4x4 MBs, then P pictures whose MBs are P_Skip
    (15%) or, drawn from numpy.random.default_rng(seed), P_L0_16x16,
    16x8, 8x16, P_8x8 with sub_mb_types 0-3, or I_4x4 (3%); picture f
    has min(f, num_ref_frames) active references."""
    rng = np.random.default_rng(seed)
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, num_ref_frames) + _pps(qp)
    pics = []
    w = BitWriter()
    _slice_header(w, 0, True, 1)
    pic = Picture(n_mbs, True, 0, 0, qp)
    pic.kind[:] = I4X4
    for mb in range(n_mbs):
        level = int(rng.choice(IDR_DC))
        _i4_mb(w, level)
        pic.dc[mb] = level
    out += _nal(0x65, w)
    pics.append(pic)
    for f in range(1, n_frames):
        n_active = min(f, num_ref_frames)
        frame_num = f % (1 << LOG2_MAX_FRAME_NUM)
        w = BitWriter()
        _slice_header(w, frame_num, False, n_active)
        pic = Picture(n_mbs, False, frame_num, n_active, qp)
        skip = 0
        for mb in range(n_mbs):
            if rng.random() < SKIP_P:
                skip += 1
                continue
            w.ue(skip)                            # mb_skip_run
            skip = 0
            kind = KINDS[rng.choice(len(KINDS), p=KIND_P)]
            if kind == I4X4:
                _i4_in_p_mb(w)
                pic.kind[mb] = I4X4
            else:
                _inter_mb(w, pic, mb, kind, n_active, rng)
        if skip:
            w.ue(skip)
        out += _nal(0x61, w)
        pics.append(pic)
    return out, pics
