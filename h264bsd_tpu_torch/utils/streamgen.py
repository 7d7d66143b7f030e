"""Minimal H.264 Baseline bitstream writer for targeted conformance tests.

Builds tiny legal streams the bundled clips cannot provide — e.g. a
low-QP I-frame whose CAVLC levels exceed the int8 range of the transfer
blob (the wide-escape path of FrameTensors::build_blob). The output is
validated against the reference decoder binary, not against this
framework, so tests using it are a true end-to-end oracle.

Syntax references: ITU-T H.264 §7.3 (RBSP syntax) and §9.1/9.2 (Exp-
Golomb, CAVLC); behavioral anchors in the reference tree are the parsers
these bits must round-trip through (h264bsd_seq_param_set.c,
h264bsd_pic_param_set.c, h264bsd_slice_header.c, h264bsd_cavlc.c).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer with Exp-Golomb helpers."""

    def __init__(self):
        self.bits: list[int] = []

    def u(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def ue(self, value: int):
        code = value + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)
        return self

    def se(self, value: int):
        code = 2 * value - 1 if value > 0 else -2 * value
        return self.ue(code)

    def rbsp_trailing(self):
        self.u(1, 1)
        while len(self.bits) % 8:
            self.u(0, 1)
        return self

    def bytes_rbsp(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (00 00 0x -> 00 00 03 0x)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _nal(nal_header: int, payload: BitWriter) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([nal_header]) + \
        _ebsp(payload.rbsp_trailing().bytes_rbsp())


def _sps(width_mbs: int, height_mbs: int, poc_type: int = 2,
         zero_reorder_vui: bool = False, num_ref_frames: int = 1,
         gaps_allowed: bool = False) -> bytes:
    w = BitWriter()
    w.u(66, 8)          # profile_idc baseline
    w.u(0, 8)           # constraint flags + reserved
    w.u(10, 8)          # level_idc
    w.ue(0)             # seq_parameter_set_id
    w.ue(0)             # log2_max_frame_num_minus4
    w.ue(poc_type)
    if poc_type == 0:
        w.ue(0)         # log2_max_pic_order_cnt_lsb_minus4 (lsb = 4 bits)
    elif poc_type == 1:
        w.u(0, 1)       # delta_pic_order_always_zero_flag
        w.se(0)         # offset_for_non_ref_pic
        w.se(0)         # offset_for_top_to_bottom_field
        w.ue(1)         # num_ref_frames_in_pic_order_cnt_cycle
        w.se(2)         # offset_for_ref_frame[0]
    w.ue(num_ref_frames)  # max_num_ref_frames
    w.u(1 if gaps_allowed else 0, 1)  # gaps_in_frame_num_value_allowed
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.u(1, 1)           # frame_mbs_only_flag
    w.u(0, 1)           # direct_8x8_inference
    w.u(0, 1)           # frame_cropping_flag
    if not zero_reorder_vui:
        w.u(0, 1)       # vui_parameters_present
    else:
        # VUI with bitstream restriction num_reorder_frames = 0: makes
        # output immediate (the reference posix app crashes on a NULL
        # picture if PIC_RDY does not yield an output picture at once —
        # savePic test_h264bsd.c:58 — so reordered streams need this)
        w.u(1, 1)       # vui_parameters_present
        w.u(0, 1)       # aspect_ratio_info_present
        w.u(0, 1)       # overscan_info_present
        w.u(0, 1)       # video_signal_type_present
        w.u(0, 1)       # chroma_loc_info_present
        w.u(0, 1)       # timing_info_present
        w.u(0, 1)       # nal_hrd_parameters_present
        w.u(0, 1)       # vcl_hrd_parameters_present
        w.u(0, 1)       # pic_struct_present
        w.u(1, 1)       # bitstream_restriction_flag
        w.u(1, 1)       # motion_vectors_over_pic_boundaries
        w.ue(2)         # max_bytes_per_pic_denom
        w.ue(1)         # max_bits_per_mb_denom
        w.ue(16)        # log2_max_mv_length_horizontal
        w.ue(16)        # log2_max_mv_length_vertical
        w.ue(0)         # num_reorder_frames
        w.ue(1)         # max_dec_frame_buffering
    return _nal(0x67, w)


def _pps(init_qp: int, num_slice_groups: int = 1,
         redundant_present: bool = False, deblock_control: bool = False,
         constrained_intra: bool = False) -> bytes:
    w = BitWriter()
    w.ue(0)             # pic_parameter_set_id
    w.ue(0)             # seq_parameter_set_id
    w.u(0, 1)           # entropy_coding_mode (CAVLC)
    w.u(0, 1)           # bottom_field_pic_order_in_frame_present
    w.ue(num_slice_groups - 1)
    if num_slice_groups > 1:
        w.ue(1)         # slice_group_map_type 1 (dispersed)
    w.ue(0)             # num_ref_idx_l0_default_active_minus1
    w.ue(0)             # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)           # weighted_pred_flag
    w.u(0, 2)           # weighted_bipred_idc
    w.se(init_qp - 26)  # pic_init_qp_minus26
    w.se(0)             # pic_init_qs_minus26
    w.se(0)             # chroma_qp_index_offset
    w.u(1 if deblock_control else 0, 1)  # deblocking_filter_control_present
    w.u(1 if constrained_intra else 0, 1)  # constrained_intra_pred
    w.u(1 if redundant_present else 0, 1)  # redundant_pic_cnt_present
    return _nal(0x68, w)


# CAVLC encodings used below (spec tables 9-5/9-7/9-8; the framework's
# flat LUTs in cavlc_tables.h decode these exact strings):
_COEFF_TOKEN_TC0_NC02 = (1, 1)          # TotalCoeff 0, nC in 0..2: "1"
_COEFF_TOKEN_TC1_T10_NC02 = (0b000101, 6)  # TotalCoeff 1, T1s 0: "000101"
_TOTAL_ZEROS_0_TC1 = (1, 1)             # total_zeros 0, TotalCoeff 1: "1"


def _write_level(w: BitWriter, level: int):
    """Encode one coefficient level with suffixLength 0 (first level of a
    block with no trailing ones, spec 9.2.2.1; the decoder adds 2 to the
    first levelCode when trailingOnes < 3, so that bias is subtracted
    here)."""
    code = (2 * level - 2 if level > 0 else -2 * level - 1) - 2
    if code < 14:
        w.u(0, code).u(1, 1)                  # level_prefix = code
    elif code < 30:
        w.u(0, 14).u(1, 1).u(code - 14, 4)    # prefix 14 + 4-bit suffix
    else:
        assert code - 30 < (1 << 12), "level out of suffixLength-0 range"
        w.u(0, 15).u(1, 1).u(code - 30, 12)   # prefix 15 + 12-bit suffix


def _luma_group0_residual(w: BitWriter, dc_level: int):
    """Residual for luma 8x8 group 0 (cbp 1): block 0 carries the single
    coefficient `dc_level` (|level| must be >= 2 — a +-1 first level with
    trailingOnes 0 is not encodable at suffixLength 0), blocks 1-3 empty.
    nC contexts are 0 for block 0 and 1, 1, 0 for blocks 1-3 whenever
    every neighbouring macroblock codes this same pattern."""
    w.u(*_COEFF_TOKEN_TC1_T10_NC02)
    _write_level(w, dc_level)
    w.u(*_TOTAL_ZEROS_0_TC1)
    for _ in range(3):
        w.u(*_COEFF_TOKEN_TC0_NC02)


def _i4_mb(w: BitWriter, dc_level: int, qp_delta: int = 0):
    """One I_4x4 macroblock: predicted modes everywhere, luma CBP group 0
    coded; block 0 carries a single DC coefficient `dc_level`, blocks
    1-3 are empty. No chroma residual."""
    w.ue(0)                                   # mb_type I_4x4
    for _ in range(16):
        w.u(1, 1)                             # prev_intra4x4_pred_mode_flag
    w.ue(0)                                   # intra_chroma_pred_mode DC
    # coded_block_pattern me(v): cbp 1 (luma 8x8 group 0, no chroma).
    # Spec table 9-4 intra column: cbp 1 <-> codeNum 29.
    w.ue(29)
    w.se(qp_delta)                            # mb_qp_delta
    _luma_group0_residual(w, dc_level)


def _i4_in_p_mb(w: BitWriter):
    """One intra macroblock inside a P slice (mb_type 5 -> I_4x4; the
    reference adds 1 to P-slice mb_type values, macroblock_layer.c:158-169
    — 5 is the first intra type). DC-predicted, no residual, so its
    encoding is independent of neighbour CAVLC contexts."""
    w.ue(5)                                   # mb_type I_4x4 in P slice
    for _ in range(16):
        w.u(1, 1)                             # prev_intra4x4_pred_mode_flag
    w.ue(0)                                   # intra_chroma_pred_mode DC
    w.ue(3)                                   # me(v): codeNum 3 -> intra cbp 0


def _p16_mb(w: BitWriter, ref_idx: int, n_active: int,
            dc_level: int | None = None):
    """One P_L0_16x16 macroblock with zero MVD (the predicted MV is zero
    when every macroblock in the picture codes zero MVD) sampling
    reference list entry `ref_idx`; optionally one luma DC coefficient so
    frames sourced from different references diverge byte-wise."""
    w.ue(0)                                   # mb_type P_L0_16x16
    if n_active == 2:
        w.u(1 if ref_idx == 0 else 0, 1)      # ref_idx_l0 te(v), inverted bit
    elif n_active > 2:
        w.ue(ref_idx)                         # ref_idx_l0 te(v) == ue(v)
    w.se(0)                                   # mvd_l0 x
    w.se(0)                                   # mvd_l0 y
    if dc_level is None:
        w.ue(0)                               # me(v): codeNum 0 -> inter cbp 0
    else:
        w.ue(2)                               # me(v): codeNum 2 -> inter cbp 1
        w.se(0)                               # mb_qp_delta
        _luma_group0_residual(w, dc_level)


def _pcm_mb(w: BitWriter, seed: int):
    """One I_PCM macroblock (mb_type 25 in an I slice -> kMbIpcm,
    reference macroblock_layer.c:171-190): alignment zero bits then 384
    raw samples. The raw bytes intentionally include 00 00 0x runs so the
    emulation-prevention insert/strip path is exercised inside PCM data."""
    w.ue(25)                                  # mb_type I_PCM
    while len(w.bits) % 8:
        w.u(0, 1)                             # pcm_alignment_zero_bit
    for i in range(384):
        v = (seed * 31 + i * 7) % 256
        if i % 16 < 3:
            v = 0 if i % 16 < 2 else i % 4    # craft 00 00 0x sequences
        w.u(v, 8)


def _plain_i4_mb(w: BitWriter):
    """One I_4x4 macroblock with no residual (cbp 0, predicted modes)."""
    w.ue(0)                                   # mb_type I_4x4
    for _ in range(16):
        w.u(1, 1)                             # prev_intra4x4_pred_mode_flag
    w.ue(0)                                   # intra_chroma_pred_mode DC
    w.ue(3)                                   # me(v): codeNum 3 -> intra cbp 0
    # cbp 0 and not I_16x16 -> no mb_qp_delta, no residual


def _rich_i4_mb(w: BitWriter, seed: int):
    """Interior I_4x4 macroblock with explicit varied prediction modes and
    one coefficient in every luma block (cbp 15). Only legal when all
    neighbour MBs exist (every mode's source pels are available)."""
    w.ue(0)                                   # mb_type I_4x4
    for b in range(16):
        w.u(0, 1)                             # prev_intra4x4_pred_mode_flag
        w.u((seed + b) % 8, 3)                # rem_intra4x4_pred_mode
    w.ue(seed % 4)                            # intra_chroma_pred_mode
    w.ue(2)                                   # me(v): codeNum 2 -> intra cbp 15
    w.se(0)                                   # mb_qp_delta
    for b in range(16):                       # one DC coefficient per block
        w.u(*_COEFF_TOKEN_TC1_T10_NC02)
        lvl = 2 + (seed + b) % 9
        _write_level(w, lvl if (seed + b) % 2 == 0 else -lvl)
        w.u(*_TOTAL_ZEROS_0_TC1)


def make_intra_stress_stream(width_mbs: int = 16, height_mbs: int = 9,
                             n_frames: int = 3, qp: int = 26) -> bytes:
    """All-I stream (BASELINE config 3 analogue): every interior MB uses
    explicit varied intra modes with residual in all 16 luma blocks;
    border MBs are plain DC-predicted. Stresses the CAVLC front-end and
    the device intra wavefront."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2) + _pps(qp)
    for f in range(n_frames):
        w = BitWriter()
        _slice_header(w, 0, 7, f % 16, f == 0, 2, 0)
        for i in range(n_mbs):
            r, c = divmod(i, width_mbs)
            interior = 0 < r and 0 < c < width_mbs - 1
            if interior:
                _rich_i4_mb(w, seed=i * 7 + f)
            else:
                _plain_i4_mb(w)
        out += _nal(0x65 if f == 0 else 0x61, w)
    return out


def _slice_header(w: BitWriter, first_mb: int, slice_type: int,
                  frame_num: int, idr: bool, poc_type: int, poc_lsb: int,
                  n_active: int = 1, reorder=(), mmco=(),
                  lt_flag: bool = False, redundant_cnt: int | None = None,
                  deblock: tuple | None = None, qp_delta: int = 0):
    """Slice header (reference h264bsdDecodeSliceHeader
    slice_header.c:97). `reorder` holds ref_pic_list_reordering commands
    [(idc, value), ...] (RefPicListReordering slice_header.c:447);
    `mmco` holds adaptive dec_ref_pic_marking ops [(op, *args), ...]
    (DecRefPicMarking slice_header.c:552)."""
    w.ue(first_mb)
    w.ue(slice_type)    # +5 forms: all slices of the picture are this type
    w.ue(0)             # pic_parameter_set_id
    w.u(frame_num, 4)   # log2_max_frame_num = 4
    if idr:
        w.ue(0)         # idr_pic_id
    if poc_type == 0:
        w.u(poc_lsb, 4)  # pic_order_cnt_lsb (log2 = 4)
    elif poc_type == 1:
        w.se(0)         # delta_pic_order_cnt[0]
    if redundant_cnt is not None:  # PPS has redundant_pic_cnt_present
        w.ue(redundant_cnt)
    if slice_type % 5 == 0:  # P
        if n_active != 1:
            w.u(1, 1)   # num_ref_idx_active_override_flag
            w.ue(n_active - 1)
        else:
            w.u(0, 1)
        if reorder:
            w.u(1, 1)   # ref_pic_list_reordering_flag_l0
            for idc, value in reorder:
                w.ue(idc)           # 0/1: abs_diff_pic_num_minus1 follows
                w.ue(value)         # 2: long_term_pic_num follows
            w.ue(3)                 # end of reordering commands
        else:
            w.u(0, 1)
    # dec_ref_pic_marking (nal_ref_idc != 0)
    if idr:
        w.u(0, 1)       # no_output_of_prior_pics_flag
        w.u(1 if lt_flag else 0, 1)  # long_term_reference_flag
    elif mmco:
        w.u(1, 1)       # adaptive_ref_pic_marking_mode_flag
        for op, *args in mmco:
            w.ue(op)    # memory_management_control_operation 1..6
            for a in args:
                w.ue(a)
        w.ue(0)         # end of MMCO ops
    else:
        w.u(0, 1)
    w.se(qp_delta)      # slice_qp_delta
    if deblock is not None:  # PPS has deblocking_filter_control_present
        idc, alpha_off, beta_off = deblock
        w.ue(idc)       # disable_deblocking_filter_idc
        if idc != 1:
            w.se(alpha_off // 2)  # slice_alpha_c0_offset_div2
            w.se(beta_off // 2)   # slice_beta_offset_div2


def make_conformance_stream(width_mbs: int = 4, height_mbs: int = 4,
                            n_frames: int = 4, qp: int = 26,
                            poc_type: int = 2,
                            num_slice_groups: int = 1,
                            slices_per_frame: int = 1) -> bytes:
    """IDR + (n_frames-1) all-skip P frames. Every intra MB is a plain
    DC-predicted I_4x4 (no residual). Exercises slice segmentation, FMO
    dispersed maps, POC types 0/1/2 and the multi-frame DPB/MC path with
    crafted bits; the oracle is the reference decoder binary."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, poc_type,
               zero_reorder_vui=poc_type != 2) + _pps(qp, num_slice_groups)

    # IDR picture: intra MBs, split into slice groups and/or slices
    if num_slice_groups > 1:
        # dispersed (map type 1): group of MB i = (i%w + i/w) % groups.
        # one slice per group, MBs in ascending address order
        groups = [[i for i in range(n_mbs)
                   if (i % width_mbs + i // width_mbs) % num_slice_groups
                   == g] for g in range(num_slice_groups)]
    else:
        per = (n_mbs + slices_per_frame - 1) // slices_per_frame
        groups = [list(range(s, min(s + per, n_mbs)))
                  for s in range(0, n_mbs, per)]
    for mbs in groups:
        w = BitWriter()
        _slice_header(w, mbs[0], 7, 0, True, poc_type, 0)
        for _ in mbs:
            _plain_i4_mb(w)
        out += _nal(0x65, w)

    for f in range(1, n_frames):
        for mbs in groups:  # P slices follow the same slice-group map
            w = BitWriter()
            _slice_header(w, mbs[0], 5, f % 16, False, poc_type,
                          (2 * f) % 16)
            w.ue(len(mbs))  # mb_skip_run: the slice group's whole stripe
            out += _nal(0x61, w)
    return out


def make_multiref_stream(frames, width_mbs: int = 4, height_mbs: int = 4,
                         num_ref_frames: int = 2, qp: int = 26,
                         gaps_allowed: bool = False) -> bytes:
    """Multi-reference / MMCO conformance stream: an IDR followed by P
    frames whose reference selection, list reordering and marking are
    driven per frame. Exercises end-to-end what the bundled clips never
    do: ref_pic_list_reordering (reference h264bsdReorderRefPicList
    dpb.c:225), adaptive marking MMCO 1-6 (Mmcop1..6 dpb.c:310-595),
    long-term references, and multi-entry list initialisation
    (h264bsdInitRefPicList dpb.c:1086).

    `frames` is a list of dicts: {"frame_num": int, "idr": bool,
    "lt_flag": bool, "ref_idx": int, "n_active": int,
    "reorder": [(idc, value), ...], "mmco": [(op, *args), ...],
    "dc": int|None}. Every frame carries a distinct DC residual so a
    wrong reference pick, list order or marking decision changes the
    output bytes (oracle: the reference decoder binary)."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2, num_ref_frames=num_ref_frames,
               gaps_allowed=gaps_allowed) + _pps(qp)
    for f in frames:
        w = BitWriter()
        if f.get("idr"):
            _slice_header(w, 0, 7, f["frame_num"], True, 2, 0,
                          lt_flag=f.get("lt_flag", False))
            for _ in range(n_mbs):
                _i4_mb(w, f.get("dc", 4))
        else:
            n_active = f.get("n_active", 1)
            _slice_header(w, 0, 5, f["frame_num"], False, 2, 0,
                          n_active=n_active,
                          reorder=f.get("reorder", ()),
                          mmco=f.get("mmco", ()))
            cycle = f.get("ref_cycle", 0)
            for i in range(n_mbs):
                w.ue(0)  # mb_skip_run
                ref = i % cycle if cycle else f.get("ref_idx", 0)
                _p16_mb(w, ref, n_active, f.get("dc"))
        out += _nal(0x65 if f.get("idr") else 0x61, w)
    return out


def make_pcm_stream(width_mbs: int = 4, height_mbs: int = 2) -> bytes:
    """IDR with I_PCM macroblocks on a checkerboard (plain DC-predicted
    I_4x4 elsewhere — no residual, so PCM neighbours' nC never enters a
    coded block's CAVLC context) followed by a P frame sampling the mixed
    picture. Exercises raw-sample passthrough, intra prediction from PCM
    neighbour pels, deblocking at PCM boundaries (PCM counts as intra,
    qpY 0), and motion compensation over PCM content."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2) + _pps(26)
    w = BitWriter()
    _slice_header(w, 0, 7, 0, True, 2, 0)
    for i in range(n_mbs):
        r, c = divmod(i, width_mbs)
        if (r + c) % 2:
            _pcm_mb(w, seed=i)
        else:
            _plain_i4_mb(w)
    out += _nal(0x65, w)
    w = BitWriter()
    _slice_header(w, 0, 5, 1, False, 2, 0)
    for _ in range(n_mbs):
        w.ue(0)  # mb_skip_run
        _p16_mb(w, 0, 1, 5)
    out += _nal(0x61, w)
    return out


def make_qp_sweep_stream(width_mbs: int = 4, height_mbs: int = 4,
                         n_frames: int = 2) -> bytes:
    """Per-MB mb_qp_delta sweep including the mod-52 wraparound
    (reference slice QP accumulation h264bsd_slice_data.c:211-217 via
    macroblock_layer qp update): QP walks +21/-17 alternately from 26 so
    it crosses both 51 and 0. QP changes also drive the deblocking
    threshold averaging across every MB edge."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2) + _pps(26)
    for f in range(n_frames):
        w = BitWriter()
        _slice_header(w, 0, 7, f % 16, f == 0, 2, 0)
        for i in range(n_mbs):
            _i4_mb(w, 3 + (i % 5), qp_delta=21 if i % 2 == 0 else -17)
        out += _nal(0x65 if f == 0 else 0x61, w)
    return out


def make_deblock_control_stream(idcs=(0, 1, 2)) -> bytes:
    """Slice-level deblocking control (PPS deblocking_filter_control
    present): a three-slice picture whose slices use
    disable_deblocking_filter_idc 0 (filter all), 1 (off), and 2 (skip
    slice boundaries, GetMbFilteringFlags deblocking.c:280) with nonzero
    alpha/beta offsets, followed by a P frame with its own controls."""
    width_mbs, height_mbs = 4, 6
    rows_per_slice = height_mbs // len(idcs)
    out = _sps(width_mbs, height_mbs, 2) + _pps(26, deblock_control=True)
    w = None
    for s, idc in enumerate(idcs):
        w = BitWriter()
        first_mb = s * rows_per_slice * width_mbs
        _slice_header(w, first_mb, 7, 0, True, 2, 0,
                      deblock=(idc, 4 if idc != 1 else 0,
                               -4 if idc != 1 else 0))
        for i in range(rows_per_slice * width_mbs):
            _i4_mb(w, 3 + (first_mb + i) % 7)
        out += _nal(0x65, w)
    w = BitWriter()
    _slice_header(w, 0, 5, 1, False, 2, 0, deblock=(0, -2, 2))
    for _ in range(width_mbs * height_mbs):
        w.ue(0)  # mb_skip_run
        _p16_mb(w, 0, 1, 5)
    out += _nal(0x61, w)
    return out


def make_intra_in_p_stream(constrained: bool) -> bytes:
    """P frames containing intra macroblocks, with and without PPS
    constrained_intra_pred (which makes inter neighbour pels unavailable
    to intra prediction, reference h264bsdIntra4x4Prediction
    intra_prediction.c:731-767)."""
    width_mbs, height_mbs = 4, 4
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2) + \
        _pps(26, constrained_intra=constrained)
    w = BitWriter()
    _slice_header(w, 0, 7, 0, True, 2, 0)
    for i in range(n_mbs):
        _i4_mb(w, 3 + i % 5)
    out += _nal(0x65, w)
    for f in (1, 2):
        w = BitWriter()
        _slice_header(w, 0, 5, f, False, 2, 0)
        for i in range(n_mbs):
            w.ue(0)  # mb_skip_run
            if (i + f) % 3 == 0:
                _i4_in_p_mb(w)
            else:
                _p16_mb(w, 0, 1, 4 + (i % 3))
        out += _nal(0x61, w)
    return out


def make_redundant_stream(lost: bool) -> bytes:
    """Redundant-slice stream (PPS redundant_pic_cnt_present; reference
    decoded-counter semantics macroblock_layer.c:988,:1006-1011). The IDR
    picture is followed by a redundant copy of its first half:

    - lost=False: the primary covers the whole picture; the redundant
      slice must be skipped (every MB already decoded).
    - lost=True: the primary slice covering MBs 0-7 is absent (lost in
      transit, only MBs 8-15 arrive); the redundant slice supplies the
      missing first half and completes the picture.

    A trailing P frame checks the next access unit resets cleanly."""
    out = _sps(4, 4, 2) + _pps(26, redundant_present=True)
    w = BitWriter()
    if lost:
        _slice_header(w, 8, 7, 0, True, 2, 0, redundant_cnt=0)
        for _ in range(8):
            _i4_mb(w, 4)
    else:
        _slice_header(w, 0, 7, 0, True, 2, 0, redundant_cnt=0)
        for _ in range(16):
            _i4_mb(w, 4)
    out += _nal(0x65, w)
    w = BitWriter()
    _slice_header(w, 0, 7, 0, True, 2, 0, redundant_cnt=1)
    for _ in range(8):
        _i4_mb(w, 4)
    out += _nal(0x65, w)
    w = BitWriter()
    _slice_header(w, 0, 5, 1, False, 2, 0, redundant_cnt=0)
    for _ in range(16):
        w.ue(0)  # mb_skip_run
        _p16_mb(w, 0, 1, 5)
    out += _nal(0x61, w)
    return out


def make_ippp_stream(width_mbs: int = 4, height_mbs: int = 4,
                     n_frames: int = 6, qp: int = 26) -> bytes:
    """GOP-less IPPP stream: a non-IDR I picture (recovery-point style
    entry, NAL type 1 — legal baseline, nothing resets the DPB) followed
    by P pictures that each add a distinct DC residual on top of the
    previous frame. No IDR anywhere, so parallel.gop.split_gops returns
    one segment; this is the BASELINE config 4 input for the framepipe
    DPB-handoff decoder (parallel.framepipe)."""
    n_mbs = width_mbs * height_mbs
    out = _sps(width_mbs, height_mbs, 2) + _pps(qp)
    w = BitWriter()
    _slice_header(w, 0, 7, 0, False, 2, 0)
    for _ in range(n_mbs):
        _i4_mb(w, 5)
    out += _nal(0x61, w)
    for f in range(1, n_frames):
        w = BitWriter()
        _slice_header(w, 0, 5, f % 16, False, 2, 0)
        for i in range(n_mbs):
            w.ue(0)  # mb_skip_run
            _p16_mb(w, 0, 1, 3 + f + (i & 3))
        out += _nal(0x61, w)
    return out


def make_lowqp_i_stream(dc_level: int = 200, qp: int = 2) -> bytes:
    """A one-macroblock (16x16) IDR stream at low QP whose single luma
    coefficient is `dc_level` — large enough to exercise the wide-level
    escape of the transfer blob while keeping the IDCT inside the
    reference's [-512,511] range validation."""
    w = BitWriter()
    w.ue(0)             # first_mb_in_slice
    w.ue(7)             # slice_type I (all slices)
    w.ue(0)             # pic_parameter_set_id
    w.u(0, 4)           # frame_num (log2_max_frame_num = 4)
    w.ue(0)             # idr_pic_id
    w.u(0, 1)           # no_output_of_prior_pics_flag
    w.u(0, 1)           # long_term_reference_flag
    w.se(0)             # slice_qp_delta
    _i4_mb(w, dc_level)
    return _sps(1, 1) + _pps(qp) + _nal(0x65, w)
