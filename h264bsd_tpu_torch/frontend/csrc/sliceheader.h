// Slice header decode, validation, and the partial-parse "peek" helpers used
// by access-unit-boundary detection.
// Parity: reference h264bsd_slice_header.c:97-443 (decode + validation),
// :711-1377 (Check* peeks), :447-549 (ref pic list reordering commands),
// :552-709 (dec_ref_pic_marking).
#pragma once

#include <array>

#include "bitreader.h"
#include "common.h"
#include "params.h"

namespace h264tpu {

// slice_type values (reference h264bsd_slice_header.h:47-60).
inline bool is_p_slice(u32 t) { return t == 0 || t == 5; }
inline bool is_i_slice(u32 t) { return t == 2 || t == 7; }
constexpr u32 kPSliceType = 0;  // used when concealing a whole-lost picture

struct ReorderCmd {
  u32 idc = 3;              // reordering_of_pic_nums_idc, 0..3 (3 = end)
  u32 abs_diff_pic_num = 0; // commands 0/1 (stored +1 as reference does)
  u32 long_term_pic_num = 0;
};

struct RefPicListReordering {
  bool flag_l0 = false;
  // at most numRefIdxActive+1 commands incl. terminator (reference bound)
  std::vector<ReorderCmd> commands;
};

constexpr u32 kNoLongTermFrameIndices = 0xFFFFFFFFu;

struct MmcOperation {
  u32 op = 0;  // memory_management_control_operation 0..6 (0 = end)
  u32 difference_of_pic_nums = 0;  // ops 1,3 (stored +1)
  u32 long_term_pic_num = 0;       // op 2
  u32 long_term_frame_idx = 0;     // ops 3,6
  u32 max_long_term_frame_idx = 0; // op 4 (kNoLongTermFrameIndices if disabled)
};

struct DecRefPicMarking {
  // IDR fields
  bool no_output_of_prior_pics = false;
  bool long_term_reference = false;
  // non-IDR fields
  bool adaptive_mode = false;
  std::vector<MmcOperation> operations;
};

struct SliceHeader {
  u32 first_mb_in_slice = 0;
  u32 slice_type = 0;
  u32 pps_id = 0;
  u32 frame_num = 0;
  u32 idr_pic_id = 0;
  u32 pic_order_cnt_lsb = 0;
  i32 delta_pic_order_cnt_bottom = 0;
  i32 delta_pic_order_cnt[2] = {0, 0};
  u32 redundant_pic_cnt = 0;
  bool num_ref_idx_override = false;
  u32 num_ref_idx_l0_active = 0;
  RefPicListReordering reordering;
  DecRefPicMarking marking;
  i32 slice_qp_delta = 0;
  u32 disable_deblocking_filter_idc = 0;
  i32 slice_alpha_c0_offset = 0;  // stored *2 as the reference does
  i32 slice_beta_offset = 0;
  u32 slice_group_change_cycle = 0;
};

// Full decode with all reference validations (slice_header.c:97-443).
Status decode_slice_header(BitReader& br, const Sps& sps, const Pps& pps,
                           const NalUnit& nal, SliceHeader* sh);

// Peek helpers; each re-parses the slice-header prefix from a copy of the
// reader, mirroring the reference's field-wise Check* functions.
Status check_pps_id(const BitReader& br, u32* pps_id);
Status check_frame_num(const BitReader& br, u32 max_frame_num, u32* frame_num);
Status check_idr_pic_id(const BitReader& br, u32 max_frame_num, NalType type,
                        u32* idr_pic_id);
Status check_pic_order_cnt_lsb(const BitReader& br, const Sps& sps,
                               NalType type, u32* poc_lsb);
Status check_delta_pic_order_cnt_bottom(const BitReader& br, const Sps& sps,
                                        NalType type, i32* delta);
Status check_delta_pic_order_cnt(const BitReader& br, const Sps& sps,
                                 NalType type, bool pic_order_present,
                                 i32 delta[2]);
// Peek noOutputOfPriorPicsFlag deep inside dec_ref_pic_marking
// (reference h264bsd_slice_header.c:1377-1512).
Status check_prior_pics_flag(const BitReader& br, const Sps& sps,
                             const Pps& pps, NalType type, u32* flag);

u32 num_slice_group_change_cycle_bits(u32 pic_size_in_mbs, u32 change_rate);

}  // namespace h264tpu
