// Sequence/picture parameter sets and VUI.
// Parity: reference h264bsd_seq_param_set.c, h264bsd_pic_param_set.c,
// h264bsd_vui.c. Baseline-profile constraints enforced exactly as the
// reference does (frame_mbs_only required, CABAC/weighted-pred rejected,
// non-baseline profile_idc only warned about).
#pragma once

#include <array>
#include <memory>
#include <optional>

#include "bitreader.h"
#include "common.h"

namespace h264tpu {

constexpr u32 kMaxCpbCnt = 32;
constexpr u32 kExtendedSar = 255;

struct HrdParams {
  u32 cpb_cnt = 1;
  u32 bit_rate_scale = 0;
  u32 cpb_size_scale = 0;
  std::array<u32, kMaxCpbCnt> bit_rate_value{};
  std::array<u32, kMaxCpbCnt> cpb_size_value{};
  std::array<u8, kMaxCpbCnt> cbr_flag{};
  u32 initial_cpb_removal_delay_length = 24;
  u32 cpb_removal_delay_length = 24;
  u32 dpb_output_delay_length = 24;
  u32 time_offset_length = 24;
};

struct VuiParams {
  bool aspect_ratio_present = false;
  u32 aspect_ratio_idc = 0;
  u32 sar_width = 0;
  u32 sar_height = 0;
  bool overscan_info_present = false;
  bool overscan_appropriate = false;
  bool video_signal_type_present = false;
  u32 video_format = 5;
  bool video_full_range = false;
  bool colour_description_present = false;
  u32 colour_primaries = 2;
  u32 transfer_characteristics = 2;
  u32 matrix_coefficients = 2;
  bool chroma_loc_info_present = false;
  u32 chroma_sample_loc_type_top = 0;
  u32 chroma_sample_loc_type_bottom = 0;
  bool timing_info_present = false;
  u32 num_units_in_tick = 0;
  u32 time_scale = 0;
  bool fixed_frame_rate = false;
  bool nal_hrd_present = false;
  HrdParams nal_hrd;
  bool vcl_hrd_present = false;
  HrdParams vcl_hrd;
  bool low_delay_hrd = false;
  bool pic_struct_present = false;
  bool bitstream_restriction = false;
  bool mvs_over_pic_boundaries = true;
  u32 max_bytes_per_pic_denom = 2;
  u32 max_bits_per_mb_denom = 1;
  u32 log2_max_mv_length_horizontal = 16;
  u32 log2_max_mv_length_vertical = 16;
  u32 num_reorder_frames = kMaxNumRefPics;
  u32 max_dec_frame_buffering = kMaxNumRefPics;
};

struct Sps {
  u32 profile_idc = 0;
  u32 level_idc = 0;
  u32 sps_id = 0;
  u32 max_frame_num = 0;
  u32 poc_type = 0;
  u32 max_pic_order_cnt_lsb = 0;
  bool delta_pic_order_always_zero = false;
  i32 offset_for_non_ref_pic = 0;
  i32 offset_for_top_to_bottom_field = 0;
  u32 num_ref_frames_in_poc_cycle = 0;
  std::vector<i32> offset_for_ref_frame;
  u32 num_ref_frames = 0;
  bool gaps_in_frame_num_allowed = false;
  u32 pic_width_in_mbs = 0;
  u32 pic_height_in_mbs = 0;
  bool frame_cropping = false;
  u32 crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;
  u32 max_dpb_size = 0;
  bool vui_present = false;
  std::optional<VuiParams> vui;

  bool operator==(const Sps& o) const;  // reference h264bsdCompareSeqParamSets
};

struct Pps {
  u32 pps_id = 0;
  u32 sps_id = 0;
  bool pic_order_present = false;
  u32 num_slice_groups = 1;
  u32 slice_group_map_type = 0;
  std::vector<u32> run_length;                    // map type 0
  std::vector<u32> top_left, bottom_right;        // map type 2
  bool slice_group_change_direction = false;      // types 3-5
  u32 slice_group_change_rate = 0;                // types 3-5
  u32 pic_size_in_map_units = 0;                  // type 6
  std::vector<u32> slice_group_id;                // type 6
  u32 num_ref_idx_l0_active = 1;
  u32 pic_init_qp = 26;
  i32 chroma_qp_index_offset = 0;
  bool deblocking_filter_control_present = false;
  bool constrained_intra_pred = false;
  bool redundant_pic_cnt_present = false;
};

// Decoders; trailing-bit errors in parameter sets are ignored (reference
// seq_param_set.c:352-355, pic_param_set.c:330-333).
Status decode_sps(BitReader& br, Sps* sps);
Status decode_pps(BitReader& br, Pps* pps);
Status decode_vui(BitReader& br, VuiParams* vui);

// DPB size in frames from level (spec Table A-1; reference
// h264bsd_seq_param_set.c:384-489). Returns 0 for invalid level/size combos.
u32 dpb_size_from_level(u32 pic_size_in_mbs, u32 level_idc);

}  // namespace h264tpu
