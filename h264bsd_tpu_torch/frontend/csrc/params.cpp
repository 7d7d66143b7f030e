#include "params.h"

namespace h264tpu {

namespace {
// Read a flag bit; returns false on end-of-stream via *err.
inline bool flag(BitReader& br, Status* err) {
  u32 v = br.get_bits(1);
  if (v == kEndOfStream) *err = Status::kError;
  return v == 1;
}
}  // namespace

u32 dpb_size_from_level(u32 pic_size_in_mbs, u32 level_idc) {
  // {level_idc, MaxDPB bytes, MaxFS in MBs} — spec Table A-1 values as used
  // by the reference (seq_param_set.c:398-479, incl. the level-5.0
  // corrigendum value 42393600).
  struct Row { u32 level, max_dpb_bytes, max_fs; };
  static const Row rows[] = {
      {10, 152064, 99},      {11, 345600, 396},    {12, 912384, 396},
      {13, 912384, 396},     {20, 912384, 396},    {21, 1824768, 792},
      {22, 3110400, 1620},   {30, 3110400, 1620},  {31, 6912000, 3600},
      {32, 7864320, 5120},   {40, 12582912, 8192}, {41, 12582912, 8192},
      {42, 34816u * 384, 8704}, {50, 42393600, 22080}, {51, 70778880, 36864},
  };
  for (const Row& r : rows) {
    if (r.level == level_idc) {
      if (pic_size_in_mbs > r.max_fs) return 0;
      u32 size = r.max_dpb_bytes / (pic_size_in_mbs * 384);
      return size < 16 ? size : 16;
    }
  }
  return 0;
}

static Status decode_hrd(BitReader& br, HrdParams* hrd) {
  u32 v = 0;
  if (!ok(br.ue(&v))) return Status::kError;
  hrd->cpb_cnt = v + 1;
  if (hrd->cpb_cnt > kMaxCpbCnt) return Status::kError;
  hrd->bit_rate_scale = br.get_bits(4);
  hrd->cpb_size_scale = br.get_bits(4);
  if (hrd->cpb_size_scale == kEndOfStream) return Status::kError;
  for (u32 i = 0; i < hrd->cpb_cnt; ++i) {
    if (!ok(br.ue(&v)) || v > 4294967294u) return Status::kError;
    hrd->bit_rate_value[i] = (v + 1) * (1u << (6 + hrd->bit_rate_scale));
    if (!ok(br.ue(&v)) || v > 4294967294u) return Status::kError;
    hrd->cpb_size_value[i] = (v + 1) * (1u << (4 + hrd->cpb_size_scale));
    Status err = Status::kOk;
    hrd->cbr_flag[i] = flag(br, &err);
    if (!ok(err)) return err;
  }
  hrd->initial_cpb_removal_delay_length = br.get_bits(5) + 1;
  hrd->cpb_removal_delay_length = br.get_bits(5) + 1;
  hrd->dpb_output_delay_length = br.get_bits(5) + 1;
  u32 tol = br.get_bits(5);
  if (tol == kEndOfStream) return Status::kError;
  hrd->time_offset_length = tol;
  return Status::kOk;
}

Status decode_vui(BitReader& br, VuiParams* vui) {
  Status err = Status::kOk;
  *vui = VuiParams{};
  vui->aspect_ratio_present = flag(br, &err);
  if (vui->aspect_ratio_present) {
    vui->aspect_ratio_idc = br.get_bits(8);
    if (vui->aspect_ratio_idc == kEndOfStream) return Status::kError;
    if (vui->aspect_ratio_idc == kExtendedSar) {
      vui->sar_width = br.get_bits(16);
      vui->sar_height = br.get_bits(16);
      if (vui->sar_height == kEndOfStream) return Status::kError;
    }
  }
  vui->overscan_info_present = flag(br, &err);
  if (vui->overscan_info_present) vui->overscan_appropriate = flag(br, &err);
  vui->video_signal_type_present = flag(br, &err);
  if (vui->video_signal_type_present) {
    vui->video_format = br.get_bits(3);
    vui->video_full_range = flag(br, &err);
    vui->colour_description_present = flag(br, &err);
    if (vui->colour_description_present) {
      vui->colour_primaries = br.get_bits(8);
      vui->transfer_characteristics = br.get_bits(8);
      vui->matrix_coefficients = br.get_bits(8);
      if (vui->matrix_coefficients == kEndOfStream) return Status::kError;
    }
  }
  vui->chroma_loc_info_present = flag(br, &err);
  if (vui->chroma_loc_info_present) {
    if (!ok(br.ue(&vui->chroma_sample_loc_type_top)) ||
        vui->chroma_sample_loc_type_top > 5)
      return Status::kError;
    if (!ok(br.ue(&vui->chroma_sample_loc_type_bottom)) ||
        vui->chroma_sample_loc_type_bottom > 5)
      return Status::kError;
  }
  vui->timing_info_present = flag(br, &err);
  if (vui->timing_info_present) {
    vui->num_units_in_tick = br.show32();
    if (!ok(br.flush(32)) || vui->num_units_in_tick == 0) return Status::kError;
    vui->time_scale = br.show32();
    if (!ok(br.flush(32)) || vui->time_scale == 0) return Status::kError;
    vui->fixed_frame_rate = flag(br, &err);
  }
  vui->nal_hrd_present = flag(br, &err);
  if (!ok(err)) return err;
  if (vui->nal_hrd_present && !ok(decode_hrd(br, &vui->nal_hrd)))
    return Status::kError;
  vui->vcl_hrd_present = flag(br, &err);
  if (!ok(err)) return err;
  if (vui->vcl_hrd_present && !ok(decode_hrd(br, &vui->vcl_hrd)))
    return Status::kError;
  if (vui->nal_hrd_present || vui->vcl_hrd_present)
    vui->low_delay_hrd = flag(br, &err);
  vui->pic_struct_present = flag(br, &err);
  vui->bitstream_restriction = flag(br, &err);
  if (!ok(err)) return err;
  if (vui->bitstream_restriction) {
    vui->mvs_over_pic_boundaries = flag(br, &err);
    if (!ok(br.ue(&vui->max_bytes_per_pic_denom)) ||
        vui->max_bytes_per_pic_denom > 16)
      return Status::kError;
    if (!ok(br.ue(&vui->max_bits_per_mb_denom)) ||
        vui->max_bits_per_mb_denom > 16)
      return Status::kError;
    if (!ok(br.ue(&vui->log2_max_mv_length_horizontal)) ||
        vui->log2_max_mv_length_horizontal > 16)
      return Status::kError;
    if (!ok(br.ue(&vui->log2_max_mv_length_vertical)) ||
        vui->log2_max_mv_length_vertical > 16)
      return Status::kError;
    if (!ok(br.ue(&vui->num_reorder_frames))) return Status::kError;
    if (!ok(br.ue(&vui->max_dec_frame_buffering))) return Status::kError;
  }
  return err;
}

Status decode_sps(BitReader& br, Sps* sps) {
  *sps = Sps{};
  sps->profile_idc = br.get_bits(8);
  if (sps->profile_idc == kEndOfStream) return Status::kError;
  // constraint_set0..2 + reserved bits: values ignored, like the reference
  // (seq_param_set.c:108-121; non-baseline profiles are only warned about).
  br.get_bits(3);
  br.get_bits(5);
  sps->level_idc = br.get_bits(8);
  if (sps->level_idc == kEndOfStream) return Status::kError;

  if (!ok(br.ue(&sps->sps_id)) || sps->sps_id >= kMaxNumSps)
    return Status::kError;
  u32 v = 0;
  if (!ok(br.ue(&v)) || v > 12) return Status::kError;
  sps->max_frame_num = 1u << (v + 4);
  if (!ok(br.ue(&sps->poc_type)) || sps->poc_type > 2) return Status::kError;
  if (sps->poc_type == 0) {
    if (!ok(br.ue(&v)) || v > 12) return Status::kError;
    sps->max_pic_order_cnt_lsb = 1u << (v + 4);
  } else if (sps->poc_type == 1) {
    Status err = Status::kOk;
    sps->delta_pic_order_always_zero = flag(br, &err);
    if (!ok(err)) return err;
    if (!ok(br.se(&sps->offset_for_non_ref_pic))) return Status::kError;
    if (!ok(br.se(&sps->offset_for_top_to_bottom_field))) return Status::kError;
    if (!ok(br.ue(&sps->num_ref_frames_in_poc_cycle)) ||
        sps->num_ref_frames_in_poc_cycle > 255)
      return Status::kError;
    sps->offset_for_ref_frame.resize(sps->num_ref_frames_in_poc_cycle);
    for (i32& off : sps->offset_for_ref_frame)
      if (!ok(br.se(&off))) return Status::kError;
  }
  if (!ok(br.ue(&sps->num_ref_frames)) || sps->num_ref_frames > kMaxNumRefPics)
    return Status::kError;
  Status err = Status::kOk;
  sps->gaps_in_frame_num_allowed = flag(br, &err);
  if (!ok(br.ue(&v))) return Status::kError;
  sps->pic_width_in_mbs = v + 1;
  if (!ok(br.ue(&v))) return Status::kError;
  sps->pic_height_in_mbs = v + 1;
  // frame_mbs_only_flag must be 1 for baseline (seq_param_set.c:251-259)
  if (!flag(br, &err) || !ok(err)) return Status::kError;
  flag(br, &err);  // direct_8x8_inference_flag, unused
  sps->frame_cropping = flag(br, &err);
  if (!ok(err)) return err;
  if (sps->frame_cropping) {
    if (!ok(br.ue(&sps->crop_left)) || !ok(br.ue(&sps->crop_right)) ||
        !ok(br.ue(&sps->crop_top)) || !ok(br.ue(&sps->crop_bottom)))
      return Status::kError;
    if (i32(sps->crop_left) >
            8 * i32(sps->pic_width_in_mbs) - (i32(sps->crop_right) + 1) ||
        i32(sps->crop_top) >
            8 * i32(sps->pic_height_in_mbs) - (i32(sps->crop_bottom) + 1))
      return Status::kError;
  }

  u32 pic_size = sps->pic_width_in_mbs * sps->pic_height_in_mbs;
  u32 dpb = dpb_size_from_level(pic_size, sps->level_idc);
  if (dpb == 0 || sps->num_ref_frames > dpb) dpb = sps->num_ref_frames;
  sps->max_dpb_size = dpb;

  sps->vui_present = flag(br, &err);
  if (!ok(err)) return err;
  if (sps->vui_present) {
    sps->vui.emplace();
    if (!ok(decode_vui(br, &*sps->vui))) return Status::kError;
    if (sps->vui->bitstream_restriction) {
      if (sps->vui->num_reorder_frames > sps->vui->max_dec_frame_buffering ||
          sps->vui->max_dec_frame_buffering < sps->num_ref_frames ||
          sps->vui->max_dec_frame_buffering > sps->max_dpb_size)
        return Status::kError;
      sps->max_dpb_size =
          sps->vui->max_dec_frame_buffering > 1 ? sps->vui->max_dec_frame_buffering : 1;
    }
  }
  br.rbsp_trailing_bits();  // errors in param-set trailing bits are ignored
  return Status::kOk;
}

bool Sps::operator==(const Sps& o) const {
  // Field-wise comparison used for overwrite decisions on SPS re-send
  // (reference h264bsdCompareSeqParamSets, seq_param_set.c:510-577: compares
  // level and vui_present too, but not VUI contents or sps_id).
  if (profile_idc != o.profile_idc || level_idc != o.level_idc ||
      vui_present != o.vui_present ||
      max_frame_num != o.max_frame_num || poc_type != o.poc_type ||
      num_ref_frames != o.num_ref_frames ||
      gaps_in_frame_num_allowed != o.gaps_in_frame_num_allowed ||
      pic_width_in_mbs != o.pic_width_in_mbs ||
      pic_height_in_mbs != o.pic_height_in_mbs ||
      frame_cropping != o.frame_cropping)
    return false;
  if (poc_type == 0) {
    if (max_pic_order_cnt_lsb != o.max_pic_order_cnt_lsb) return false;
  } else if (poc_type == 1) {
    if (delta_pic_order_always_zero != o.delta_pic_order_always_zero ||
        offset_for_non_ref_pic != o.offset_for_non_ref_pic ||
        offset_for_top_to_bottom_field != o.offset_for_top_to_bottom_field ||
        num_ref_frames_in_poc_cycle != o.num_ref_frames_in_poc_cycle ||
        offset_for_ref_frame != o.offset_for_ref_frame)
      return false;
  }
  if (frame_cropping &&
      (crop_left != o.crop_left || crop_right != o.crop_right ||
       crop_top != o.crop_top || crop_bottom != o.crop_bottom))
    return false;
  return true;
}

Status decode_pps(BitReader& br, Pps* pps) {
  *pps = Pps{};
  if (!ok(br.ue(&pps->pps_id)) || pps->pps_id >= kMaxNumPps)
    return Status::kError;
  if (!ok(br.ue(&pps->sps_id)) || pps->sps_id >= kMaxNumSps)
    return Status::kError;
  // entropy_coding_mode_flag: CABAC rejected (pic_param_set.c:126-132)
  if (br.get_bits(1)) return Status::kError;
  Status err = Status::kOk;
  pps->pic_order_present = flag(br, &err);
  if (!ok(err)) return err;
  u32 v = 0;
  if (!ok(br.ue(&v))) return Status::kError;
  pps->num_slice_groups = v + 1;
  if (pps->num_slice_groups > kMaxNumSliceGroups) return Status::kError;

  if (pps->num_slice_groups > 1) {
    if (!ok(br.ue(&pps->slice_group_map_type)) ||
        pps->slice_group_map_type > 6)
      return Status::kError;
    switch (pps->slice_group_map_type) {
      case 0:
        pps->run_length.resize(pps->num_slice_groups);
        for (u32& rl : pps->run_length) {
          if (!ok(br.ue(&v))) return Status::kError;
          rl = v + 1;  // validated at activation time
        }
        break;
      case 2:
        pps->top_left.resize(pps->num_slice_groups - 1);
        pps->bottom_right.resize(pps->num_slice_groups - 1);
        for (u32 i = 0; i + 1 < pps->num_slice_groups; ++i) {
          if (!ok(br.ue(&pps->top_left[i]))) return Status::kError;
          if (!ok(br.ue(&pps->bottom_right[i]))) return Status::kError;
        }
        break;
      case 3:
      case 4:
      case 5:
        pps->slice_group_change_direction = flag(br, &err);
        if (!ok(err)) return err;
        if (!ok(br.ue(&v))) return Status::kError;
        pps->slice_group_change_rate = v + 1;
        break;
      case 6: {
        if (!ok(br.ue(&v))) return Status::kError;
        pps->pic_size_in_map_units = v + 1;
        pps->slice_group_id.resize(pps->pic_size_in_map_units);
        u32 bits = 0;
        while ((1u << bits) < pps->num_slice_groups) bits++;
        for (u32& id : pps->slice_group_id) {
          id = br.get_bits(bits);
          if (id >= pps->num_slice_groups) return Status::kError;
        }
        break;
      }
      default:
        break;  // types 1 (dispersed) have no extra syntax
    }
  }

  if (!ok(br.ue(&v)) || v > 31) return Status::kError;
  pps->num_ref_idx_l0_active = v + 1;
  if (!ok(br.ue(&v)) || v > 31) return Status::kError;  // l1, unused
  if (br.get_bits(1)) return Status::kError;  // weighted_pred_flag must be 0
  if (br.get_bits(2) > 2) return Status::kError;  // weighted_bipred_idc
  i32 sv = 0;
  if (!ok(br.se(&sv)) || sv < -26 || sv > 25) return Status::kError;
  pps->pic_init_qp = u32(sv + 26);
  if (!ok(br.se(&sv)) || sv < -26 || sv > 25) return Status::kError;  // qs
  if (!ok(br.se(&sv)) || sv < -12 || sv > 12) return Status::kError;
  pps->chroma_qp_index_offset = sv;
  pps->deblocking_filter_control_present = flag(br, &err);
  pps->constrained_intra_pred = flag(br, &err);
  pps->redundant_pic_cnt_present = flag(br, &err);
  if (!ok(err)) return err;
  br.rbsp_trailing_bits();  // ignored
  return Status::kOk;
}

}  // namespace h264tpu
