#include "sliceheader.h"

namespace h264tpu {

namespace {

// Bits used to code frame_num / pic_order_cnt_lsb: position of the highest
// set bit of the max value (both maxima are powers of two).
u32 bits_for(u32 max_value) {
  u32 i = 0;
  while (max_value >> i) i++;
  return i - 1;
}

// Decode ref_pic_list_reordering syntax (reference slice_header.c:447-549).
Status decode_reordering(BitReader& br, RefPicListReordering* out,
                         u32 num_ref_idx_active, u32 max_pic_num) {
  u32 flag = br.get_bits(1);
  if (flag == kEndOfStream) return Status::kError;
  out->flag_l0 = flag != 0;
  if (!out->flag_l0) return Status::kOk;

  u32 i = 0;
  u32 command;
  do {
    if (i > num_ref_idx_active) return Status::kError;  // too many commands
    if (!ok(br.ue(&command)) || command > 3) return Status::kError;
    ReorderCmd cmd;
    cmd.idc = command;
    u32 value;
    if (command == 0 || command == 1) {
      if (!ok(br.ue(&value)) || value >= max_pic_num) return Status::kError;
      cmd.abs_diff_pic_num = value + 1;
    } else if (command == 2) {
      if (!ok(br.ue(&value))) return Status::kError;
      cmd.long_term_pic_num = value;
    }
    out->commands.push_back(cmd);
    i++;
  } while (command != 3);

  // flag set but only the terminating command present -> invalid
  if (i == 1) return Status::kError;
  return Status::kOk;
}

// Decode dec_ref_pic_marking syntax (reference slice_header.c:552-709).
Status decode_marking(BitReader& br, DecRefPicMarking* out, NalType type,
                      u32 num_ref_frames) {
  if (type == kNalCodedSliceIdr) {
    u32 bit = br.get_bits(1);
    if (bit == kEndOfStream) return Status::kError;
    out->no_output_of_prior_pics = bit != 0;
    bit = br.get_bits(1);
    if (bit == kEndOfStream) return Status::kError;
    out->long_term_reference = bit != 0;
    if (num_ref_frames == 0 && out->long_term_reference) return Status::kError;
    return Status::kOk;
  }

  u32 bit = br.get_bits(1);
  if (bit == kEndOfStream) return Status::kError;
  out->adaptive_mode = bit != 0;
  if (!out->adaptive_mode) return Status::kOk;

  u32 num4 = 0, num5 = 0, num6 = 0, num1to3 = 0;
  u32 i = 0;
  u32 operation;
  do {
    // bound from reference slice_header.h MAX_NUM_MMC_OPERATIONS rationale
    if (i > 2 * num_ref_frames + 2) return Status::kError;
    if (!ok(br.ue(&operation)) || operation > 6) return Status::kError;
    MmcOperation op;
    op.op = operation;
    u32 value;
    if (operation == 1 || operation == 3) {
      if (!ok(br.ue(&value))) return Status::kError;
      op.difference_of_pic_nums = value + 1;
    }
    if (operation == 2) {
      if (!ok(br.ue(&value))) return Status::kError;
      op.long_term_pic_num = value;
    }
    if (operation == 3 || operation == 6) {
      if (!ok(br.ue(&value))) return Status::kError;
      op.long_term_frame_idx = value;
    }
    if (operation == 4) {
      if (!ok(br.ue(&value)) || value > num_ref_frames) return Status::kError;
      op.max_long_term_frame_idx =
          value == 0 ? kNoLongTermFrameIndices : value - 1;
      num4++;
    }
    if (operation == 5) num5++;
    if (operation >= 1 && operation <= 3) num1to3++;
    if (operation == 6) num6++;
    out->operations.push_back(op);
    i++;
  } while (operation != 0);

  if (num4 > 1 || num5 > 1 || num6 > 1 || (num1to3 && num5)) {
    return Status::kError;
  }
  return Status::kOk;
}

// Common prefix skipper for the peek helpers: consumes first_mb_in_slice,
// slice_type and pic_parameter_set_id, leaving the reader at frame_num.
Status skip_to_frame_num(BitReader& br) {
  u32 value;
  for (int k = 0; k < 3; ++k) {
    if (!ok(br.ue(&value))) return Status::kError;
  }
  return Status::kOk;
}

Status skip_frame_num_and_idr(BitReader& br, u32 max_frame_num, NalType type) {
  if (br.get_bits(bits_for(max_frame_num)) == kEndOfStream) {
    return Status::kError;
  }
  if (type == kNalCodedSliceIdr) {
    u32 value;
    if (!ok(br.ue(&value))) return Status::kError;
  }
  return Status::kOk;
}

}  // namespace

Status decode_slice_header(BitReader& br, const Sps& sps, const Pps& pps,
                           const NalUnit& nal, SliceHeader* sh) {
  *sh = SliceHeader();
  const u32 pic_size_in_mbs = sps.pic_width_in_mbs * sps.pic_height_in_mbs;
  const bool idr = nal.type == kNalCodedSliceIdr;
  u32 value;
  i32 ivalue;

  if (!ok(br.ue(&value)) || value >= pic_size_in_mbs) return Status::kError;
  sh->first_mb_in_slice = value;

  if (!ok(br.ue(&value))) return Status::kError;
  sh->slice_type = value;
  // I or P only; P forbidden for IDR units and when num_ref_frames == 0
  // (reference slice_header.c:134-143).
  if (!is_i_slice(value) &&
      (!is_p_slice(value) || idr || sps.num_ref_frames == 0)) {
    return Status::kError;
  }

  if (!ok(br.ue(&value)) || value != pps.pps_id) return Status::kError;
  sh->pps_id = value;

  u32 frame_num = br.get_bits(bits_for(sps.max_frame_num));
  if (frame_num == kEndOfStream) return Status::kError;
  if (idr && frame_num != 0) return Status::kError;
  sh->frame_num = frame_num;

  if (idr) {
    if (!ok(br.ue(&value)) || value > 65535) return Status::kError;
    sh->idr_pic_id = value;
  }

  if (sps.poc_type == 0) {
    u32 lsb = br.get_bits(bits_for(sps.max_pic_order_cnt_lsb));
    if (lsb == kEndOfStream) return Status::kError;
    sh->pic_order_cnt_lsb = lsb;
    if (pps.pic_order_present) {
      if (!ok(br.se(&ivalue))) return Status::kError;
      sh->delta_pic_order_cnt_bottom = ivalue;
    }
    // IDR must have POC 0 (reference slice_header.c:204-215)
    i32 bottom = i32(sh->pic_order_cnt_lsb) + sh->delta_pic_order_cnt_bottom;
    if (idr && (sh->pic_order_cnt_lsb > sps.max_pic_order_cnt_lsb / 2 ||
                std::min(i32(sh->pic_order_cnt_lsb), bottom) != 0)) {
      return Status::kError;
    }
  }

  if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
    if (!ok(br.se(&ivalue))) return Status::kError;
    sh->delta_pic_order_cnt[0] = ivalue;
    if (pps.pic_order_present) {
      if (!ok(br.se(&ivalue))) return Status::kError;
      sh->delta_pic_order_cnt[1] = ivalue;
    }
    i32 bottom = sh->delta_pic_order_cnt[0] +
                 sps.offset_for_top_to_bottom_field +
                 sh->delta_pic_order_cnt[1];
    if (idr && std::min(sh->delta_pic_order_cnt[0], bottom) != 0) {
      return Status::kError;
    }
  }

  if (pps.redundant_pic_cnt_present) {
    if (!ok(br.ue(&value)) || value > 127) return Status::kError;
    sh->redundant_pic_cnt = value;
  }

  if (is_p_slice(sh->slice_type)) {
    u32 bit = br.get_bits(1);
    if (bit == kEndOfStream) return Status::kError;
    sh->num_ref_idx_override = bit != 0;
    if (sh->num_ref_idx_override) {
      if (!ok(br.ue(&value)) || value > 15) return Status::kError;
      sh->num_ref_idx_l0_active = value + 1;
    } else {
      // a PPS value over 16 must have been overridden here
      if (pps.num_ref_idx_l0_active > 16) return Status::kError;
      sh->num_ref_idx_l0_active = pps.num_ref_idx_l0_active;
    }

    Status s = decode_reordering(br, &sh->reordering,
                                 sh->num_ref_idx_l0_active, sps.max_frame_num);
    if (!ok(s)) return s;
  }

  if (nal.ref_idc != 0) {
    Status s = decode_marking(br, &sh->marking, nal.type, sps.num_ref_frames);
    if (!ok(s)) return s;
  }

  if (!ok(br.se(&ivalue))) return Status::kError;
  sh->slice_qp_delta = ivalue;
  i32 qp = ivalue + i32(pps.pic_init_qp);
  if (qp < 0 || qp > 51) return Status::kError;

  if (pps.deblocking_filter_control_present) {
    if (!ok(br.ue(&value)) || value > 2) return Status::kError;
    sh->disable_deblocking_filter_idc = value;
    if (value != 1) {
      if (!ok(br.se(&ivalue)) || ivalue < -6 || ivalue > 6) {
        return Status::kError;
      }
      sh->slice_alpha_c0_offset = ivalue * 2;
      if (!ok(br.se(&ivalue)) || ivalue < -6 || ivalue > 6) {
        return Status::kError;
      }
      sh->slice_beta_offset = ivalue * 2;
    }
  }

  if (pps.num_slice_groups > 1 && pps.slice_group_map_type >= 3 &&
      pps.slice_group_map_type <= 5) {
    u32 bits = num_slice_group_change_cycle_bits(pic_size_in_mbs,
                                                 pps.slice_group_change_rate);
    value = br.get_bits(bits);
    if (value == kEndOfStream) return Status::kError;
    sh->slice_group_change_cycle = value;
    u32 max_cycle = (pic_size_in_mbs + pps.slice_group_change_rate - 1) /
                    pps.slice_group_change_rate;
    if (value > max_cycle) return Status::kError;
  }

  return Status::kOk;
}

u32 num_slice_group_change_cycle_bits(u32 pic_size_in_mbs, u32 change_rate) {
  // Ceil(Log2(picSizeInMbs / changeRate + 1)) with non-truncating division
  // (reference slice_header.c:1317-1375).
  u32 tmp = pic_size_in_mbs / change_rate +
            ((pic_size_in_mbs % change_rate) ? 2 : 1);
  u32 num_bits = 0;
  while (tmp >> (num_bits + 1)) num_bits++;
  if (tmp & ((1u << num_bits) - 1)) num_bits++;
  return num_bits;
}

Status check_pps_id(const BitReader& br, u32* pps_id) {
  BitReader t = br;
  u32 value;
  if (!ok(t.ue(&value))) return Status::kError;  // first_mb_in_slice
  if (!ok(t.ue(&value))) return Status::kError;  // slice_type
  if (!ok(t.ue(&value)) || value >= kMaxNumPps) return Status::kError;
  *pps_id = value;
  return Status::kOk;
}

Status check_frame_num(const BitReader& br, u32 max_frame_num,
                       u32* frame_num) {
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  u32 value = t.get_bits(bits_for(max_frame_num));
  if (value == kEndOfStream) return Status::kError;
  *frame_num = value;
  return Status::kOk;
}

Status check_idr_pic_id(const BitReader& br, u32 max_frame_num, NalType type,
                        u32* idr_pic_id) {
  if (type != kNalCodedSliceIdr) return Status::kError;
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  if (t.get_bits(bits_for(max_frame_num)) == kEndOfStream) {
    return Status::kError;
  }
  return t.ue(idr_pic_id);
}

Status check_pic_order_cnt_lsb(const BitReader& br, const Sps& sps,
                               NalType type, u32* poc_lsb) {
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  if (!ok(skip_frame_num_and_idr(t, sps.max_frame_num, type))) {
    return Status::kError;
  }
  u32 value = t.get_bits(bits_for(sps.max_pic_order_cnt_lsb));
  if (value == kEndOfStream) return Status::kError;
  *poc_lsb = value;
  return Status::kOk;
}

Status check_delta_pic_order_cnt_bottom(const BitReader& br, const Sps& sps,
                                        NalType type, i32* delta) {
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  if (!ok(skip_frame_num_and_idr(t, sps.max_frame_num, type))) {
    return Status::kError;
  }
  if (t.get_bits(bits_for(sps.max_pic_order_cnt_lsb)) == kEndOfStream) {
    return Status::kError;
  }
  return t.se(delta);
}

Status check_delta_pic_order_cnt(const BitReader& br, const Sps& sps,
                                 NalType type, bool pic_order_present,
                                 i32 delta[2]) {
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  if (!ok(skip_frame_num_and_idr(t, sps.max_frame_num, type))) {
    return Status::kError;
  }
  if (!ok(t.se(&delta[0]))) return Status::kError;
  if (pic_order_present) {
    if (!ok(t.se(&delta[1]))) return Status::kError;
  }
  return Status::kOk;
}

Status check_prior_pics_flag(const BitReader& br, const Sps& sps,
                             const Pps& pps, NalType type, u32* flag) {
  // IDR slices are I slices: no ref-idx/reordering fields precede the
  // marking syntax (reference slice_header.c:1415-1512).
  BitReader t = br;
  if (!ok(skip_to_frame_num(t))) return Status::kError;
  if (!ok(skip_frame_num_and_idr(t, sps.max_frame_num, type))) {
    return Status::kError;
  }
  i32 ivalue;
  u32 value;
  if (sps.poc_type == 0) {
    if (t.get_bits(bits_for(sps.max_pic_order_cnt_lsb)) == kEndOfStream) {
      return Status::kError;
    }
    if (pps.pic_order_present && !ok(t.se(&ivalue))) return Status::kError;
  }
  if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
    if (!ok(t.se(&ivalue))) return Status::kError;
    if (pps.pic_order_present && !ok(t.se(&ivalue))) return Status::kError;
  }
  if (pps.redundant_pic_cnt_present && !ok(t.ue(&value))) {
    return Status::kError;
  }
  u32 bit = t.get_bits(1);
  if (bit == kEndOfStream) return Status::kError;
  *flag = bit;
  return Status::kOk;
}

}  // namespace h264tpu
