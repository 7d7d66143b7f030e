#include "decoder.h"

#include <algorithm>

#include "slicegroupmap.h"
#include <cstdio>
#include <cstdlib>

#define H264TPU_DBG(...) do { if (getenv("H264TPU_DEBUG")) fprintf(stderr, __VA_ARGS__); } while (0)

namespace h264tpu {

Status Decoder::check_pps_vs_sps(const Pps& pps, const Sps& sps) const {
  // reference CheckPps storage.c:772-825
  u32 pic_size = sps.pic_width_in_mbs * sps.pic_height_in_mbs;
  if (pps.num_slice_groups > 1) {
    if (pps.slice_group_map_type == 0) {
      for (u32 r : pps.run_length) {
        if (r > pic_size) return Status::kError;
      }
    } else if (pps.slice_group_map_type == 2) {
      for (u32 i = 0; i + 1 < pps.num_slice_groups; ++i) {
        if (pps.top_left[i] > pps.bottom_right[i] ||
            pps.bottom_right[i] >= pic_size) {
          return Status::kError;
        }
        if (pps.top_left[i] % sps.pic_width_in_mbs >
            pps.bottom_right[i] % sps.pic_width_in_mbs) {
          return Status::kError;
        }
      }
    } else if (pps.slice_group_map_type > 2 && pps.slice_group_map_type < 6) {
      if (pps.slice_group_change_rate > pic_size) return Status::kError;
    } else if (pps.slice_group_map_type == 6 &&
               pps.pic_size_in_map_units < pic_size) {
      return Status::kError;
    }
  }
  return Status::kOk;
}

Status Decoder::store_sps(Sps&& sps) {
  // reference h264bsdStoreSeqParamSet storage.c:127-185
  u32 id = sps.sps_id;
  if (sps_[id] && id == active_sps_id_) {
    if (!(sps == *sps_[id])) {
      active_sps_id_ = kMaxNumSps + 1;
      active_pps_id_ = kMaxNumPps + 1;
      active_sps_ = nullptr;
      active_pps_ = nullptr;
    } else {
      return Status::kOk;  // identical re-send of the active SPS
    }
  }
  // overwrite in place: active_sps_ may point at this slot and must keep
  // seeing valid (updated) contents, as in the reference where the slot
  // allocation is reused (storage.c:180-182)
  if (sps_[id]) {
    *sps_[id] = std::move(sps);
  } else {
    sps_[id] = std::make_unique<Sps>(std::move(sps));
  }
  return Status::kOk;
}

Status Decoder::store_pps(Pps&& pps) {
  // reference h264bsdStorePicParamSet storage.c:209-262
  u32 id = pps.pps_id;
  if (pps_[id] && id == active_pps_id_ &&
      pps.sps_id != active_sps_id_) {
    active_pps_id_ = kMaxNumPps + 1;
  }
  if (pps_[id]) {
    *pps_[id] = std::move(pps);  // keep active_pps_ pointing at live data
  } else {
    pps_[id] = std::make_unique<Pps>(std::move(pps));
  }
  return Status::kOk;
}

u32 Decoder::activate_param_sets(u32 pps_id, bool is_idr) {
  // reference h264bsdActivateParamSets storage.c:267-419
  if (!pps_[pps_id] || !sps_[pps_[pps_id]->sps_id]) return kParamSetError;
  const Pps& pps = *pps_[pps_id];
  const Sps& sps = *sps_[pps.sps_id];
  if (!ok(check_pps_vs_sps(pps, sps))) return kParamSetError;

  if (active_pps_id_ == kMaxNumPps) {
    // first activation, phase 1
    active_pps_id_ = pps_id;
    active_pps_ = &pps;
    active_sps_id_ = pps.sps_id;
    active_sps_ = &sps;
    pic_size_in_mbs_ = sps.pic_width_in_mbs * sps.pic_height_in_mbs;
    pending_activation_ = true;
  } else if (pending_activation_) {
    // phase 2: allocate per-picture structures and (re)initialize DPB
    pending_activation_ = false;
    parser_.configure(active_sps_->pic_width_in_mbs,
                      active_sps_->pic_height_in_mbs);
    tensors_.reset(active_sps_->pic_width_in_mbs,
                   active_sps_->pic_height_in_mbs);
    slice_group_map_.assign(pic_size_in_mbs_, 0);

    bool no_reorder_flag =
        no_reordering_ || active_sps_->poc_type == 2 ||
        (active_sps_->vui_present && active_sps_->vui &&
         active_sps_->vui->bitstream_restriction &&
         active_sps_->vui->num_reorder_frames == 0);
    // clamp the requested window slot margin so every device-ring slot
    // id stays < 32 (used_slot_mask is a u32 bitmask, mbparse.cpp:1065)
    u32 base_slots = active_sps_->max_dpb_size + 1;
    u32 margin = base_slots < 32 ? std::min(slot_margin_req_,
                                            32 - base_slots) : 0;
    dpb_.init(active_sps_->max_dpb_size, active_sps_->num_ref_frames,
              active_sps_->max_frame_num, no_reorder_flag, margin);
  } else if (pps_id != active_pps_id_) {
    if (pps.sps_id != active_sps_id_) {
      if (!is_idr) return kDecodeError;  // SPS may change only at IDR
      active_pps_id_ = pps_id;
      active_pps_ = &pps;
      active_sps_id_ = pps.sps_id;
      active_sps_ = &sps;
      pic_size_in_mbs_ = sps.pic_width_in_mbs * sps.pic_height_in_mbs;
      pending_activation_ = true;
    } else {
      active_pps_id_ = pps_id;
      active_pps_ = &pps;
    }
  }
  return kRdy;
}

Status Decoder::check_access_unit_boundary(const BitReader& br,
                                           const NalUnit& nal,
                                           bool* boundary) {
  // reference h264bsdCheckAccessUnitBoundary storage.c:593-770
  *boundary = false;
  u32 t = nal.type;
  if ((t > 5 && t < 12) || (t > 12 && t <= 18)) {
    *boundary = true;
    return Status::kOk;
  }
  if (t != kNalCodedSlice && t != kNalCodedSliceIdr) return Status::kOk;

  if (aub_.first_call) {
    *boundary = true;
    aub_.first_call = false;
  }

  u32 pps_id;
  Status s = check_pps_id(br, &pps_id);
  if (!ok(s)) return s;
  const Pps* pps = pps_[pps_id].get();
  if (!pps || !sps_[pps->sps_id] ||
      (active_sps_id_ != kMaxNumSps && pps->sps_id != active_sps_id_ &&
       nal.type != kNalCodedSliceIdr)) {
    return Status::kParamSetError;
  }
  const Sps* sps = sps_[pps->sps_id].get();

  if (aub_.nu_prev.ref_idc != nal.ref_idc &&
      (aub_.nu_prev.ref_idc == 0 || nal.ref_idc == 0)) {
    *boundary = true;
  }
  if ((aub_.nu_prev.type == kNalCodedSliceIdr) !=
      (nal.type == kNalCodedSliceIdr)) {
    *boundary = true;
  }

  u32 frame_num;
  if (!ok(check_frame_num(br, sps->max_frame_num, &frame_num))) {
    return Status::kError;
  }
  if (aub_.prev_frame_num != frame_num) {
    aub_.prev_frame_num = frame_num;
    *boundary = true;
  }

  if (nal.type == kNalCodedSliceIdr) {
    u32 idr_pic_id;
    if (!ok(check_idr_pic_id(br, sps->max_frame_num, nal.type, &idr_pic_id))) {
      return Status::kError;
    }
    if (aub_.nu_prev.type == kNalCodedSliceIdr &&
        aub_.prev_idr_pic_id != idr_pic_id) {
      *boundary = true;
    }
    aub_.prev_idr_pic_id = idr_pic_id;
  }

  if (sps->poc_type == 0) {
    u32 lsb;
    if (!ok(check_pic_order_cnt_lsb(br, *sps, nal.type, &lsb))) {
      return Status::kError;
    }
    if (aub_.prev_pic_order_cnt_lsb != lsb) {
      aub_.prev_pic_order_cnt_lsb = lsb;
      *boundary = true;
    }
    if (pps->pic_order_present) {
      i32 delta;
      s = check_delta_pic_order_cnt_bottom(br, *sps, nal.type, &delta);
      if (!ok(s)) return s;
      if (aub_.prev_delta_pic_order_cnt_bottom != delta) {
        aub_.prev_delta_pic_order_cnt_bottom = delta;
        *boundary = true;
      }
    }
  } else if (sps->poc_type == 1 && !sps->delta_pic_order_always_zero) {
    i32 delta[2] = {0, 0};
    s = check_delta_pic_order_cnt(br, *sps, nal.type, pps->pic_order_present,
                                  delta);
    if (!ok(s)) return s;
    if (aub_.prev_delta_pic_order_cnt[0] != delta[0]) {
      aub_.prev_delta_pic_order_cnt[0] = delta[0];
      *boundary = true;
    }
    if (pps->pic_order_present &&
        aub_.prev_delta_pic_order_cnt[1] != delta[1]) {
      aub_.prev_delta_pic_order_cnt[1] = delta[1];
      *boundary = true;
    }
  }

  aub_.nu_prev = nal;
  return Status::kOk;
}

void Decoder::prepare_concealment(bool /*unused*/) {
  // State half of h264bsdConceal (conceal.c:124-254): mark undecoded MBs as
  // concealed intra MBs with qp 40 so deblocking smooths them; whole-picture
  // loss disables filtering entirely. Pixel concealment runs on the
  // JAX side, driven by mb_class == concealed + the conceal_* info fields.
  bool any_decoded = false;
  for (u32 i = 0; i < pic_size_in_mbs_; ++i) {
    if (tensors_.decoded[i]) {
      any_decoded = true;
      break;
    }
  }
  for (u32 i = 0; i < pic_size_in_mbs_; ++i) {
    if (!tensors_.decoded[i]) {
      num_concealed_mbs_++;
      tensors_.mb_class[i] = kMbConcealed;
      tensors_.qp_y[i] = 40;
      tensors_.disable_dblk[i] = 0;
      tensors_.filter_off_a[i] = 0;
      tensors_.filter_off_b[i] = 0;
      tensors_.chroma_qp_offset[i] = 0;  // ConcealMb conceal.c:317
      tensors_.decoded[i] = 1;
    }
  }
  if (!any_decoded) {
    // whole picture lost -> no in-loop filtering (conceal.c:190-196)
    for (u32 i = 0; i < pic_size_in_mbs_; ++i) tensors_.disable_dblk[i] = 1;
  }
}

u32 Decoder::decode(const u8* data, u32 len, u32 pic_id, u32* read_bytes) {
  return decode_inner(data, len, pic_id, read_bytes);
}

u32 Decoder::decode_inner(const u8* data, u32 len, u32 pic_id,
                          u32* read_bytes) {
  // reference h264bsdDecode decoder.c:152-515
  BitReader br;

  // per-NAL resume: same buffer pointer and unfinished previous call ->
  // reuse the stored RBSP instead of re-extracting (decoder.c:174-196)
  if (prev_buf_not_finished_ && data == prev_buf_pointer_) {
    br = BitReader(saved_rbsp_.data(), u32(saved_rbsp_.size()));
    *read_bytes = prev_bytes_consumed_;
  } else {
    ExtractedNal nal_buf;
    if (!ok(extractor_.extract(data, len, &nal_buf))) return kDecodeError;
    saved_rbsp_.assign(nal_buf.rbsp, nal_buf.rbsp + nal_buf.rbsp_size);
    br = BitReader(saved_rbsp_.data(), u32(saved_rbsp_.size()));
    *read_bytes = nal_buf.read_bytes;
    prev_bytes_consumed_ = nal_buf.read_bytes;
    prev_buf_pointer_ = data;
  }
  prev_buf_not_finished_ = false;

  NalUnit nal;
  if (!ok(NalExtractor::decode_nal_header(br, &nal))) return kDecodeError;

  // discard unspecified/reserved/SPS-ext/aux NAL units (decoder.c:206-210)
  if (nal.type == 0 || nal.type >= 13) return kRdy;

  bool boundary = false;
  Status s = check_access_unit_boundary(br, nal, &boundary);
  if (!ok(s)) {
    return s == Status::kParamSetError ? kParamSetError : kDecodeError;
  }

  bool pic_ready = false;
  u32 conceal_slice_type = 0;

  if (boundary) {
    if (pic_started_ && active_sps_ != nullptr) {
      if (pending_activation_) return kDecodeError;
      if (!valid_slice_in_access_unit_) {
        curr_slot_ = dpb_.allocate_image();
        dpb_.init_ref_pic_list();
        conceal_slice_type = kPSliceType;
      } else {
        conceal_slice_type = slice_header_[0].slice_type;
      }
      prepare_concealment(false);
      pic_ready = true;
      // current NAL re-decoded after the concealed picture is finished
      *read_bytes = 0;
      prev_buf_not_finished_ = true;
    } else {
      valid_slice_in_access_unit_ = false;
    }
    skip_redundant_slices_ = false;
  }

  if (!pic_ready) {
    switch (nal.type) {
      case kNalSps: {
        Sps sps;
        if (!ok(decode_sps(br, &sps))) return kDecodeError;
        store_sps(std::move(sps));
        break;
      }

      case kNalPps: {
        Pps pps;
        if (!ok(decode_pps(br, &pps))) return kDecodeError;
        store_pps(std::move(pps));
        break;
      }

      case kNalCodedSliceIdr:
      case kNalCodedSlice: {
        if (skip_redundant_slices_) return kRdy;

        pic_started_ = true;
        const bool is_idr = nal.type == kNalCodedSliceIdr;

        if (!valid_slice_in_access_unit_) {  // start of picture
          num_concealed_mbs_ = 0;
          current_pic_id_ = pic_id;
          // deferred h264bsdResetStorage (storage.c:441): per-MB decode
          // state is cleared at the start of the next picture so the
          // just-finished picture's tensors stay readable after kPicRdy
          parser_.reset_picture(&tensors_);

          u32 pps_id;
          if (!ok(check_pps_id(br, &pps_id))) return kDecodeError;
          u32 old_active_sps = active_sps_id_;
          u32 act = activate_param_sets(pps_id, is_idr);
          if (act != kRdy) {
            active_pps_id_ = kMaxNumPps;
            active_pps_ = nullptr;
            active_sps_id_ = kMaxNumSps;
            active_sps_ = nullptr;
            pending_activation_ = false;
            return act == kMemAllocError ? kMemAllocError : kParamSetError;
          }

          if (old_active_sps != active_sps_id_) {
            // SPS switch: report headers-ready, re-decode this NAL next call
            // (decoder.c:343-389)
            const Sps* old_sps = old_sps_id_ < kMaxNumSps
                                     ? sps_[old_sps_id_].get()
                                     : nullptr;
            const Sps* new_sps = active_sps_;
            *read_bytes = 0;
            prev_buf_not_finished_ = true;

            u32 no_output_of_prior = 1;
            bool got_flag = false;
            if (is_idr) {
              got_flag = ok(check_prior_pics_flag(br, *new_sps, *active_pps_,
                                                  nal.type,
                                                  &no_output_of_prior));
            }
            if (!got_flag || no_output_of_prior != 0 ||
                dpb_.no_reordering() || old_sps == nullptr ||
                old_sps->pic_width_in_mbs != new_sps->pic_width_in_mbs ||
                old_sps->pic_height_in_mbs != new_sps->pic_height_in_mbs ||
                old_sps->max_dpb_size != new_sps->max_dpb_size) {
              dpb_.clear_flushed();
            } else {
              dpb_.flush();
            }
            old_sps_id_ = active_sps_id_;
            return kHdrsRdy;
          }
        }

        if (pending_activation_) return kDecodeError;

        if (!ok(decode_slice_header(br, *active_sps_, *active_pps_, nal,
                                    &slice_header_[1]))) {
          H264TPU_DBG("err: slice_header\n");
          return kDecodeError;
        }

        if (!valid_slice_in_access_unit_) {
          if (!is_idr) {
            if (!ok(dpb_.check_gaps_in_frame_num(
                    slice_header_[1].frame_num, nal.ref_idc != 0,
                    active_sps_->gaps_in_frame_num_allowed,
                    &non_existing_))) {
              return kDecodeError;
            }
          }
          curr_slot_ = dpb_.allocate_image();
        }

        slice_header_[0] = slice_header_[1];
        valid_slice_in_access_unit_ = true;
        prev_nal_ = nal;

        decode_slice_group_map(slice_group_map_.data(), *active_pps_,
                               slice_header_[0].slice_group_change_cycle,
                               active_sps_->pic_width_in_mbs,
                               active_sps_->pic_height_in_mbs);

        dpb_.init_ref_pic_list();
        if (!ok(dpb_.reorder_ref_pic_list(slice_header_[0].reordering,
                                          slice_header_[0].frame_num,
                                          slice_header_[0].num_ref_idx_l0_active))) {
          H264TPU_DBG("err: reorder\n");
          return kDecodeError;
        }

        slice_id_counter_++;
        u32 decoded_count = 0;
        u32 last_mb = 0;
        s = parser_.decode_slice_data(br, slice_header_[0], *active_sps_,
                                      *active_pps_, dpb_,
                                      slice_group_map_.data(),
                                      slice_id_counter_, &tensors_,
                                      &decoded_count, &last_mb);
        if (!ok(s)) {
          H264TPU_DBG("err: slice_data\n");
          parser_.mark_slice_corrupted(slice_header_[0].first_mb_in_slice,
                                       slice_id_counter_, last_mb,
                                       slice_group_map_.data(), &tensors_);
          return kDecodeError;
        }
        if (num_decoded_mbs_ + decoded_count > pic_size_in_mbs_) {
          return kDecodeError;
        }
        num_decoded_mbs_ += decoded_count;

        // end of picture? (reference h264bsdIsEndOfPicture storage.c:528)
        bool end;
        if (!slice_header_[0].redundant_pic_cnt) {
          end = num_decoded_mbs_ == pic_size_in_mbs_;
        } else {
          u32 total = 0;
          for (u32 i = 0; i < pic_size_in_mbs_; ++i) {
            total += tensors_.decoded[i] ? 1 : 0;
          }
          end = total == pic_size_in_mbs_;
        }
        if (end) {
          pic_ready = true;
          skip_redundant_slices_ = true;
          conceal_slice_type = slice_header_[0].slice_type;
        }
        break;
      }

      case kNalSei:
        // The reference logs "SEI MESSAGE, NOT DECODED" and skips the NAL
        // (decoder.c:464-466; its h264bsd_sei.c parser is dead code).
        // Queue the RBSP payload so frontend/sei.py can decode the
        // messages without perturbing the decode state machine.
        if (saved_rbsp_.size() > 1) {
          if (sei_queue_.size() >= 64)
            sei_queue_.erase(sei_queue_.begin());
          sei_queue_.emplace_back(saved_rbsp_.begin() + 1,
                                  saved_rbsp_.end());
        }
        break;

      default:
        break;
    }
  }

  if (pic_ready) {
    // epilogue (decoder.c:473-511): the pixel side now deblocks + stores the
    // frame; here the bookkeeping half runs.
    pic_info_ = PicReadyInfo();
    pic_info_.slot = curr_slot_;
    pic_info_.pic_id = current_pic_id_;
    pic_info_.is_idr = prev_nal_.type == kNalCodedSliceIdr;
    pic_info_.frame_num = slice_header_[0].frame_num;
    pic_info_.num_concealed_mbs = num_concealed_mbs_;
    pic_info_.slice_type = conceal_slice_type;
    if (num_concealed_mbs_ > 0) {
      // Per-MB concealment follows the SLICE TYPE (ConcealMb
      // conceal.c:319-345: P copies the co-located reference MB, I
      // synthesizes from neighbour pels — refData is ignored for I).
      // intraConcealmentFlag (storage.h:148, read at conceal.c:146-157
      // and :173-176) only changes the whole-picture-lost case: a fully
      // lost I picture copies the reference instead of going grey.
      bool whole_lost = num_concealed_mbs_ >= pic_size_in_mbs_;
      pic_info_.conceal_from_ref =
          is_p_slice(conceal_slice_type) ||
          (intra_concealment_ && whole_lost);
      if (pic_info_.conceal_from_ref) {
        // use reference picture with the smallest available index
        // (conceal.c:147-158)
        pic_info_.conceal_ref_slot = -1;
        for (u32 i = 0; i < 16; ++i) {
          i32 slot = dpb_.ref_pic_slot(i);
          if (slot >= 0) {
            pic_info_.conceal_ref_slot = slot;
            break;
          }
        }
      }
    }

    // reset per-picture counters (rest of h264bsdResetStorage is deferred
    // to the next picture start; see above)
    u32 concealed = num_concealed_mbs_;
    num_decoded_mbs_ = 0;
    slice_id_counter_ = 0;

    i32 poc = decode_pic_order_cnt(&poc_, *active_sps_, slice_header_[0],
                                   prev_nal_);
    pic_info_.pic_order_cnt = poc;

    if (valid_slice_in_access_unit_) {
      const DecRefPicMarking* mark =
          prev_nal_.ref_idc ? &slice_header_[0].marking : nullptr;
      dpb_.mark_dec_ref_pic(mark, slice_header_[0].frame_num, poc,
                            prev_nal_.type == kNalCodedSliceIdr,
                            current_pic_id_, concealed);
    }

    pic_started_ = false;
    valid_slice_in_access_unit_ = false;
    return kPicRdy;
  }
  return kRdy;
}

bool Decoder::cropping_params(u32* left, u32* width, u32* top,
                              u32* height) const {
  // reference h264bsdCroppingParams decoder.c:970-1010
  if (!active_sps_ || !active_sps_->frame_cropping) {
    *left = *top = 0;
    *width = active_sps_ ? active_sps_->pic_width_in_mbs * 16 : 0;
    *height = active_sps_ ? active_sps_->pic_height_in_mbs * 16 : 0;
    return false;
  }
  *left = active_sps_->crop_left * 2;
  *width = active_sps_->pic_width_in_mbs * 16 -
           2 * (active_sps_->crop_left + active_sps_->crop_right);
  *top = active_sps_->crop_top * 2;
  *height = active_sps_->pic_height_in_mbs * 16 -
            2 * (active_sps_->crop_top + active_sps_->crop_bottom);
  return true;
}

void Decoder::sample_aspect_ratio(u32* sar_w, u32* sar_h) const {
  // reference h264bsdSampleAspectRatio decoder.c:1019-1080
  *sar_w = 0;
  *sar_h = 0;
  if (!active_sps_ || !active_sps_->vui_present || !active_sps_->vui ||
      !active_sps_->vui->aspect_ratio_present) {
    return;
  }
  static const u32 table[17][2] = {
      {0, 0},   {1, 1},   {12, 11}, {10, 11}, {16, 11}, {40, 33},
      {24, 11}, {20, 11}, {32, 11}, {80, 33}, {18, 11}, {15, 11},
      {64, 33}, {160, 99}, {4, 3},  {3, 2},   {2, 1}};
  u32 idc = active_sps_->vui->aspect_ratio_idc;
  if (idc < 17) {
    *sar_w = table[idc][0];
    *sar_h = table[idc][1];
  } else if (idc == kExtendedSar) {
    *sar_w = active_sps_->vui->sar_width;
    *sar_h = active_sps_->vui->sar_height;
  }
}

bool Decoder::video_full_range() const {
  return active_sps_ && active_sps_->vui_present && active_sps_->vui &&
         active_sps_->vui->video_signal_type_present &&
         active_sps_->vui->video_full_range;
}

u32 Decoder::matrix_coefficients() const {
  if (active_sps_ && active_sps_->vui_present && active_sps_->vui &&
      active_sps_->vui->video_signal_type_present &&
      active_sps_->vui->colour_description_present) {
    return active_sps_->vui->matrix_coefficients;
  }
  return 2;  // default: unspecified
}

int Decoder::peek_idr_boundary(const u8* data, u32 len) {
  NalExtractor ex;
  ExtractedNal n;
  if (!ok(ex.extract(data, len, &n))) return -1;
  BitReader br(n.rbsp, n.rbsp_size);
  NalUnit nu;
  if (!ok(NalExtractor::decode_nal_header(br, &nu))) return -1;
  if (nu.type != kNalCodedSliceIdr) return -1;
  u32 first_mb, slice_type, pps_id, value;
  if (!ok(br.ue(&first_mb))) return -1;
  if (first_mb != 0) return 0;
  if (!ok(br.ue(&slice_type))) return -1;
  if (!ok(br.ue(&pps_id)) || pps_id >= kMaxNumPps || !pps_[pps_id]) {
    return -1;
  }
  const Pps& pps = *pps_[pps_id];
  if (!pps.redundant_pic_cnt_present) return 1;
  if (pps.sps_id >= kMaxNumSps || !sps_[pps.sps_id]) return -1;
  const Sps& sps = *sps_[pps.sps_id];
  // skip frame_num, idr_pic_id and the POC fields exactly as the slice
  // header codes them (reference CheckRedundantPicCnt
  // slice_header.c:1239-1375), then read redundant_pic_cnt
  u32 frame_bits = 0;
  while (sps.max_frame_num >> frame_bits) frame_bits++;
  if (br.get_bits(frame_bits - 1) == kEndOfStream) return -1;
  if (!ok(br.ue(&value))) return -1;  // idr_pic_id
  i32 ivalue;
  if (sps.poc_type == 0) {
    u32 lsb_bits = 0;
    while (sps.max_pic_order_cnt_lsb >> lsb_bits) lsb_bits++;
    if (br.get_bits(lsb_bits - 1) == kEndOfStream) return -1;
    if (pps.pic_order_present && !ok(br.se(&ivalue))) return -1;
  }
  if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
    if (!ok(br.se(&ivalue))) return -1;
    if (pps.pic_order_present && !ok(br.se(&ivalue))) return -1;
  }
  if (!ok(br.ue(&value)) || value > 127) return -1;
  return value == 0 ? 1 : 0;
}

}  // namespace h264tpu
