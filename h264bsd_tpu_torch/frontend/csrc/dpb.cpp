#include "dpb.h"

namespace h264tpu {

void Dpb::init(u32 dpb_size, u32 max_ref_frames, u32 max_frame_num,
               bool no_reordering, u32 slot_margin) {
  // reference h264bsdInitDpb dpb.c:981-1046 (ResetDpb frees + re-inits; slot
  // ids replace the per-picture mallocs).
  buffer_ = {};
  list_.fill(-1);
  out_buf_.clear();
  num_out_ = out_index_ = 0;
  max_long_term_frame_idx_ = kNoLongTermFrameIndices;
  max_ref_frames_ = std::max(max_ref_frames, 1u);
  dpb_size_ = no_reordering ? max_ref_frames_ : dpb_size;
  max_frame_num_ = max_frame_num;
  no_reordering_ = no_reordering;
  fullness_ = 0;
  num_ref_frames_ = 0;
  prev_ref_frame_num_ = 0;
  last_contains_mmco5_ = false;
  flushed_ = false;
  initialized_ = true;
  for (u32 i = 0; i < dpb_size_ + 1; ++i) buffer_[i].slot = i32(i);
  slot_margin_ = slot_margin;
  slot_pool_.clear();
  for (u32 i = 0; i < slot_margin_; ++i)
    slot_pool_.push_back(i32(dpb_size_ + 1 + i));
  current_out_ = dpb_size_;
}

i32 Dpb::allocate_image() {
  // reference h264bsdAllocateDpbImage dpb.c:865-885: after the sort the
  // buffer position dpbSize is guaranteed free; its slot hosts the new pic.
  current_out_ = dpb_size_;
  if (slot_margin_ > 0) {
    // rotate the free position's slot id through the FIFO spare pool:
    // the freed id waits >= slot_margin_ allocations before reuse, so a
    // scanned device window of up to that many frames never writes one
    // ring slot twice (see dpb.h init docs). The id swap is invisible to
    // the reference bookkeeping — slots are opaque here.
    slot_pool_.push_back(buffer_[current_out_].slot);
    buffer_[current_out_].slot = slot_pool_.front();
    slot_pool_.pop_front();
  }
  return buffer_[current_out_].slot;
}

void Dpb::init_ref_pic_list() {
  for (u32 i = 0; i < num_ref_frames_; ++i) list_[i] = i32(i);
}

i32 Dpb::ref_pic_slot(u32 index) const {
  if (index > 16 || list_[index] < 0) return -1;
  const DpbPicture& p = buffer_[list_[index]];
  return p.is_existing() ? p.slot : -1;
}

void Dpb::set_pic_nums(u32 curr_frame_num) {
  // reference SetPicNums dpb.c:1176-1211: map modulo frame numbers to
  // monotonic picNums relative to the current frame.
  for (u32 i = 0; i < num_ref_frames_; ++i) {
    DpbPicture& p = buffer_[i];
    if (p.is_short_term()) {
      p.pic_num = p.frame_num > curr_frame_num
                      ? i32(p.frame_num) - i32(max_frame_num_)
                      : i32(p.frame_num);
    }
  }
}

i32 Dpb::find_pic(i32 pic_num, bool is_short_term) const {
  for (u32 i = 0; i < max_ref_frames_; ++i) {
    const DpbPicture& p = buffer_[i];
    if (is_short_term ? (p.is_short_term() && p.pic_num == pic_num)
                      : (p.is_long_term() && p.pic_num == pic_num)) {
      return i32(i);
    }
  }
  return -1;
}

Status Dpb::reorder_ref_pic_list(const RefPicListReordering& order,
                                 u32 curr_frame_num, u32 num_ref_idx_active) {
  // reference h264bsdReorderRefPicList dpb.c:225-304.
  set_pic_nums(curr_frame_num);
  if (!order.flag_l0) return Status::kOk;

  u32 ref_idx = 0;
  u32 pic_num_pred = curr_frame_num;
  for (const ReorderCmd& cmd : order.commands) {
    if (cmd.idc >= 3) break;
    i32 pic_num;
    bool is_short_term;
    if (cmd.idc < 2) {
      i32 no_wrap;
      if (cmd.idc == 0) {
        no_wrap = i32(pic_num_pred) - i32(cmd.abs_diff_pic_num);
        if (no_wrap < 0) no_wrap += i32(max_frame_num_);
      } else {
        no_wrap = i32(pic_num_pred + cmd.abs_diff_pic_num);
        if (no_wrap >= i32(max_frame_num_)) no_wrap -= i32(max_frame_num_);
      }
      pic_num_pred = u32(no_wrap);
      pic_num = no_wrap;
      if (u32(no_wrap) > curr_frame_num) pic_num -= i32(max_frame_num_);
      is_short_term = true;
    } else {
      pic_num = i32(cmd.long_term_pic_num);
      is_short_term = false;
    }
    i32 index = find_pic(pic_num, is_short_term);
    if (index < 0 || !buffer_[index].is_existing()) return Status::kError;

    for (u32 j = num_ref_idx_active; j > ref_idx; --j) list_[j] = list_[j - 1];
    list_[ref_idx++] = index;
    u32 k = ref_idx;
    for (u32 j = ref_idx; j <= num_ref_idx_active; ++j) {
      if (list_[j] != index) list_[k++] = list_[j];
    }
  }
  return Status::kOk;
}

void Dpb::unref_entry(DpbPicture& p) {
  p.status = PicStatus::kUnused;
  num_ref_frames_--;
  if (!p.to_be_displayed) fullness_--;
}

Status Dpb::mmcop1(u32 curr_pic_num, u32 diff) {
  i32 index = find_pic(i32(curr_pic_num) - i32(diff), true);
  if (index < 0) return Status::kError;
  unref_entry(buffer_[index]);
  return Status::kOk;
}

Status Dpb::mmcop2(u32 long_term_pic_num) {
  i32 index = find_pic(i32(long_term_pic_num), false);
  if (index < 0) return Status::kError;
  unref_entry(buffer_[index]);
  return Status::kOk;
}

Status Dpb::mmcop3(u32 curr_pic_num, u32 diff, u32 lt_frame_idx) {
  if (max_long_term_frame_idx_ == kNoLongTermFrameIndices ||
      lt_frame_idx > max_long_term_frame_idx_) {
    return Status::kError;
  }
  for (u32 i = 0; i < max_ref_frames_; ++i) {
    if (buffer_[i].is_long_term() && u32(buffer_[i].pic_num) == lt_frame_idx) {
      unref_entry(buffer_[i]);
      break;
    }
  }
  i32 index = find_pic(i32(curr_pic_num) - i32(diff), true);
  if (index < 0 || !buffer_[index].is_existing()) return Status::kError;
  buffer_[index].status = PicStatus::kLongTerm;
  buffer_[index].pic_num = i32(lt_frame_idx);
  return Status::kOk;
}

Status Dpb::mmcop4(u32 max_lt_frame_idx) {
  max_long_term_frame_idx_ = max_lt_frame_idx;
  for (u32 i = 0; i < max_ref_frames_; ++i) {
    if (buffer_[i].is_long_term() &&
        (u32(buffer_[i].pic_num) > max_lt_frame_idx ||
         max_long_term_frame_idx_ == kNoLongTermFrameIndices)) {
      unref_entry(buffer_[i]);
    }
  }
  return Status::kOk;
}

Status Dpb::mmcop5() {
  // reference Mmcop5 dpb.c:507-534 (fixed 0..15 scan bound preserved).
  for (u32 i = 0; i < 16; ++i) {
    if (buffer_[i].is_reference()) {
      buffer_[i].status = PicStatus::kUnused;
      if (!buffer_[i].to_be_displayed) fullness_--;
    }
  }
  while (ok(output_picture())) {
  }
  num_ref_frames_ = 0;
  max_long_term_frame_idx_ = kNoLongTermFrameIndices;
  prev_ref_frame_num_ = 0;
  return Status::kOk;
}

Status Dpb::mmcop6(u32 frame_num, i32 poc, u32 lt_frame_idx) {
  if (max_long_term_frame_idx_ == kNoLongTermFrameIndices ||
      lt_frame_idx > max_long_term_frame_idx_) {
    return Status::kError;
  }
  for (u32 i = 0; i < max_ref_frames_; ++i) {
    if (buffer_[i].is_long_term() && u32(buffer_[i].pic_num) == lt_frame_idx) {
      unref_entry(buffer_[i]);
      break;
    }
  }
  if (num_ref_frames_ < max_ref_frames_) {
    DpbPicture& cur = buffer_[current_out_];
    cur.frame_num = frame_num;
    cur.pic_num = i32(lt_frame_idx);
    cur.pic_order_cnt = poc;
    cur.status = PicStatus::kLongTerm;
    cur.to_be_displayed = !no_reordering_;
    num_ref_frames_++;
    fullness_++;
    return Status::kOk;
  }
  return Status::kError;
}

Status Dpb::mark_dec_ref_pic(const DecRefPicMarking* mark, u32 frame_num,
                             i32 pic_order_cnt, bool is_idr, u32 pic_id,
                             u32 num_err_mbs) {
  // reference h264bsdMarkDecRefPic dpb.c:598-830.
  last_contains_mmco5_ = false;
  Status status = Status::kOk;
  const bool to_be_displayed = !no_reordering_;
  DpbPicture& cur = buffer_[current_out_];

  if (mark == nullptr) {
    cur.status = PicStatus::kUnused;
    cur.frame_num = frame_num;
    cur.pic_num = i32(frame_num);
    cur.pic_order_cnt = pic_order_cnt;
    cur.to_be_displayed = to_be_displayed;
    if (!no_reordering_) fullness_++;
  } else if (is_idr) {
    // CheckGapsInFrameNum is not called for IDR -> reset output queue here.
    num_out_ = out_index_ = 0;
    out_buf_.clear();
    mmcop5();
    if (mark->no_output_of_prior_pics || no_reordering_) {
      num_out_ = out_index_ = 0;
      out_buf_.clear();
    }
    if (mark->long_term_reference) {
      cur.status = PicStatus::kLongTerm;
      max_long_term_frame_idx_ = 0;
    } else {
      cur.status = PicStatus::kShortTerm;
      max_long_term_frame_idx_ = kNoLongTermFrameIndices;
    }
    cur.frame_num = 0;
    cur.pic_num = 0;
    cur.pic_order_cnt = 0;
    cur.to_be_displayed = to_be_displayed;
    fullness_ = 1;
    num_ref_frames_ = 1;
  } else {
    bool marked_as_long_term = false;
    if (mark->adaptive_mode) {
      for (const MmcOperation& op : mark->operations) {
        if (op.op == 0) break;
        switch (op.op) {
          case 1: status = mmcop1(frame_num, op.difference_of_pic_nums); break;
          case 2: status = mmcop2(op.long_term_pic_num); break;
          case 3:
            status = mmcop3(frame_num, op.difference_of_pic_nums,
                            op.long_term_frame_idx);
            break;
          case 4: status = mmcop4(op.max_long_term_frame_idx); break;
          case 5:
            status = mmcop5();
            last_contains_mmco5_ = true;
            frame_num = 0;
            break;
          case 6:
            status = mmcop6(frame_num, pic_order_cnt, op.long_term_frame_idx);
            if (ok(status)) marked_as_long_term = true;
            break;
          default: status = Status::kError; break;
        }
        if (!ok(status)) break;
      }
    } else {
      status = sliding_window_marking();
    }
    if (!marked_as_long_term) {
      if (num_ref_frames_ < max_ref_frames_) {
        cur.frame_num = frame_num;
        cur.pic_num = i32(frame_num);
        cur.pic_order_cnt = pic_order_cnt;
        cur.status = PicStatus::kShortTerm;
        cur.to_be_displayed = to_be_displayed;
        fullness_++;
        num_ref_frames_++;
      } else {
        status = Status::kError;
      }
    }
  }

  cur.is_idr = is_idr ? 1 : 0;
  cur.pic_id = pic_id;
  cur.num_err_mbs = num_err_mbs;

  if (no_reordering_) {
    out_buf_.push_back({cur.slot, cur.pic_id, cur.num_err_mbs, cur.is_idr});
    num_out_++;
  } else {
    while (fullness_ > dpb_size_) output_picture();
  }

  shell_sort();
  return status;
}

Status Dpb::sliding_window_marking() {
  // reference SlidingWindowRefPicMarking dpb.c:897-943.
  if (num_ref_frames_ < max_ref_frames_) return Status::kOk;
  i32 index = -1;
  i32 pic_num = 0;
  for (u32 i = 0; i < num_ref_frames_; ++i) {
    if (buffer_[i].is_short_term() &&
        (buffer_[i].pic_num < pic_num || index == -1)) {
      index = i32(i);
      pic_num = buffer_[i].pic_num;
    }
  }
  if (index < 0) return Status::kError;
  unref_entry(buffer_[index]);
  return Status::kOk;
}

Status Dpb::check_gaps_in_frame_num(u32 frame_num, bool is_ref_pic,
                                    bool gaps_allowed,
                                    std::vector<i32>* new_non_existing) {
  // reference h264bsdCheckGapsInFrameNum dpb.c:1218-1330.
  num_out_ = 0;
  out_index_ = 0;
  out_buf_.clear();

  if (!gaps_allowed) return Status::kOk;

  if (frame_num != prev_ref_frame_num_ &&
      frame_num != (prev_ref_frame_num_ + 1) % max_frame_num_) {
    u32 unused_fn = (prev_ref_frame_num_ + 1) % max_frame_num_;
    // remember the free slot: if the gap processing pushes it into the
    // output queue it must be swapped back so the next allocate_image()
    // does not overwrite a picture pending display
    i32 saved_slot = buffer_[dpb_size_].slot;
    do {
      set_pic_nums(unused_fn);
      if (!ok(sliding_window_marking())) return Status::kError;
      while (fullness_ >= dpb_size_) output_picture();

      DpbPicture& tail = buffer_[dpb_size_];
      tail.status = PicStatus::kNonExisting;
      tail.frame_num = unused_fn;
      tail.pic_num = i32(unused_fn);
      tail.pic_order_cnt = 0;
      tail.to_be_displayed = false;
      if (new_non_existing) new_non_existing->push_back(tail.slot);
      fullness_++;
      num_ref_frames_++;
      shell_sort();

      unused_fn = (unused_fn + 1) % max_frame_num_;
    } while (unused_fn != frame_num);

    if (num_out_) {
      for (u32 i = 0; i < num_out_; ++i) {
        if (out_buf_[i].slot == buffer_[dpb_size_].slot) {
          for (u32 j = 0; j < dpb_size_; ++j) {
            if (buffer_[j].slot == saved_slot) {
              buffer_[j].slot = buffer_[dpb_size_].slot;
              buffer_[dpb_size_].slot = saved_slot;
              break;
            }
          }
          break;
        }
      }
    }
  } else if (is_ref_pic && frame_num == prev_ref_frame_num_) {
    return Status::kError;
  }

  if (is_ref_pic) {
    prev_ref_frame_num_ = frame_num;
  } else if (frame_num != prev_ref_frame_num_) {
    prev_ref_frame_num_ = (frame_num + max_frame_num_ - 1) % max_frame_num_;
  }
  return Status::kOk;
}

const DpbPicture* Dpb::find_smallest_poc() const {
  i32 best = 0x7FFFFFFF;
  const DpbPicture* out = nullptr;
  for (u32 i = 0; i <= dpb_size_; ++i) {
    if (buffer_[i].to_be_displayed && buffer_[i].pic_order_cnt < best) {
      out = &buffer_[i];
      best = buffer_[i].pic_order_cnt;
    }
  }
  return out;
}

Status Dpb::output_picture() {
  // reference OutputPicture dpb.c:1413-1459.
  if (no_reordering_) return Status::kError;
  const DpbPicture* found = find_smallest_poc();
  if (!found) return Status::kError;
  DpbPicture* pic = const_cast<DpbPicture*>(found);
  out_buf_.push_back({pic->slot, pic->pic_id, pic->num_err_mbs, pic->is_idr});
  num_out_++;
  pic->to_be_displayed = false;
  if (!pic->is_reference()) fullness_--;
  return Status::kOk;
}

const DpbOutPicture* Dpb::next_output() {
  if (out_index_ < num_out_) return &out_buf_[out_index_++];
  return nullptr;
}

void Dpb::flush() {
  if (!initialized_) return;
  flushed_ = true;
  while (ok(output_picture())) {
  }
}

i32 Dpb::compare(const DpbPicture& a, const DpbPicture& b) const {
  // reference ComparePictures dpb.c:139-197: short-term refs by descending
  // picNum, then long-term by ascending picNum, then to-be-displayed
  // non-references, then the rest.
  if (!a.is_reference() && !b.is_reference()) {
    if (a.to_be_displayed && !b.to_be_displayed) return -1;
    if (!a.to_be_displayed && b.to_be_displayed) return 1;
    return 0;
  }
  if (!b.is_reference()) return -1;
  if (!a.is_reference()) return 1;
  if (a.is_short_term() && b.is_short_term()) {
    return a.pic_num > b.pic_num ? -1 : (a.pic_num < b.pic_num ? 1 : 0);
  }
  if (a.is_short_term()) return -1;
  if (b.is_short_term()) return 1;
  return a.pic_num > b.pic_num ? 1 : (a.pic_num < b.pic_num ? -1 : 0);
}

void Dpb::shell_sort() {
  // Identical diminishing-increment sort (steps 7,3,1) as the reference
  // (dpb.c:1550-1585) so equal-key orderings match exactly.
  const u32 num = dpb_size_ + 1;
  for (u32 step = 7; step; step >>= 1) {
    for (u32 i = step; i < num; ++i) {
      DpbPicture tmp = buffer_[i];
      u32 j = i;
      while (j >= step && compare(buffer_[j - step], tmp) > 0) {
        buffer_[j] = buffer_[j - step];
        j -= step;
      }
      buffer_[j] = tmp;
    }
  }
}

}  // namespace h264tpu
