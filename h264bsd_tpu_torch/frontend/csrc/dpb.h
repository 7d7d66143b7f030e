// Decoded picture buffer bookkeeping.
//
// Parity: reference h264bsd_dpb.c. The crucial design change for the TPU
// rebuild: the reference identifies pictures by raw malloc'd data pointers
// (dpbPicture_t.data); here every picture is a small integer *slot id*
// (0..dpb_size) naming a device-resident frame buffer owned by the Python/JAX
// side. All marking/reordering/output logic is bookkeeping over slots; pixel
// data never touches this module.
#pragma once

#include <array>
#include <deque>

#include "common.h"
#include "sliceheader.h"

namespace h264tpu {

enum class PicStatus : u8 {
  kUnused = 0,
  kNonExisting,  // synthesized for frame_num gaps; short-term per the spec
  kShortTerm,
  kLongTerm,
};

struct DpbPicture {
  i32 slot = -1;  // device frame-buffer id (reference dpbPicture_t.data)
  i32 pic_num = 0;
  u32 frame_num = 0;
  i32 pic_order_cnt = 0;
  PicStatus status = PicStatus::kUnused;
  bool to_be_displayed = false;
  u32 pic_id = 0;
  u32 num_err_mbs = 0;
  u32 is_idr = 0;

  bool is_reference() const { return status != PicStatus::kUnused; }
  bool is_existing() const {
    return status == PicStatus::kShortTerm || status == PicStatus::kLongTerm;
  }
  bool is_short_term() const {
    return status == PicStatus::kNonExisting || status == PicStatus::kShortTerm;
  }
  bool is_long_term() const { return status == PicStatus::kLongTerm; }
};

struct DpbOutPicture {
  i32 slot = -1;
  u32 pic_id = 0;
  u32 num_err_mbs = 0;
  u32 is_idr = 0;
};

constexpr u32 kMaxRefIdxL0Active = 16;

class Dpb {
 public:
  // reference h264bsdInitDpb :981 / h264bsdResetDpb :1061 (no pixel allocs;
  // slot ids 0..dpb_size are handed out in order). slot_margin enlarges
  // the device ring by that many SPARE slots rotated FIFO through
  // allocate_image(): a freed slot id is then not handed out again for at
  // least slot_margin subsequent allocations, so a scanned multi-frame
  // device dispatch of up to slot_margin frames never writes the same
  // ring slot twice and its output pictures can read the post-window
  // ring (no per-frame plane stacking). Reference DPB semantics are
  // unchanged — slot ids are opaque to all marking/reorder logic.
  void init(u32 dpb_size, u32 max_ref_frames, u32 max_frame_num,
            bool no_reordering, u32 slot_margin = 0);

  // reference h264bsdAllocateDpbImage :865 — reserve buffer[dpbSize]'s slot
  // for the current picture. Returns the slot id.
  i32 allocate_image();

  // reference h264bsdInitRefPicList :1086.
  void init_ref_pic_list();

  // reference h264bsdReorderRefPicList :225-304.
  Status reorder_ref_pic_list(const RefPicListReordering& order,
                              u32 curr_frame_num, u32 num_ref_idx_active);

  // reference h264bsdMarkDecRefPic :598-830; pass mark == nullptr for
  // non-reference pictures.
  Status mark_dec_ref_pic(const DecRefPicMarking* mark, u32 frame_num,
                          i32 pic_order_cnt, bool is_idr, u32 pic_id,
                          u32 num_err_mbs);

  // reference h264bsdCheckGapsInFrameNum :1218-1330. Appends every
  // synthesized NON_EXISTING frame's slot to *new_non_existing so the device
  // side can initialize those frames deterministically (the reference leaves
  // them as uninitialized malloc memory; we define them as zero-filled).
  Status check_gaps_in_frame_num(u32 frame_num, bool is_ref_pic,
                                 bool gaps_allowed,
                                 std::vector<i32>* new_non_existing);

  // reference h264bsdGetRefPicData :835 — slot id for list index, or -1.
  i32 ref_pic_slot(u32 index) const;

  // reference h264bsdDpbOutputPicture :1462.
  const DpbOutPicture* next_output();

  // reference h264bsdFlushDpb :1491.
  void flush();

  u32 dpb_size() const { return dpb_size_; }
  u32 n_slots() const { return dpb_size_ + 1 + slot_margin_; }
  u32 slot_margin() const { return slot_margin_; }
  u32 num_ref_frames() const { return num_ref_frames_; }
  bool last_contains_mmco5() const { return last_contains_mmco5_; }
  bool no_reordering() const { return no_reordering_; }
  bool initialized() const { return initialized_; }
  void clear_flushed() { flushed_ = false; }

 private:
  i32 compare(const DpbPicture& a, const DpbPicture& b) const;
  void shell_sort();
  void set_pic_nums(u32 curr_frame_num);
  i32 find_pic(i32 pic_num, bool is_short_term) const;
  Status sliding_window_marking();
  const DpbPicture* find_smallest_poc() const;
  Status output_picture();
  void unref_entry(DpbPicture& p);
  Status mmcop1(u32 curr_pic_num, u32 diff);
  Status mmcop2(u32 long_term_pic_num);
  Status mmcop3(u32 curr_pic_num, u32 diff, u32 lt_frame_idx);
  Status mmcop4(u32 max_lt_frame_idx);
  Status mmcop5();
  Status mmcop6(u32 frame_num, i32 poc, u32 lt_frame_idx);

  std::array<DpbPicture, kMaxRefIdxL0Active + 1> buffer_{};
  std::array<i32, kMaxRefIdxL0Active + 1> list_{};  // buffer indices, -1 empty
  std::deque<i32> slot_pool_;  // spare slot ids (FIFO), see init()
  u32 slot_margin_ = 0;
  std::vector<DpbOutPicture> out_buf_;
  u32 num_out_ = 0;
  u32 out_index_ = 0;
  u32 max_ref_frames_ = 0;
  u32 dpb_size_ = 0;
  u32 max_frame_num_ = 0;
  u32 max_long_term_frame_idx_ = kNoLongTermFrameIndices;
  u32 num_ref_frames_ = 0;
  u32 fullness_ = 0;
  u32 prev_ref_frame_num_ = 0;
  bool last_contains_mmco5_ = false;
  bool no_reordering_ = false;
  bool flushed_ = false;
  bool initialized_ = false;
  u32 current_out_ = 0;  // index into buffer_ (reference dpb->currentOut)
};

}  // namespace h264tpu
