// Top-level decoder instance and per-NAL state machine.
// Parity: reference h264bsd_decoder.c:90-515 (h264bsdInit/h264bsdDecode) and
// h264bsd_storage.c (parameter-set registries, activation handshake,
// access-unit-boundary bookkeeping).
//
// The instance owns all host parse state; pixel reconstruction happens on the
// JAX/Pallas side which consumes FrameTensors + the per-picture events this
// class reports (DPB slot allocation, concealment requests, output queue).
#pragma once

#include <array>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>

#include "common.h"
#include "dpb.h"
#include "mbparse.h"
#include "nal.h"
#include "params.h"
#include "poc.h"
#include "sliceheader.h"

namespace h264tpu {

// Return codes of Decoder::decode (reference h264bsd_decoder.h:46-55 values).
enum DecodeRet : u32 {
  kRdy = 0,
  kPicRdy = 1,
  kHdrsRdy = 2,
  kDecodeError = 3,
  kParamSetError = 4,
  kMemAllocError = 5,
};

// What the device side must do when a picture completes.
struct PicReadyInfo {
  i32 slot = -1;            // DPB slot the reconstructed frame occupies
  u32 pic_id = 0;
  u32 is_idr = 0;
  i32 pic_order_cnt = 0;
  u32 frame_num = 0;
  u32 num_concealed_mbs = 0;
  u32 slice_type = 0;       // slice type used for concealment dispatch
  bool conceal_from_ref = false;  // P-type concealment (copy from ref list 0)
  i32 conceal_ref_slot = -1;      // slot to copy from (-1 -> grey fill)
};

// One picture's parse state: the MB parser's per-MB state and the dense
// tensors it writes. The serial front-end reuses one for every picture.
// In pool mode each picture in flight has its own, with the inputs of its
// job (the slice data of a held first slice) and what the in-order stage
// fixed when the picture ended.
struct Picture {
  MbParser parser;
  FrameTensors tensors;

  // the held slice: its RBSP, where its slice data starts and what the
  // slice data reads, by value (a later SPS or PPS NAL may replace the
  // stored sets, and the DPB moves on, while the job runs)
  bool held = false;
  std::vector<u8> rbsp;
  u32 data_bit = 0;
  SliceHeader sh;
  Sps sps;
  Pps pps;
  RefSlots refs;
  std::vector<u32> slice_group_map;
  u32 slice_id = 0;

  // fixed in order when the picture ended
  bool pooled = false;     // its slice data ran on the pool
  u32 seq = 0;             // picture number: names it in the DPB
  u32 epoch = 0;           // activations before it (Decoder::stale_)
  u32 pic_size = 0;
  PicReadyInfo info;       // the concealment fields once taken
  i32 first_ref = -1;      // first available reference slot
  std::vector<i32> non_existing;
  std::vector<DpbOutPicture> outputs;
  std::array<u32, 16> stream_info{};

  // the job's result
  u32 num_decoded = 0;     // MBs of the held slice
  u32 num_concealed = 0;
  bool done = false;       // guarded by Decoder::pool_mu_
};

struct AubState {
  // reference aubCheck_t (h264bsd_storage.h:57-66)
  NalUnit nu_prev;
  u32 prev_frame_num = 0;
  u32 prev_idr_pic_id = 0;
  u32 prev_pic_order_cnt_lsb = 0;
  i32 prev_delta_pic_order_cnt_bottom = 0;
  i32 prev_delta_pic_order_cnt[2] = {0, 0};
  bool first_call = true;
};

class Decoder {
 public:
  // slot_margin: requested spare device-ring slots for windowed
  // dispatch (see Dpb::init; clamped so every slot id stays < 32 for
  // the u32 used_slot_mask).
  explicit Decoder(bool no_output_reordering = false,
                   bool intra_concealment = false, u32 slot_margin = 0);
  ~Decoder();

  // Decode one NAL unit (reference h264bsdDecode decoder.c:152-515).
  u32 decode(const u8* data, u32 len, u32 pic_id, u32* read_bytes);

  // Valid after decode() returns kPicRdy (serial mode).
  const PicReadyInfo& pic_info() const { return pic_info_; }
  FrameTensors& tensors() { return cur_->tensors; }

  // ---- pool mode ----
  // Pictures are parsed in parallel and handed on in decode order. A
  // picture's first slice, when it starts at MB 0 with one slice group
  // and redundant_pic_cnt 0, is held: its slice data becomes a job for
  // the pool's workers once the next NAL that can end the picture (an
  // access-unit boundary) has ended it, whatever the job finds, and
  // decode() goes on with the next picture meanwhile. A NAL after which
  // the held slice's outcome matters (another slice of its access unit)
  // parses it on the calling thread and the picture goes on serially.
  // decode() then returns kPicRdy when a picture ended (and was queued),
  // with this NAL to be decoded again, as the serial front-end does when
  // a boundary ends a picture; every picture is read from its Picture
  // (take_picture), in decode order, identical to the serial front-end's.
  // The in-order calls (decode, take_picture, release_picture,
  // finish_stream) come from one thread; the workers call next_job and
  // run_job. Start before the first NAL.
  void start_pool() {
    pooled_ = true;
    cur_->parser.stale_exact = false;
  }
  // Worker side: the next job (nullptr once stop_pool was called), and
  // running it: the held slice's data if any, the concealment, then, in
  // picture order after the previous picture's job, the picture's stale
  // MB state fixed and handed on (stale_) and its packed records built.
  Picture* next_job();
  void run_job(Picture* p);
  void stop_pool();
  // [ended pictures not yet taken, whether the oldest one's job is done,
  //  output pictures queued so far (decode_stream's pic_id)]
  void poll(u32* out3);
  // The oldest ended picture, once its job is done, with its concealment
  // fields and the DPB's copies of its error count filled in; nullptr
  // when none ended. Hand it back with release_picture once read.
  Picture* take_picture();
  void release_picture(Picture* p);
  // At the stream's end (no NAL follows): a held slice is parsed (on the
  // pool, waited for), and its picture ends if the slice completed it
  // (the serial front-end reported the picture with the slice).
  void finish_stream();
  // [width_mbs, height_mbs, dpb_slots, crop_flag, crop_left, crop_w,
  //  crop_top, crop_h, sar_w, sar_h, profile, full_range, num_slots,
  //  matrix_coefficients, slot_margin, 0]
  void stream_info(u32* out16) const;

  // Display-order output drain (reference h264bsdNextOutputPicture
  // decoder.c:599). Returns nullptr when the queue is empty.
  const DpbOutPicture* next_output() { return dpb_.next_output(); }

  // Stream geometry (valid after kHdrsRdy).
  const Sps* active_sps() const { return active_sps_; }
  const Pps* active_pps() const { return active_pps_; }
  u32 pic_width_mbs() const { return active_sps_ ? active_sps_->pic_width_in_mbs : 0; }
  u32 pic_height_mbs() const { return active_sps_ ? active_sps_->pic_height_in_mbs : 0; }
  u32 dpb_n_slots() const { return dpb_.n_slots(); }
  u32 slot_margin() const { return dpb_.slot_margin(); }
  const Dpb& dpb() const { return dpb_; }

  // Non-existing frames synthesized since the last call (device zero-fills
  // these slots; the reference leaves them as uninitialized malloc memory).
  std::vector<i32> take_new_non_existing() {
    return std::move(non_existing_);
  }

  // Exposed for the h264bsdCroppingParams/SampleAspectRatio-equivalent API.
  bool cropping_params(u32* left, u32* width, u32* top, u32* height) const;
  void sample_aspect_ratio(u32* sar_w, u32* sar_h) const;
  u32 profile() const { return active_sps_ ? active_sps_->profile_idc : 0; }
  bool video_full_range() const;
  // reference h264bsdMatrixCoefficients decoder.c:928 (2 = unspecified)
  u32 matrix_coefficients() const;
  // reference h264bsdFlushBuffer decoder.c:834: drain the whole DPB into
  // the display-order output queue
  void flush_buffer() { dpb_.flush(); }

  // Peek an IDR slice NAL (Annex-B chunk or bare NAL) without decoding:
  // 1 = begins a new primary picture (first_mb_in_slice == 0 AND
  // redundant_pic_cnt == 0), 0 = does not (mid-picture slice or redundant
  // coded picture, reference CheckRedundantPicCnt slice_header.c:1239),
  // -1 = undecidable (not an IDR slice, unknown PPS/SPS, parse error).
  // Requires the referenced PPS/SPS to have been fed to decode() first.
  int peek_idr_boundary(const u8* data, u32 len);

  // Oldest captured SEI RBSP payload (EPB-stripped, NAL header removed),
  // or nullptr when none is pending; the pointer stays valid until the
  // next take_sei()/decode() call. The reference ships a full SEI parser
  // as dead code (h264bsd_sei.c; decoder.c:464-466 skips the NAL) — the
  // rebuild queues the payload here and decodes the messages host-side
  // (frontend/sei.py).
  const std::vector<u8>* take_sei() {
    if (sei_queue_.empty()) return nullptr;
    sei_out_ = std::move(sei_queue_.front());
    sei_queue_.erase(sei_queue_.begin());
    return &sei_out_;
  }

  // SPS registry lookup (buffering-period SEI names its SPS by id,
  // reference h264bsd_sei.c:396-473).
  const Sps* sps_by_id(u32 id) const {
    return id < sps_.size() ? sps_[id].get() : nullptr;
  }

  // True when at least one stored PPS references a stored SPS and
  // conforms to its geometry (reference h264bsdCheckValidParamSets
  // decoder.h:82 -> h264bsdValidParamSets storage.c:863-885).
  bool valid_param_sets() const {
    for (const auto& pps : pps_) {
      if (!pps) continue;
      const Sps* sps = sps_by_id(pps->sps_id);
      if (sps && ok(check_pps_vs_sps(*pps, *sps))) return true;
    }
    return false;
  }

 private:
  u32 decode_inner(const u8* data, u32 len, u32 pic_id, u32* read_bytes);
  Status check_access_unit_boundary(const BitReader& br, const NalUnit& nal,
                                    bool* boundary);
  u32 activate_param_sets(u32 pps_id, bool is_idr);
  Status store_sps(Sps&& sps);
  Status store_pps(Pps&& pps);
  Status check_pps_vs_sps(const Pps& pps, const Sps& sps) const;
  // epilogue (decoder.c:473-511) of the picture just ended
  u32 end_picture(u32 conceal_slice_type);
  void conceal_fields(PicReadyInfo* info, u32 concealed, u32 pic_size,
                      i32 first_ref) const;
  // pool mode
  void submit_job(Picture* p);
  void hold_slice(const BitReader& br);
  bool parse_held_slice();
  Picture* acquire_picture();
  void wait_done(Picture* p);
  // Before the in-order thread parses into cur_: every ended picture's
  // job done, and cur_'s parser given the serial stale MB state.
  void make_exact();
  void reset_stale(u32 epoch, u32 width_mbs, u32 height_mbs);

  bool no_reordering_ = false;
  // reference intraConcealmentFlag (h264bsd_storage.h:148-149, read at
  // conceal.c:146-186): only changes the whole-picture-lost I case — copy
  // the reference picture instead of grey. P concealment is unaffected.
  bool intra_concealment_ = false;
  u32 slot_margin_req_ = 0;   // see constructor

  // parameter set registries (reference storage_t.sps/pps)
  std::array<std::unique_ptr<Sps>, kMaxNumSps> sps_;
  std::array<std::unique_ptr<Pps>, kMaxNumPps> pps_;
  u32 active_pps_id_ = kMaxNumPps;
  u32 active_sps_id_ = kMaxNumSps;
  u32 old_sps_id_ = kMaxNumSps;
  const Sps* active_sps_ = nullptr;
  const Pps* active_pps_ = nullptr;
  bool pending_activation_ = false;

  // per-access-unit state
  AubState aub_;
  SliceHeader slice_header_[2];  // [0] stored, [1] scratch (reference style)
  NalUnit prev_nal_;
  bool pic_started_ = false;
  bool valid_slice_in_access_unit_ = false;
  bool skip_redundant_slices_ = false;
  u32 current_pic_id_ = 0;
  u32 num_concealed_mbs_ = 0;
  u32 slice_id_counter_ = 0;   // reference slice_t.sliceId
  u32 num_decoded_mbs_ = 0;    // reference slice_t.numDecodedMbs
  u32 pic_size_in_mbs_ = 0;
  i32 curr_slot_ = -1;

  // per-NAL resume contract (reference storage_t.prevBufNotFinished etc.)
  bool prev_buf_not_finished_ = false;
  const u8* prev_buf_pointer_ = nullptr;
  u32 prev_bytes_consumed_ = 0;
  std::vector<u8> saved_rbsp_;

  // captured SEI payloads awaiting host-side message decode; bounded so an
  // app that never drains them cannot grow memory without limit
  std::vector<std::vector<u8>> sei_queue_;
  std::vector<u8> sei_out_;

  NalExtractor extractor_;
  Dpb dpb_;
  PocStorage poc_;
  std::vector<u32> slice_group_map_;
  PicReadyInfo pic_info_;
  std::vector<i32> non_existing_;

  // every Picture made; cur_ is the one being parsed
  std::vector<std::unique_ptr<Picture>> pictures_;
  Picture* cur_ = nullptr;

  // pool mode
  bool pooled_ = false;
  std::deque<Picture*> ended_;   // in decode order, not yet taken
  std::vector<Picture*> free_;
  // the per-MB fields one FrameTensors reused by every picture would
  // hold after picture stale_seq_ (run_job moves them on in picture
  // order); reset with each activation, as the serial front-end's are
  FrameTensors stale_;
  std::vector<StaleMb> stale_mbs_;   // the serial parser's, likewise
  u32 stale_epoch_ = 0;
  u32 epoch_ = 0;
  u32 seq_ = 0;
  u32 outputs_queued_ = 0;
  std::mutex pool_mu_;
  std::condition_variable job_cv_, done_cv_, chain_cv_;
  std::deque<Picture*> jobs_;
  u32 stale_seq_ = 0;   // the last picture whose job moved stale_ on
  bool pool_stopped_ = false;
};

}  // namespace h264tpu
