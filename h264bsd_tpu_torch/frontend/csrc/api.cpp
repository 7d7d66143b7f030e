// Flat C ABI for the host front-end, consumed from Python via ctypes.
// The h264tpu_dev_* entry points exist only for unit/parity tests of
// internal pieces; the decoder instance API mirrors the reference surface
// (h264bsd_decoder.h:64-93) with pixel work delegated to the JAX side.

#include "bitreader.h"
#include "cavlc.h"
#include "common.h"
#include "decoder.h"
#include "slicegroupmap.h"
#include "dpb.h"
#include "nal.h"
#include "params.h"

using namespace h264tpu;

namespace {

// out16: [slot, pic_id, is_idr, poc, frame_num, n_concealed, slice_type,
//         conceal_from_ref, conceal_ref_slot, mv_min_x, mv_min_y,
//         mv_max_x, mv_max_y, used_slot_count, used_slot_mask, 0]
void fill_pic_info(const PicReadyInfo& p, const FrameTensors& t,
                   i32* out16) {
  out16[0] = p.slot;
  out16[1] = i32(p.pic_id);
  out16[2] = i32(p.is_idr);
  out16[3] = p.pic_order_cnt;
  out16[4] = i32(p.frame_num);
  out16[5] = i32(p.num_concealed_mbs);
  out16[6] = i32(p.slice_type);
  out16[7] = p.conceal_from_ref ? 1 : 0;
  out16[8] = p.conceal_ref_slot;
  // quarter-pel MV extremes of the picture (MC shift-range tiering)
  out16[9] = t.mv_min[0];
  out16[10] = t.mv_min[1];
  out16[11] = t.mv_max[0];
  out16[12] = t.mv_max[1];
  out16[13] = i32(__builtin_popcount(t.used_slot_mask));
  out16[14] = i32(t.used_slot_mask);
  out16[15] = 0;
}

const void* tensor_view(const FrameTensors& t, u32 tensor_id,
                        u64* size_bytes) {
  auto ret = [&](const void* p, u64 n) {
    *size_bytes = n;
    return p;
  };
  switch (tensor_id) {
    case 0: return ret(t.mb_class.data(), t.mb_class.size());
    case 1: return ret(t.qp_y.data(), t.qp_y.size());
    case 2: return ret(t.slice_id.data(), t.slice_id.size() * 4);
    case 3: return ret(t.decoded.data(), t.decoded.size());
    case 4: return ret(t.disable_dblk.data(), t.disable_dblk.size());
    case 5: return ret(t.filter_off_a.data(), t.filter_off_a.size());
    case 6: return ret(t.filter_off_b.data(), t.filter_off_b.size());
    case 7: return ret(t.i16_mode.data(), t.i16_mode.size());
    case 8: return ret(t.chroma_mode.data(), t.chroma_mode.size());
    case 9: return ret(t.i4_modes.data(), t.i4_modes.size());
    case 10: return ret(t.i4_avail.data(), t.i4_avail.size());
    case 11: return ret(t.mb_avail.data(), t.mb_avail.size());
    case 12: return ret(t.mv.data(), t.mv.size() * 2);
    case 13: return ret(t.ref_slot.data(), t.ref_slot.size());
    case 14: return ret(t.nnz.data(), t.nnz.size());
    case 15: return ret(t.nnz_dc.data(), t.nnz_dc.size());
    case 19: return ret(t.ipcm_mb.data(), t.ipcm_mb.size() * 4);
    case 20: return ret(t.ipcm_data.data(), t.ipcm_data.size());
    case 21: return ret(t.chroma_qp_offset.data(), t.chroma_qp_offset.size());
    case 22: return ret(t.sparse_id.data(), t.sparse_id.size() * 4);
    case 23: return ret(t.sparse_level.data(), t.sparse_level.size() * 2);
    case 25: return ret(t.intra_mbs.data(), t.intra_mbs.size() * 4);
    case 26: return ret(t.slice_table.data(), t.slice_table.size());
    case 27: return ret(t.mv_exc_id.data(), t.mv_exc_id.size() * 4);
    case 28: return ret(t.mv_exc_payload.data(), t.mv_exc_payload.size());
    case 29: return ret(t.intra_payload.data(), t.intra_payload.size());
    default: *size_bytes = 0; return static_cast<const void*>(nullptr);
  }
}

void blob_counts(FrameTensors& t, u32* out_counts7) {
  t.ensure_packed();
  out_counts7[0] = u32(t.cls_single.size());
  out_counts7[1] = u32(t.cls_short.size());
  out_counts7[2] = u32(t.cls_full.size());
  out_counts7[3] = t.cls_wide;
  out_counts7[4] = u32(t.mv_exc_id.size());
  out_counts7[5] = u32(t.intra_mbs.size());
  out_counts7[6] = u32(t.slice_table.size() / 4);
}

const void* blob_compact(FrameTensors& t, u32 single_cap, u32 short_cap,
                         u32 full_cap, u32 wide_cap, u32 exc_cap,
                         u32 intra_cap, u32 stab_cap, u32 sid_cap,
                         u32 total_bytes, u64* size_bytes) {
  t.ensure_packed();
  t.build_blob_compact(single_cap, short_cap, full_cap, wide_cap, exc_cap,
                       intra_cap, stab_cap, sid_cap, total_bytes);
  *size_bytes = t.blob.size();
  return t.blob.data();
}

}  // namespace

extern "C" {

// ---- decoder instance API ----

// flags: bit 0 = no_output_reordering (h264bsdInit decoder.c:90-113),
// bit 1 = intraConcealmentFlag (h264bsd_storage.h:148-149),
// bits 8-15 = requested DPB slot margin for windowed device dispatch
// (spare ring slots rotated FIFO; see Dpb::init)
void* h264tpu_create(u32 flags) {
  return new Decoder((flags & 1) != 0, (flags & 2) != 0,
                     (flags >> 8) & 0xFF);
}

void h264tpu_destroy(void* inst) { delete static_cast<Decoder*>(inst); }

u32 h264tpu_decode(void* inst, const u8* data, u32 len, u32 pic_id,
                   u32* read_bytes) {
  return static_cast<Decoder*>(inst)->decode(data, len, pic_id, read_bytes);
}

// out16: see Decoder::stream_info
void h264tpu_stream_info(void* inst, u32* out16) {
  static_cast<Decoder*>(inst)->stream_info(out16);
}

// reference h264bsdFlushBuffer: force every pending picture into the
// display-order output queue (drain with h264tpu_next_output)
void h264tpu_flush_buffer(void* inst) {
  static_cast<Decoder*>(inst)->flush_buffer();
}

// reference h264bsdCheckValidParamSets (decoder.h:82): 1 when at least
// one stored SPS/PPS combination is valid, else 0
u32 h264tpu_valid_param_sets(void* inst) {
  return static_cast<Decoder*>(inst)->valid_param_sets() ? 1u : 0u;
}

// GOP-splitter helper: peek whether an IDR slice NAL begins a new primary
// picture (see Decoder::peek_idr_boundary). 1/0/-1 = yes/no/undecidable.
int h264tpu_peek_idr_boundary(void* inst, const u8* data, u32 len) {
  return static_cast<Decoder*>(inst)->peek_idr_boundary(data, len);
}

void h264tpu_pic_info(void* inst, i32* out16) {
  Decoder* d = static_cast<Decoder*>(inst);
  fill_pic_info(d->pic_info(), d->tensors(), out16);
}

// Zero-copy view of a frame tensor; valid until the next h264tpu_decode call
// that starts a new picture. Returns nullptr for unknown ids.
const void* h264tpu_tensor(void* inst, u32 tensor_id, u64* size_bytes) {
  return tensor_view(static_cast<Decoder*>(inst)->tensors(), tensor_id,
                     size_bytes);
}

// Assemble and return the packed per-MB metadata buffer (tensor id 24).
const void* h264tpu_packed(void* inst, u64* size_bytes) {
  FrameTensors& t = static_cast<Decoder*>(inst)->tensors();
  t.ensure_packed();
  *size_bytes = t.packed.size();
  return t.packed.data();
}

// Count query (caps args are legacy-ignored): out_counts7 = [n_single,
// n_short, n_full, n_wide, n_exc_quads, n_intra, n_slices] — the caller
// picks tier caps from these, then builds via h264tpu_blob_compact.
// Builds + classifies the packed records if the picture's are not yet.
const void* h264tpu_blob(void* inst, u32, u32, u32, u32, u32, u32, u32,
                         u32, u32* out_counts7, u64* size_bytes) {
  blob_counts(static_cast<Decoder*>(inst)->tensors(), out_counts7);
  *size_bytes = 0;
  return nullptr;
}

// Compact variant of h264tpu_blob (build_blob_compact, mbparse.cpp):
// sections at their real counts behind a 64-byte count header, zero-
// padded to total_bytes. Caller computes total_bytes >= the compact size.
const void* h264tpu_blob_compact(void* inst, u32 single_cap, u32 short_cap,
                                 u32 full_cap, u32 wide_cap, u32 exc_cap,
                                 u32 intra_cap, u32 stab_cap, u32 sid_cap,
                                 u32 total_bytes, u64* size_bytes) {
  return blob_compact(static_cast<Decoder*>(inst)->tensors(), single_cap,
                      short_cap, full_cap, wide_cap, exc_cap, intra_cap,
                      stab_cap, sid_cap, total_bytes, size_bytes);
}

// Packed-record builds in this process (one a picture).
u64 h264tpu_packed_builds() { return packed_builds(); }

// ---- pool mode (Decoder::start_pool): pictures parsed in parallel ----

void h264tpu_pool_start(void* inst) {
  static_cast<Decoder*>(inst)->start_pool();
}

// Worker threads: the next job, or nullptr once the pool is stopped;
// then run it.
void* h264tpu_pool_next_job(void* inst) {
  return static_cast<Decoder*>(inst)->next_job();
}

void h264tpu_pool_run_job(void* inst, void* pic) {
  static_cast<Decoder*>(inst)->run_job(static_cast<Picture*>(pic));
}

void h264tpu_pool_stop(void* inst) { static_cast<Decoder*>(inst)->stop_pool(); }

// out3: [ended pictures not yet taken, whether the oldest one's job is
// done, output pictures queued so far]
void h264tpu_pool_poll(void* inst, u32* out3) {
  static_cast<Decoder*>(inst)->poll(out3);
}

// The oldest ended picture (blocks on its job), or nullptr; read it with
// the h264tpu_picture_* calls, then hand it back.
void* h264tpu_pool_take(void* inst) {
  return static_cast<Decoder*>(inst)->take_picture();
}

void h264tpu_pool_release(void* inst, void* pic) {
  static_cast<Decoder*>(inst)->release_picture(static_cast<Picture*>(pic));
}

void h264tpu_pool_finish(void* inst) {
  static_cast<Decoder*>(inst)->finish_stream();
}

// ---- one taken picture: the decoder instance calls of the same names ----

void h264tpu_picture_stream_info(void* pic, u32* out16) {
  const Picture* p = static_cast<Picture*>(pic);
  std::memcpy(out16, p->stream_info.data(), 16 * sizeof(u32));
}

void h264tpu_picture_pic_info(void* pic, i32* out16) {
  Picture* p = static_cast<Picture*>(pic);
  fill_pic_info(p->info, p->tensors, out16);
}

const void* h264tpu_picture_tensor(void* pic, u32 tensor_id,
                                   u64* size_bytes) {
  return tensor_view(static_cast<Picture*>(pic)->tensors, tensor_id,
                     size_bytes);
}

const void* h264tpu_picture_blob(void* pic, u32, u32, u32, u32, u32, u32,
                                 u32, u32, u32* out_counts7,
                                 u64* size_bytes) {
  blob_counts(static_cast<Picture*>(pic)->tensors, out_counts7);
  *size_bytes = 0;
  return nullptr;
}

const void* h264tpu_picture_blob_compact(void* pic, u32 single_cap,
                                         u32 short_cap, u32 full_cap,
                                         u32 wide_cap, u32 exc_cap,
                                         u32 intra_cap, u32 stab_cap,
                                         u32 sid_cap, u32 total_bytes,
                                         u64* size_bytes) {
  return blob_compact(static_cast<Picture*>(pic)->tensors, single_cap,
                      short_cap, full_cap, wide_cap, exc_cap, intra_cap,
                      stab_cap, sid_cap, total_bytes, size_bytes);
}

u32 h264tpu_picture_take_non_existing(void* pic, i32* out, u32 max_count) {
  std::vector<i32>& v = static_cast<Picture*>(pic)->non_existing;
  u32 n = std::min(u32(v.size()), max_count);
  for (u32 i = 0; i < n; ++i) out[i] = v[i];
  v.clear();
  return n;
}

// The output pictures the DPB queued when this picture ended, out4 each:
// [slot, pic_id, is_idr, num_err_mbs], at most max of them; returns how
// many there are.
u32 h264tpu_picture_outputs(void* pic, i32* out, u32 max_count) {
  const Picture* p = static_cast<Picture*>(pic);
  u32 n = std::min(u32(p->outputs.size()), max_count);
  for (u32 i = 0; i < n; ++i) {
    const DpbOutPicture& o = p->outputs[i];
    out[4 * i + 0] = o.slot;
    out[4 * i + 1] = i32(o.pic_id);
    out[4 * i + 2] = i32(o.is_idr);
    out[4 * i + 3] = i32(o.num_err_mbs);
  }
  return u32(p->outputs.size());
}

// 1 when the picture's slice data ran on the pool, 0 when it was parsed
// in order (a fallback).
u32 h264tpu_picture_pooled(void* pic) {
  return static_cast<Picture*>(pic)->pooled ? 1u : 0u;
}

// out4: [slot, pic_id, is_idr, num_err_mbs]; returns 1 when a picture was
// dequeued, 0 when the display queue is empty.
u32 h264tpu_next_output(void* inst, i32* out4) {
  const DpbOutPicture* p = static_cast<Decoder*>(inst)->next_output();
  if (!p) return 0;
  out4[0] = p->slot;
  out4[1] = i32(p->pic_id);
  out4[2] = i32(p->is_idr);
  out4[3] = i32(p->num_err_mbs);
  return 1;
}

// Drain slots of non-existing frames synthesized since the last call.
u32 h264tpu_take_non_existing(void* inst, i32* out, u32 max_count) {
  std::vector<i32> v = static_cast<Decoder*>(inst)->take_new_non_existing();
  u32 n = std::min(u32(v.size()), max_count);
  for (u32 i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

// Oldest captured SEI RBSP payload; nullptr when none pending. The pointer
// stays valid until the next call into the instance.
const void* h264tpu_take_sei(void* inst, u64* size_bytes) {
  const std::vector<u8>* sei = static_cast<Decoder*>(inst)->take_sei();
  if (sei == nullptr) {
    *size_bytes = 0;
    return nullptr;
  }
  *size_bytes = sei->size();
  return sei->data();
}

// HRD/pic-timing fields of SPS `sps_id`, needed to decode buffering-period
// and pic-timing SEI messages (the reference's dead-code SEI parser reads
// them from the named SPS, h264bsd_sei.c:396-677). Returns 0 if that SPS
// was never stored. Removal-delay/offset lengths follow the NAL HRD when
// present, else the VCL HRD, else the spec defaults already in HrdParams.
u32 h264tpu_sps_hrd(void* inst, u32 sps_id, u32* out16) {
  const Sps* sps = static_cast<Decoder*>(inst)->sps_by_id(sps_id);
  if (sps == nullptr) return 0;
  for (u32 i = 0; i < 16; ++i) out16[i] = 0;
  if (!sps->vui_present || !sps->vui.has_value()) return 1;
  const VuiParams& v = *sps->vui;
  const HrdParams* hrd = v.nal_hrd_present   ? &v.nal_hrd
                         : v.vcl_hrd_present ? &v.vcl_hrd
                                             : nullptr;
  out16[0] = 1;  // vui_present
  out16[1] = v.nal_hrd_present ? 1 : 0;
  out16[2] = v.vcl_hrd_present ? 1 : 0;
  out16[3] = v.nal_hrd_present ? v.nal_hrd.cpb_cnt : 0;
  out16[4] = v.vcl_hrd_present ? v.vcl_hrd.cpb_cnt : 0;
  out16[5] = v.nal_hrd_present ? v.nal_hrd.initial_cpb_removal_delay_length : 0;
  out16[6] = v.vcl_hrd_present ? v.vcl_hrd.initial_cpb_removal_delay_length : 0;
  out16[7] = hrd ? hrd->cpb_removal_delay_length : 24;
  out16[8] = hrd ? hrd->dpb_output_delay_length : 24;
  out16[9] = hrd ? hrd->time_offset_length : 24;
  out16[10] = v.pic_struct_present ? 1 : 0;
  out16[11] = v.timing_info_present ? 1 : 0;
  out16[12] = v.num_units_in_tick;
  out16[13] = v.time_scale;
  out16[14] = v.low_delay_hrd ? 1 : 0;
  return 1;
}

// ---- dev/test surface ----

u32 h264tpu_dev_coeff_token(u32 bits16, i32 nc) {
  return dev_coeff_token(bits16, nc);
}
u32 h264tpu_dev_total_zeros(u32 bits9, u32 total_coeff, i32 chroma_dc) {
  return dev_total_zeros(bits9, total_coeff, chroma_dc != 0);
}
u32 h264tpu_dev_run_before(u32 bits11, u32 zeros_left) {
  return dev_run_before(bits11, zeros_left);
}

// Decode one residual block from raw RBSP bytes (test only).
// Returns packed (coeff_map << 16) | (total_coeff << 4) | status.
u32 h264tpu_dev_residual_block(const u8* data, u32 len, i32 nc,
                               u32 max_num_coeff, i16* coeff_level) {
  BitReader br(data, len);
  CavlcResult res;
  Status s = decode_residual_block(br, nc, max_num_coeff, coeff_level, &res);
  return (u32(res.coeff_map) << 16) | (res.total_coeff << 4) | u32(s);
}

// Build a slice-group map directly (dev/test surface for the 7 FMO map
// types). params layout: [num_groups, map_type, change_dir, change_rate,
// change_cycle]; aux carries run_length / top_left+bottom_right /
// slice_group_id depending on type.
void h264tpu_dev_slice_group_map(u32 w, u32 h, const u32* params,
                                 const u32* aux, u32 aux_len, u32* out_map) {
  Pps pps;
  pps.num_slice_groups = params[0];
  pps.slice_group_map_type = params[1];
  pps.slice_group_change_direction = params[2] != 0;
  pps.slice_group_change_rate = params[3];
  switch (pps.slice_group_map_type) {
    case 0:
      pps.run_length.assign(aux, aux + pps.num_slice_groups);
      break;
    case 2:
      for (u32 i = 0; i + 1 < pps.num_slice_groups; ++i) {
        pps.top_left.push_back(aux[2 * i]);
        pps.bottom_right.push_back(aux[2 * i + 1]);
      }
      break;
    case 6:
      pps.slice_group_id.assign(aux, aux + aux_len);
      pps.pic_size_in_map_units = aux_len;
      break;
    default:
      break;
  }
  decode_slice_group_map(out_map, pps, params[4], w, h);
}

// Dev/test surface for the DPB state machine: run a scripted sequence of
// operations and report the resulting reference list / output queue.
// ops stream (u32 tokens):
//   1 frame_num poc is_idr n_mmco [op dif lt_pic lt_frame max_lt]*  -> mark
//   2 curr_frame_num n_cmds [idc val]*                              -> reorder
//   3 frame_num is_ref gaps_allowed                                 -> gaps
//   4                                                               -> flush
// After the script: out[0..16] = ref list slots (-1 empty), out[17] = number
// of queued outputs, out[18..] = output slot ids.
void h264tpu_dev_dpb(u32 dpb_size, u32 max_ref, u32 max_frame_num,
                     u32 no_reorder, const u32* ops, u32 n_ops, i32* out64) {
  Dpb dpb;
  dpb.init(dpb_size, max_ref, max_frame_num, no_reorder != 0);
  const u32* p = ops;
  const u32* end = ops + n_ops;
  while (p < end) {
    u32 tok = *p++;
    if (tok == 1) {
      u32 fn = *p++;
      i32 poc = i32(*p++);
      u32 idr = *p++;
      u32 n = *p++;
      DecRefPicMarking mark;
      if (idr) {
        mark.no_output_of_prior_pics = n & 1;
        mark.long_term_reference = (n >> 1) & 1;
      } else if (n) {
        mark.adaptive_mode = true;
        for (u32 i = 0; i < n; ++i) {
          MmcOperation op;
          op.op = *p++;
          op.difference_of_pic_nums = *p++;
          op.long_term_pic_num = *p++;
          op.long_term_frame_idx = *p++;
          u32 maxlt = *p++;
          op.max_long_term_frame_idx =
              maxlt == 0xFFFFFFFFu ? kNoLongTermFrameIndices : maxlt;
          mark.operations.push_back(op);
        }
        MmcOperation terminator;
        terminator.op = 0;
        mark.operations.push_back(terminator);
      }
      dpb.allocate_image();
      dpb.mark_dec_ref_pic(&mark, fn, poc, idr != 0, 0, 0);
    } else if (tok == 2) {
      u32 fn = *p++;
      u32 n = *p++;
      RefPicListReordering ro;
      ro.flag_l0 = n > 0;
      for (u32 i = 0; i < n; ++i) {
        ReorderCmd cmd;
        cmd.idc = *p++;
        u32 v = *p++;
        if (cmd.idc <= 1) cmd.abs_diff_pic_num = v;
        else cmd.long_term_pic_num = v;
        ro.commands.push_back(cmd);
      }
      ReorderCmd fin; fin.idc = 3; ro.commands.push_back(fin);
      dpb.init_ref_pic_list();
      dpb.reorder_ref_pic_list(ro, fn, max_ref);
    } else if (tok == 3) {
      u32 fn = *p++;
      u32 is_ref = *p++;
      u32 allowed = *p++;
      std::vector<i32> ne;
      dpb.check_gaps_in_frame_num(fn, is_ref != 0, allowed != 0, &ne);
    } else if (tok == 4) {
      dpb.flush();
    } else if (tok == 5) {
      dpb.init_ref_pic_list();
    }
  }
  for (u32 i = 0; i < 17; ++i) out64[i] = dpb.ref_pic_slot(i);
  u32 n_out = 0;
  const DpbOutPicture* o;
  while ((o = dpb.next_output()) != nullptr && n_out < 40) {
    out64[18 + n_out * 2] = o->slot;
    out64[18 + n_out * 2 + 1] = i32(o->pic_id);
    n_out++;
  }
  out64[17] = i32(n_out);
}

// Parse an SPS NAL payload (header byte included); fills a small out array:
// [width_mbs, height_mbs, crop_l, crop_r, crop_t, crop_b, max_dpb, num_ref,
//  max_frame_num, poc_type, level, profile, cropping_flag]
u32 h264tpu_dev_parse_sps(const u8* data, u32 len, u32* out13) {
  NalExtractor ex;
  ExtractedNal nal;
  if (!ok(ex.extract(data, len, &nal))) return 1;
  BitReader br(nal.rbsp, nal.rbsp_size);
  NalUnit nu;
  if (!ok(NalExtractor::decode_nal_header(br, &nu))) return 1;
  if (nu.type != kNalSps) return 2;
  Sps sps;
  if (!ok(decode_sps(br, &sps))) return 3;
  u32 vals[13] = {sps.pic_width_in_mbs, sps.pic_height_in_mbs, sps.crop_left,
                  sps.crop_right,       sps.crop_top,          sps.crop_bottom,
                  sps.max_dpb_size,     sps.num_ref_frames,    sps.max_frame_num,
                  sps.poc_type,         sps.level_idc,         sps.profile_idc,
                  sps.frame_cropping ? 1u : 0u};
  std::memcpy(out13, vals, sizeof(vals));
  return 0;
}



}  // extern "C"
