#include "poc.h"

namespace h264tpu {

i32 decode_pic_order_cnt(PocStorage* poc, const Sps& sps,
                         const SliceHeader& sh, const NalUnit& nal) {
  // reference h264bsdDecodePicOrderCnt pic_order_cnt.c:80-348.
  const bool idr = nal.type == kNalCodedSliceIdr;

  bool contains_mmco5 = false;
  if (sh.marking.adaptive_mode) {
    for (const MmcOperation& op : sh.marking.operations) {
      if (op.op == 0) break;
      if (op.op == 5) {
        contains_mmco5 = true;
        break;
      }
    }
  }

  i32 pic_order_cnt = 0;
  switch (sps.poc_type) {
    case 0: {
      if (idr) {
        poc->prev_pic_order_cnt_msb = 0;
        poc->prev_pic_order_cnt_lsb = 0;
      }
      if (sh.pic_order_cnt_lsb < poc->prev_pic_order_cnt_lsb &&
          poc->prev_pic_order_cnt_lsb - sh.pic_order_cnt_lsb >=
              sps.max_pic_order_cnt_lsb / 2) {
        pic_order_cnt =
            poc->prev_pic_order_cnt_msb + i32(sps.max_pic_order_cnt_lsb);
      } else if (sh.pic_order_cnt_lsb > poc->prev_pic_order_cnt_lsb &&
                 sh.pic_order_cnt_lsb - poc->prev_pic_order_cnt_lsb >
                     sps.max_pic_order_cnt_lsb / 2) {
        pic_order_cnt =
            poc->prev_pic_order_cnt_msb - i32(sps.max_pic_order_cnt_lsb);
      } else {
        pic_order_cnt = poc->prev_pic_order_cnt_msb;
      }

      // prev msb/lsb track the previous *reference* frame only
      if (nal.ref_idc) poc->prev_pic_order_cnt_msb = pic_order_cnt;

      pic_order_cnt += i32(sh.pic_order_cnt_lsb);
      // negative bottom delta -> bottom field is the minimum order count
      if (sh.delta_pic_order_cnt_bottom < 0) {
        pic_order_cnt += sh.delta_pic_order_cnt_bottom;
      }

      if (nal.ref_idc) {
        if (contains_mmco5) {
          poc->prev_pic_order_cnt_msb = 0;
          poc->prev_pic_order_cnt_lsb =
              sh.delta_pic_order_cnt_bottom < 0
                  ? u32(-sh.delta_pic_order_cnt_bottom)
                  : 0;
          pic_order_cnt = 0;
        } else {
          poc->prev_pic_order_cnt_lsb = sh.pic_order_cnt_lsb;
        }
      }
      break;
    }

    case 1: {
      u32 frame_num_offset;
      if (idr) {
        frame_num_offset = 0;
      } else if (poc->prev_frame_num > sh.frame_num) {
        frame_num_offset = poc->prev_frame_num_offset + sps.max_frame_num;
      } else {
        frame_num_offset = poc->prev_frame_num_offset;
      }

      u32 abs_frame_num = sps.num_ref_frames_in_poc_cycle
                              ? frame_num_offset + sh.frame_num
                              : 0;
      if (nal.ref_idc == 0 && abs_frame_num > 0) abs_frame_num -= 1;

      i32 expected_delta = 0;
      for (u32 i = 0; i < sps.num_ref_frames_in_poc_cycle; ++i) {
        expected_delta += sps.offset_for_ref_frame[i];
      }

      if (abs_frame_num > 0) {
        u32 cycle_cnt = (abs_frame_num - 1) / sps.num_ref_frames_in_poc_cycle;
        u32 fn_in_cycle =
            (abs_frame_num - 1) % sps.num_ref_frames_in_poc_cycle;
        pic_order_cnt = i32(cycle_cnt) * expected_delta;
        for (u32 i = 0; i <= fn_in_cycle; ++i) {
          pic_order_cnt += sps.offset_for_ref_frame[i];
        }
      } else {
        pic_order_cnt = 0;
      }

      if (nal.ref_idc == 0) pic_order_cnt += sps.offset_for_non_ref_pic;
      pic_order_cnt += sh.delta_pic_order_cnt[0];
      if (sps.offset_for_top_to_bottom_field + sh.delta_pic_order_cnt[1] < 0) {
        pic_order_cnt +=
            sps.offset_for_top_to_bottom_field + sh.delta_pic_order_cnt[1];
      }

      if (!contains_mmco5) {
        poc->prev_frame_num_offset = frame_num_offset;
        poc->prev_frame_num = sh.frame_num;
      } else {
        poc->prev_frame_num_offset = 0;
        poc->prev_frame_num = 0;
        pic_order_cnt = 0;
      }
      break;
    }

    default: {  // type 2: display order == decode order
      u32 frame_num_offset;
      if (idr) {
        frame_num_offset = 0;
      } else if (poc->prev_frame_num > sh.frame_num) {
        frame_num_offset = poc->prev_frame_num_offset + sps.max_frame_num;
      } else {
        frame_num_offset = poc->prev_frame_num_offset;
      }

      if (idr) {
        pic_order_cnt = 0;
      } else if (nal.ref_idc == 0) {
        pic_order_cnt = 2 * i32(frame_num_offset + sh.frame_num) - 1;
      } else {
        pic_order_cnt = 2 * i32(frame_num_offset + sh.frame_num);
      }

      if (!contains_mmco5) {
        poc->prev_frame_num_offset = frame_num_offset;
        poc->prev_frame_num = sh.frame_num;
      } else {
        poc->prev_frame_num_offset = 0;
        poc->prev_frame_num = 0;
        pic_order_cnt = 0;
      }
      break;
    }
  }

  return pic_order_cnt;
}

}  // namespace h264tpu
