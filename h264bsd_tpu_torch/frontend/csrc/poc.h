// Picture order count computation for POC types 0/1/2, including MMCO5
// reset handling. Parity: reference h264bsd_pic_order_cnt.c:80-348.
#pragma once

#include "common.h"
#include "params.h"
#include "sliceheader.h"

namespace h264tpu {

struct PocStorage {
  u32 prev_pic_order_cnt_lsb = 0;
  i32 prev_pic_order_cnt_msb = 0;
  u32 prev_frame_num = 0;
  u32 prev_frame_num_offset = 0;
};

i32 decode_pic_order_cnt(PocStorage* poc, const Sps& sps,
                         const SliceHeader& sh, const NalUnit& nal);

}  // namespace h264tpu
