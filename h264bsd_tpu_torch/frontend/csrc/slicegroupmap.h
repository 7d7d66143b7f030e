// FMO slice-group maps (7 map types) and macroblock iteration order.
// Parity: reference h264bsd_slice_group_map.c, h264bsd_util.c:220-246.
#pragma once

#include "common.h"
#include "params.h"

namespace h264tpu {

// map must hold w*h entries.
void decode_slice_group_map(u32* map, const Pps& pps,
                            u32 slice_group_change_cycle, u32 w, u32 h);

// Next MB address in the same slice group (0 when none remain).
u32 next_mb_address(const u32* map, u32 pic_size_in_mbs, u32 curr_mb_addr);

}  // namespace h264tpu
