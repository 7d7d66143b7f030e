// CAVLC residual block decoding (spec 9.2 residual_block_cavlc).
//
// Behavioral parity: reference h264bsd_cavlc.c:749-916. Instead of the
// reference's branchy multi-table scheme, decode LUTs are flat direct-index
// tables built once at startup from the canonical ITU prefix-code lists in
// cavlc_tables.h; lookups are a single index each. Decoded levels land in the
// block's zigzag scan positions (inverse scan happens on the TPU side).
#pragma once

#include "bitreader.h"
#include "common.h"

namespace h264tpu {

struct CavlcResult {
  u32 total_coeff = 0;
  u16 coeff_map = 0;  // bit i set = zigzag position i is non-zero
  u32 abs_sum = 0;    // sum of |level| (feeds the O(1) IDCT range screen)
};

// Decode one residual block. nc is the coefficient-count context (-1 for
// chroma DC); max_num_coeff is 4, 15 or 16. coeff_level must point at
// max_num_coeff zero-initialized entries; non-zero levels are scattered to
// their zigzag positions.
Status decode_residual_block(BitReader& br, i32 nc, u32 max_num_coeff,
                             i16* coeff_level, CavlcResult* out);

// Exposed for exhaustive parity tests against the reference logic. Each
// returns the packed info field the reference produces (0 = invalid code):
// coeff_token: [tc:5][t1:6][len:5]; others: [value:4][len:4].
u32 dev_coeff_token(u32 bits16, i32 nc);
u32 dev_total_zeros(u32 bits9, u32 total_coeff, bool chroma_dc);
u32 dev_run_before(u32 bits11, u32 zeros_left);

}  // namespace h264tpu
