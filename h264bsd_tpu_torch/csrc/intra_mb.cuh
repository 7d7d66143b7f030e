// Intra reconstruction of one macroblock by one thread block: the device
// code shared by the list kernel (intra_list.cu) and the wavefront kernel
// (intra_wf.cu).
//
// Semantics are those of h264bsd_tpu_torch/ops/intra.py (and of the JAX
// package's ops/intra.py it mirrors): Intra_4x4 blocks, each predicted
// from already reconstructed pels, or Intra_16x16; then both chroma
// planes; prediction + residual clipped to [0, 255].
//
// The MB works in shared memory on its read rectangle (IntraRect): luma
// rows y-1..y+15 and columns x-1..x+19, chroma rows cy-1..cy+7 and
// columns cx-1..cx+7, indexed from (y-1, x-1). Every neighbour read
// clamps its address into the picture, exactly as the plain version
// does (a clamped read lands on a pel of the MB itself or of the
// rectangle; the clamped pels feed only unavailable-neighbour paths),
// so rows or columns outside the picture are never read. A caller fills
// the rectangle (intra_mb_copy_rect, or intra_wf.cu's sliding window),
// intra_mb_compute reconstructs the MB there in place and
// intra_mb_store writes it back; nothing outside the MB is written.
// Arithmetic is int32; the planes are uint8.
//
// The block has INTRA_THREADS = 256 threads. Warp 0 runs the Intra_4x4
// chain while threads 128..255 compute the chroma pels; an Intra_16x16
// MB takes one thread per luma pel. A chain step is short: each lane
// loads one neighbour pel of its block and gathers its pel's (at most 3)
// taps by shuffles. The chain walks the 16 blocks on
// the anti-diagonals t = 2*by + bx of the MB's 4x4 block grid: 10 steps
// of at most 2 blocks (lanes 0-15 the upper, 16-31 the lower block),
// each block's left, above-left, above and above-right blocks on earlier
// steps. The plain version walks the blocks in zigzag order, in which
// raster blocks 5 and 13 read their above-right pels (raster blocks 2
// and 10, row 3 / row 11, columns 8-11) before those are reconstructed;
// here those blocks are already done, so the two blocks read the 2 x 4
// pels from a copy taken before the chain starts. Every other read sees
// the same state in both orders. (The front-end clears the above-right
// bit of both blocks, so a conforming stream never reads those pels;
// the copy keeps the kernel byte-equal for any availability bits.)

#pragma once

#include <cstdint>

#define INTRA_THREADS 256

struct IntraArgs {
  uint8_t* y;                   // (16*hm, 16*wm)
  uint8_t* cb;                  // (8*hm, 8*wm)
  uint8_t* cr;
  const int32_t* mb_class;      // (nMB) 3 = I4x4, 4 = I16x16
  const int32_t* i4_modes;      // (nMB, 16) raster block order
  const int32_t* i4_avail;      // (nMB, 16) bits A=1 B=2 C=4 D=8
  const int32_t* mb_avail;      // (nMB)
  const int32_t* i16_mode;      // (nMB)
  const int32_t* chroma_mode;   // (nMB)
  const int32_t* resid_luma;    // (nMB, 16, 16)
  const int32_t* resid_chroma;  // (nMB, 2, 8, 8)
  // (9, 16, 13): per mode, per raster pel 4*y+x, the weights on the 13
  // neighbours n = [D, above*4, above-right*4, left*4]; every directional
  // 4x4 mode is (w . n + 2) >> 2 (I4_WEIGHTS of ops/intra.py; mode 2, DC,
  // is computed separately)
  const int32_t* i4_weights;
  int width_mbs;
  int height_mbs;
};

#define I4_TAP_COUNT (9 * 16)
#define FULL_MASK 0xffffffffu

// the MB's own inputs, staged in shared memory
struct IntraStage {
  int res_l[256];               // (16, 16)
  int res_c[2][64];             // (2, 8, 8)
  int modes[16];                // clamped into 0..8
  int avail[16];
  int cls, mb_avail, i16_mode, chroma_mode;
};

// the read rectangles, from (y-1, x-1) and (cy-1, cx-1)
struct IntraRect {
  int ly[17][21];
  int lc[2][9][9];
};

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// DC selection shared by the 4x4 and 16x16 modes: both neighbours, left
// only (A), above only (B), or neither.
__device__ __forceinline__ int dc_select(int avail, int both, int only_a,
                                         int only_b) {
  const bool a = avail & 1, b = avail & 2;
  return (a && b) ? both : (a ? only_a : (b ? only_b : 128));
}

// The weight table into shared memory as taps, by all INTRA_THREADS
// threads: per mode and pel, the (at most 3) non-zero weights of its row,
// 7 bits each, neighbour index | weight << 4 (a directional pel is
// (x + 2y + z + 2) >> 2, (2x + 2y + 2) >> 2, (x + 3y + 2) >> 2 or a copy;
// DC's rows are 0). The same sum as the row's dot product.
__device__ __forceinline__ void intra_stage_taps(const IntraArgs& a,
                                                 int* taps) {
  for (int i = threadIdx.x; i < I4_TAP_COUNT; i += INTRA_THREADS) {
    int packed = 0, k = 0;
    for (int j = 0; j < 13; ++j) {
      const int w = a.i4_weights[i * 13 + j];
      if (w) packed |= (j | w << 4) << (7 * k++);
    }
    taps[i] = packed;
  }
}

// MB `mb`'s own inputs into shared memory. Reads no pel. Called by all
// INTRA_THREADS threads; a barrier must follow before they are read.
__device__ __forceinline__ void intra_stage_inputs(const IntraArgs& a, int mb,
                                                   IntraStage& s) {
  const int t = threadIdx.x;
  s.res_l[t] = a.resid_luma[mb * 256 + t];
  if (t < 128) s.res_c[t >> 6][t & 63] = a.resid_chroma[mb * 128 + t];
  if (t < 16) {
    s.modes[t] = clampi(a.i4_modes[mb * 16 + t], 0, 8);
    s.avail[t] = a.i4_avail[mb * 16 + t];
  }
  if (t == 0) {
    s.cls = a.mb_class[mb];
    s.mb_avail = a.mb_avail[mb];
    s.i16_mode = a.i16_mode[mb];
    s.chroma_mode = a.chroma_mode[mb];
  }
}

// Copy MB `mb`'s whole read rectangle (the pels inside the picture) from
// the planes into shared memory with L2-only loads; every load is made
// before any store, so the copy costs one L2 round trip. Called by all
// INTRA_THREADS threads; a barrier must follow.
__device__ __forceinline__ void intra_mb_copy_rect(const IntraArgs& a, int mb,
                                                   IntraRect& s) {
  const int t = threadIdx.x;
  const int W = a.width_mbs * 16, Wc = W / 2;
  const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
  const int cx = mx / 2, cy = my / 2;
  const int r0 = my > 0 ? my - 1 : 0, c0 = mx > 0 ? mx - 1 : 0;
  const int c1 = min(mx + 19, W - 1);
  const int nr = my + 16 - r0, nc = c1 - c0 + 1;
  const int cr0 = cy > 0 ? cy - 1 : 0, cc0 = cx > 0 ? cx - 1 : 0;
  const int cnr = cy + 8 - cr0, cnc = cx + 8 - cc0;
  int v[3];
#pragma unroll
  for (int j = 0; j < 2; ++j) {         // 17 x 21 <= 2 x 256
    const int i = t + j * INTRA_THREADS;
    v[j] = i < nr * nc ? __ldcg(&a.y[(r0 + i / nc) * W + c0 + i % nc]) : 0;
  }
  const int jc = t % (cnr * cnc);       // 2 x 9 x 9 <= 256
  const uint8_t* plane = t < cnr * cnc ? a.cb : a.cr;
  v[2] = t < 2 * cnr * cnc
             ? __ldcg(&plane[(cr0 + jc / cnc) * Wc + cc0 + jc % cnc]) : 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + j * INTRA_THREADS;
    if (i < nr * nc) {
      s.ly[r0 + i / nc - (my - 1)][c0 + i % nc - (mx - 1)] = v[j];
    }
  }
  if (t < 2 * cnr * cnc) {
    s.lc[t / (cnr * cnc)][cr0 + jc / cnc - (cy - 1)]
        [cc0 + jc % cnc - (cx - 1)] = v[2];
  }
}

// Reconstruct MB `mb` in its rectangle `s`, from its staged inputs `st`
// and the staged taps `taps`. Called by all INTRA_THREADS threads with
// the rectangle and the stage published by a barrier; ends with the MB's
// pels in the rectangle, published by a barrier.
__device__ void intra_mb_compute(const IntraArgs& a, int mb,
                                 const IntraStage& st, IntraRect& s,
                                 const int* taps) {
  const int t = threadIdx.x;
  const int W = a.width_mbs * 16, H = a.height_mbs * 16;
  const int Wc = W / 2, Hc = H / 2;
  const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
  const int cx = mx / 2, cy = my / 2;

  // picture-coordinate access into the rectangle, addresses clamped
  auto Y = [&](int r, int c) -> int& {
    return s.ly[clampi(r, 0, H - 1) - (my - 1)]
               [clampi(c, 0, W - 1) - (mx - 1)];
  };
  const int mb_avail = st.mb_avail;
  const bool i4 = st.cls == 3;

  // ---- luma
  int lval = 0;
  if (i4) {
    // Intra_4x4 on warp 0: step k runs the blocks with 2*by + bx = k,
    // the upper one on lanes 0-15, the lower one on lanes 16-31. Lane j
    // of a half loads neighbour j of its block (j < 13); every lane then
    // gathers its pel's (at most 3) taps and the DC sums by shuffles.
    // Whatever a step needs that is not a pel is read before the chain,
    // so a step is one shared-memory load, the shuffles, a little
    // arithmetic and one store.
    if (t < 32) {
      const int slot = t >> 4, q = t & 15, px = q & 3, py = q >> 2;
      const int half = t & 16;
      int* ly = &s.ly[0][0];
      auto at = [&](int r, int c) {   // rectangle offset, clamped
        return (clampi(r, 0, H - 1) - (my - 1)) * 21 + clampi(c, 0, W - 1) -
               (mx - 1);
      };
      // blocks 5 and 13 (both lower blocks of their steps) read their
      // above-right pels (neighbours 5-8) as the zigzag order finds
      // them: not yet reconstructed
      int pre5 = 0, pre13 = 0;
      if (slot == 1 && q >= 5 && q <= 8) {
        pre5 = ly[at(my + 3, mx + 3 + q)];
        pre13 = ly[at(my + 11, mx + 3 + q)];
      }
      // per step: the offset of the lane's neighbour (-1 none, -2 the
      // copy), its pel's taps | DC flag << 21 | A and B bits << 22, the
      // offset of its pel (-1 none) and its residual
      int src[10], tap[10], dst[10], res[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const int bry = max(0, (k - 2) >> 1) + slot;
        const int brx = k - 2 * bry;
        const bool on = brx >= 0 && bry < 4;
        const int rb = on ? bry * 4 + brx : 0;
        const int bx = mx + brx * 4, by = my + bry * 4;
        const int mode = st.modes[rb];
        const int av = st.avail[rb];
        tap[k] = taps[mode * 16 + q] | (mode == 2) << 21 | (av & 3) << 22;
        // neighbour q of the block: [D, above*4, above-right*4, left*4];
        // above-right missing: above[3] replicated
        src[k] = -1;
        if (on && q < 13) {
          if (q >= 5 && q <= 8 && (av & 4) && (rb == 5 || rb == 13)) {
            src[k] = -2;
          } else if (q < 9) {
            src[k] = at(by - 1, bx - 1 + ((q >= 5 && !(av & 4)) ? 4 : q));
          } else {
            src[k] = at(by + q - 9, bx - 1);
          }
        }
        dst[k] = on ? at(by + py, bx + px) : -1;
        res[k] = on ? st.res_l[(by - my + py) * 16 + bx - mx + px] : 0;
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const int nb = src[k] >= 0 ? ly[src[k]]
                                   : (src[k] == -2 ? (k == 3 ? pre5 : pre13)
                                                   : 0);
        const int tp = tap[k];
        const int v0 = __shfl_sync(FULL_MASK, nb, half + (tp & 15));
        const int v1 = __shfl_sync(FULL_MASK, nb, half + ((tp >> 7) & 15));
        const int v2 = __shfl_sync(FULL_MASK, nb, half + ((tp >> 14) & 15));
        int sa = 0, sl = 0;
#pragma unroll
        for (int j = 1; j <= 4; ++j) {
          sa += __shfl_sync(FULL_MASK, nb, half + j);
          sl += __shfl_sync(FULL_MASK, nb, half + 8 + j);
        }
        // every lane's reads of this step are done (the shuffles
        // consumed them), so the block may now write its own pels
        const int pred =
            (tp >> 21) & 1
                ? dc_select(tp >> 22, (sa + sl + 4) >> 3, (sl + 2) >> 2,
                            (sa + 2) >> 2)
                : (((tp >> 4) & 7) * v0 + ((tp >> 11) & 7) * v1 +
                   ((tp >> 18) & 7) * v2 + 2) >> 2;
        if (dst[k] >= 0) ly[dst[k]] = clip255(pred + res[k]);
        __syncwarp();
      }
    }
  } else {
    // Intra_16x16, one thread per pel
    const int px = t & 15, py = t >> 4;
    const int mode = st.i16_mode;
    const int corner = Y(my - 1, mx - 1);
    int pred;
    if (mode == 0) {
      pred = Y(my - 1, mx + px);
    } else if (mode == 1) {
      pred = Y(my + py, mx - 1);
    } else if (mode == 2) {
      int sa = 0, sl = 0;
      for (int j = 0; j < 16; ++j) {
        sa += Y(my - 1, mx + j);
        sl += Y(my + j, mx - 1);
      }
      pred = dc_select(mb_avail, (sa + sl + 16) >> 5, (sl + 8) >> 4,
                       (sa + 8) >> 4);
    } else {
      // plane: the i = 7 terms of both gradients read the corner
      const int av = 16 * (Y(my - 1, mx + 15) + Y(my + 15, mx - 1));
      int b = 0, c = 0;
      for (int i = 0; i < 8; ++i) {
        const int ap = i < 7 ? Y(my - 1, mx + 6 - i) : corner;
        const int lp = i < 7 ? Y(my + 6 - i, mx - 1) : corner;
        b += (i + 1) * (Y(my - 1, mx + 8 + i) - ap);
        c += (i + 1) * (Y(my + 8 + i, mx - 1) - lp);
      }
      b = (5 * b + 32) >> 6;
      c = (5 * c + 32) >> 6;
      pred = clip255((av + b * (px - 7) + c * (py - 7) + 16) >> 5);
    }
    lval = clip255(pred + st.res_l[py * 16 + px]);
  }

  // ---- chroma: threads 128..191 Cb, 192..255 Cr, one pel each; on an
  // Intra_4x4 MB they run beside warp 0's block steps (disjoint planes)
  const int cp = (t >> 6) & 1, cpx = t & 7, cpy = (t >> 3) & 7;
  int cval = 0;
  if (t >= 128) {
    const int mode = st.chroma_mode;
    auto C = [&](int r, int c) -> int {
      return s.lc[cp][clampi(r, 0, Hc - 1) - (cy - 1)]
                  [clampi(c, 0, Wc - 1) - (cx - 1)];
    };
    const int corner = C(cy - 1, cx - 1);
    int pred;
    if (mode == 0) {
      // quadrant DC with the reference's availability preferences: the
      // top quadrants prefer the above sums, the bottom ones the left
      // sums; the diagonal quadrants average both when present
      const bool av_a = mb_avail & 1, av_b = mb_avail & 2;
      const int qx = cpx >> 2, qy = cpy >> 2;
      int sa = 0, sl = 0;
      for (int j = 0; j < 4; ++j) {
        sa += C(cy - 1, cx + 4 * qx + j);
        sl += C(cy + 4 * qy + j, cx - 1);
      }
      const int ha = (sa + 2) >> 2, hl = (sl + 2) >> 2;
      if (qx == qy && av_a && av_b) {
        pred = (sa + sl + 4) >> 3;
      } else if (qy == 0) {
        pred = av_b ? ha : (av_a ? hl : 128);
      } else {
        pred = av_a ? hl : (av_b ? ha : 128);
      }
    } else if (mode == 1) {
      pred = C(cy + cpy, cx - 1);
    } else if (mode == 2) {
      pred = C(cy - 1, cx + cpx);
    } else {
      const int av = 16 * (C(cy - 1, cx + 7) + C(cy + 7, cx - 1));
      int b = 0, c = 0;
      for (int i = 0; i < 4; ++i) {
        const int ap = i < 3 ? C(cy - 1, cx + 2 - i) : corner;
        const int lp = i < 3 ? C(cy + 2 - i, cx - 1) : corner;
        b += (i + 1) * (C(cy - 1, cx + 4 + i) - ap);
        c += (i + 1) * (C(cy + 4 + i, cx - 1) - lp);
      }
      b = (17 * b + 16) >> 5;
      c = (17 * c + 16) >> 5;
      pred = clip255((av + 16 + b * (cpx - 3) + c * (cpy - 3)) >> 5);
    }
    cval = clip255(pred + st.res_c[cp][cpy * 8 + cpx]);
  }
  __syncthreads();                // every read of a clamped own pel is done
  if (!i4) s.ly[1 + (t >> 4)][1 + (t & 15)] = lval;
  if (t >= 128) s.lc[cp][1 + cpy][1 + cpx] = cval;
  __syncthreads();
}

// Write MB `mb` from its rectangle back to the planes (L2, as the
// neighbours read it), four pels per store. Called by all INTRA_THREADS
// threads after intra_mb_compute.
__device__ __forceinline__ void intra_mb_store(const IntraArgs& a, int mb,
                                               const IntraRect& s) {
  const int t = threadIdx.x;
  const int W = a.width_mbs * 16, Wc = W / 2;
  const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
  auto pack = [](const int* p) -> uint32_t {
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
           uint32_t(p[3]) << 24;
  };
  if (t < 64) {                   // luma: 16 rows x 4 words
    const int r = t >> 2, q = t & 3;
    __stcg(reinterpret_cast<uint32_t*>(&a.y[(my + r) * W + mx + 4 * q]),
           pack(&s.ly[1 + r][1 + 4 * q]));
  } else if (t < 96) {            // chroma: 2 planes x 8 rows x 2 words
    const int j = t - 64, p = j >> 4, r = (j >> 1) & 7, q = j & 1;
    uint8_t* plane = p ? a.cr : a.cb;
    __stcg(reinterpret_cast<uint32_t*>(
               &plane[(my / 2 + r) * Wc + mx / 2 + 4 * q]),
           pack(&s.lc[p][1 + r][1 + 4 * q]));
  }
}
