// Intra reconstruction of one macroblock by one thread block: the device
// code shared by the list kernel (intra_list.cu) and the wavefront kernel
// (intra_wf.cu).
//
// Semantics are those of h264bsd_tpu_torch/ops/intra.py (and of the JAX
// package's ops/intra.py it mirrors): Intra_4x4 blocks in zigzag order,
// each predicted from already reconstructed pels, or Intra_16x16; then
// both chroma planes; prediction + residual clipped to [0, 255].
//
// Two phases. intra_mb_stage reads only the MB's own inputs -- class,
// modes, availability, the 16x16 and 2x8x8 residuals -- and the 9x16x13
// weight table into shared memory; it reads no pel, so a caller may run
// it before the MB's neighbours are done. intra_mb_reconstruct then
// copies the picture rectangle that all of the MB's (clamped) reads fall
// into -- rows max(y-1,0)..y+15, columns max(x-1,0)..min(x+19,W-1), and
// the chroma counterparts -- into shared memory with L2-only loads,
// reconstructs there in place and writes the MB back, so a read that
// clamps onto a pel of the MB itself sees that pel's current value, as in
// the plain version. Every neighbour read clamps its address into the
// picture, exactly as the plain version does; the clamped pels feed only
// unavailable-neighbour paths. Nothing outside the MB is written, so the
// copy is exact as long as no other MB writes the rectangle while this
// one runs (the callers' schedules guarantee it: see intra_wf.cu and
// intra_list.cu). Arithmetic is int32; the planes are uint8.
//
// The block has INTRA_THREADS = 256 threads. Warp 0 runs the 16 zigzag
// Intra_4x4 steps (16 lanes work, the warp meets at __syncwarp between
// steps) while threads 128..255 compute the chroma pels; an Intra_16x16
// MB takes one thread per luma pel.

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

#define I4_WEIGHT_COUNT (9 * 16 * 13)

__constant__ int kZig2Ras[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                 8, 9, 12, 13, 10, 11, 14, 15};

struct IntraSmem {
  int ly[17][21];               // luma rectangle
  int lc[2][9][9];              // cb, cr rectangles
  // staged by intra_mb_stage
  int w[I4_WEIGHT_COUNT];
  int res_l[256];               // (16, 16)
  int res_c[2][64];             // (2, 8, 8)
  int modes[16];                // clamped into 0..8
  int avail[16];
  int cls, mb_avail, i16_mode, chroma_mode;
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

// Phase 1: MB `mb`'s own inputs and the weight table into shared memory.
// Reads no pel. Called by all INTRA_THREADS threads; the first barrier of
// intra_mb_reconstruct publishes what it writes.
__device__ void intra_mb_stage(const IntraArgs& a, int mb, IntraSmem& s) {
  const int t = threadIdx.x;
  for (int i = t; i < I4_WEIGHT_COUNT; i += INTRA_THREADS) {
    s.w[i] = a.i4_weights[i];
  }
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

// Phase 2: reconstruct MB `mb` (staged by intra_mb_stage) in place.
// Called by all INTRA_THREADS threads with the same `mb`; ends with the
// MB's stores issued.
__device__ void intra_mb_reconstruct(const IntraArgs& a, int mb,
                                     IntraSmem& s) {
  const int t = threadIdx.x;
  const int W = a.width_mbs * 16, H = a.height_mbs * 16;
  const int Wc = W / 2, Hc = H / 2;
  const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
  const int cx = mx / 2, cy = my / 2;

  // ---- copy the read rectangles into shared memory: every load is
  // issued before any store, so the copy costs one L2 round trip
  const int r0 = my > 0 ? my - 1 : 0, c0 = mx > 0 ? mx - 1 : 0;
  const int c1 = min(mx + 19, W - 1);
  const int nr = my + 16 - r0, nc = c1 - c0 + 1;
  const int cr0 = cy > 0 ? cy - 1 : 0, cc0 = cx > 0 ? cx - 1 : 0;
  const int cnr = cy + 8 - cr0, cnc = cx + 8 - cc0;
  {
    int v[3];
#pragma unroll
    for (int j = 0; j < 2; ++j) {       // 17 x 21 <= 2 x 256
      const int i = t + j * INTRA_THREADS;
      v[j] = i < nr * nc ? __ldcg(&a.y[(r0 + i / nc) * W + c0 + i % nc]) : 0;
    }
    const int jc = t % (cnr * cnc);     // 2 x 9 x 9 <= 256
    const uint8_t* plane = t < cnr * cnc ? a.cb : a.cr;
    v[2] = t < 2 * cnr * cnc
               ? __ldcg(&plane[(cr0 + jc / cnc) * Wc + cc0 + jc % cnc]) : 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = t + j * INTRA_THREADS;
      if (i < nr * nc) s.ly[i / nc][i % nc] = v[j];
    }
    if (t < 2 * cnr * cnc) s.lc[t / (cnr * cnc)][jc / cnc][jc % cnc] = v[2];
  }
  __syncthreads();

  // picture-coordinate access into the rectangles, addresses clamped
  auto Y = [&](int r, int c) -> int& {
    return s.ly[clampi(r, 0, H - 1) - r0][clampi(c, 0, W - 1) - c0];
  };
  const int mb_avail = s.mb_avail;
  const bool i4 = s.cls == 3;

  // ---- luma
  int lval = 0;
  if (i4) {
    // Intra_4x4: 16 blocks in zigzag order on warp 0, 16 lanes per block
    if (t < 32) {
      const int px = t & 3, py = (t >> 2) & 3;
      for (int z = 0; z < 16; ++z) {
        const int rb = kZig2Ras[z];
        const int bx = mx + (rb & 3) * 4, by = my + (rb >> 2) * 4;
        int val = 0;
        if (t < 16) {
          const int mode = s.modes[rb];
          const int av = s.avail[rb];
          int n[13];
          for (int j = 0; j < 9; ++j) n[j] = Y(by - 1, bx - 1 + j);
          for (int j = 0; j < 4; ++j) n[9 + j] = Y(by + j, bx - 1);
          if (!(av & 4)) {        // above-right missing: replicate above[3]
            for (int j = 5; j < 9; ++j) n[j] = n[4];
          }
          int pred;
          if (mode == 2) {
            const int sa = n[1] + n[2] + n[3] + n[4];
            const int sl = n[9] + n[10] + n[11] + n[12];
            pred = dc_select(av, (sa + sl + 4) >> 3, (sl + 2) >> 2,
                             (sa + 2) >> 2);
          } else {
            const int* w = s.w + (mode * 16 + 4 * py + px) * 13;
            int acc = 0;
            for (int j = 0; j < 13; ++j) acc += w[j] * n[j];
            pred = (acc + 2) >> 2;
          }
          val = clip255(pred + s.res_l[(by - my + py) * 16 + bx - mx + px]);
        }
        __syncwarp();             // a block may read its own pels (clamps)
        if (t < 16) Y(by + py, bx + px) = val;
        __syncwarp();
      }
    }
  } else {
    // Intra_16x16, one thread per pel
    const int px = t & 15, py = t >> 4;
    const int mode = s.i16_mode;
    const int corner = Y(my - 1, mx - 1);
    int sa = 0, sl = 0;
    for (int j = 0; j < 16; ++j) {
      sa += Y(my - 1, mx + j);
      sl += Y(my + j, mx - 1);
    }
    int pred;
    if (mode == 0) {
      pred = Y(my - 1, mx + px);
    } else if (mode == 1) {
      pred = Y(my + py, mx - 1);
    } else if (mode == 2) {
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
    lval = clip255(pred + s.res_l[py * 16 + px]);
  }

  // ---- chroma: threads 128..191 Cb, 192..255 Cr, one pel each; on an
  // Intra_4x4 MB they run beside warp 0's block steps (disjoint planes)
  const int cp = (t >> 6) & 1, cpx = t & 7, cpy = (t >> 3) & 7;
  int cval = 0;
  if (t >= 128) {
    const int mode = s.chroma_mode;
    auto C = [&](int r, int c) -> int {
      return s.lc[cp][clampi(r, 0, Hc - 1) - cr0][clampi(c, 0, Wc - 1) - cc0];
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
    cval = clip255(pred + s.res_c[cp][cpy * 8 + cpx]);
  }
  __syncthreads();                // every read of a clamped own pel is done
  if (!i4) Y(my + (t >> 4), mx + (t & 15)) = lval;
  if (t >= 128) s.lc[cp][cy + cpy - cr0][cx + cpx - cc0] = cval;
  __syncthreads();

  // ---- write the MB back (L2, as the neighbours read it)
  {
    const int ry = my - r0, rx = mx - c0;
    __stcg(&a.y[(my + (t >> 4)) * W + mx + (t & 15)],
           uint8_t(s.ly[ry + (t >> 4)][rx + (t & 15)]));
    if (t < 128) {
      const int p = t >> 6, j = t & 63;
      uint8_t* plane = p ? a.cr : a.cb;
      __stcg(&plane[(cy + (j >> 3)) * Wc + cx + (j & 7)],
             uint8_t(s.lc[p][cy - cr0 + (j >> 3)][cx - cc0 + (j & 7)]));
    }
  }
}
