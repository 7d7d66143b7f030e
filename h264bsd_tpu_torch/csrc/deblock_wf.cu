// In-loop deblocking kernels: the wavefront kernel (K1) and the raster
// kernel (K8), sharing the per-MB device code.
//
// K1 replaces the TPU kernel _wf_shear_kernel of
// deblock_frame_wavefront_from_bs (h264bsd_tpu/ops/pallas_deblock_wf.py:616)
// and K8 the TPU kernel _deblock_kernel of deblock_frame_pallas_from_bs
// (h264bsd_tpu/ops/pallas_deblock.py:335). Semantics are those of
// h264bsd_tpu_torch/ops/deblock.py: per MB in raster order, the luma and
// chroma vertical edges left to right, then the horizontal edges top to
// bottom, each 4-pel group of an edge with the bS of its block, the bS<4
// clipped filter or the bS=4 strong filter (reference deblocking.c:656-1083).
// bS, alpha, beta and tc0 come from boundary_strengths / edge_thresholds.
//
// Validity of K1's schedule: MB (r, c) touches (reads or writes) its
// own pels and 4-pel (chroma 2-pel) margins of its left and above MBs.
// The pels it reads were last written by (r, c-1), (r-1, c) and
// (r-1, c+1) (whose left-edge filter reaches the above MB's last three
// columns), and every other MB whose footprint meets its own waits for
// it, so waiting for those three reproduces the raster order exactly --
// the wavefront argument of pallas_deblock_wf.py:10-20, where those
// three lie on earlier anti-diagonals w = 2r + c.
//
// Bound: not the bytes (a 720p frame's planes are 1.38 MB read and written
// once plus 1.3 MB of bS and thresholds, under 2 us at 3.35 TB/s) but the
// chain of 2(hm-1)+wm dependent MBs: 168 at 720p, 254 at 1080p.
// Design: one launch, one 32-thread block per MB taking MBs in raster
// order from a ticket counter, per-MB done flags instead of a launch per
// diagonal (mb_sync.cuh). Before its wait a block loads the MB's bS and
// thresholds and its own pels, which no earlier MB writes, into shared
// memory; after it, one L2 round trip brings the margins, the MB is
// filtered in the shared tile, and the tile is written back before the
// flag is released. Threads 0-15 own one luma pel row for the vertical
// edges and one pel column for the horizontal ones, threads 16-23 and
// 24-31 the same for Cb and Cr; a row (column) is touched by one thread
// only, so the four vertical edges need no barrier between them, and one
// barrier separates them from the horizontal edges. An edge whose bS is
// 0 is skipped before any pel is loaded, and the frame-border edges (bS
// 0 by construction) are skipped by position too, so no read leaves the
// planes.
//
// K8 takes the frames under 3 MBs wide, whose raster order is one chain
// of every MB (at width 2, MB (r, 0) waits on (r-1, 1)), so its bound is
// the chain: nMB x the per-MB filter latency, not the bytes (a 2x543
// frame's planes and parameters are 0.9 MB, 0.3 us at 3.35 TB/s). Design:
// one block of RB_THREADS threads. It stages bands of RB_ROWS MB rows in
// shared memory (pels, bS and thresholds, with cp.async), double buffered:
// while warps 0 (luma) and 1 (chroma) filter band k with the per-MB code
// below, every thread's copies of band k+1 are in flight. Before band k
// is filtered, the 4 luma and 2 chroma rows above it -- band k-1's last
// rows, which band k's top edges read and change -- are copied into band
// k's halo rows, and band k-1 is written back without them; they go back
// as band k's halo. The kernel reads no plane row it has written: a
// band's own rows are untouched until the band itself is filtered.

#include <cuda_runtime.h>

#include <cuda_pipeline.h>

#include <cstdint>

#include "mb_sync.cuh"

struct DeblockArgs {
  uint8_t* y;                // (16*hm, 16*wm)
  uint8_t* cb;               // (8*hm, 8*wm)
  uint8_t* cr;
  const int32_t* bs_left;    // (nMB, 16) raster blocks
  const int32_t* bs_top;     // (nMB, 16)
  const int32_t* l_alpha;    // (nMB, 3) [inner, top, left]
  const int32_t* l_beta;     // (nMB, 3)
  const int32_t* l_tc0;      // (nMB, 3, 3) [edge class][bS-1]
  const int32_t* c_alpha;
  const int32_t* c_beta;
  const int32_t* c_tc0;
  int width_mbs;
  int height_mbs;
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// one pel line across a luma edge: q points at q0, d is the step across
// the edge (1 for a vertical edge, the row pitch for a horizontal one)
__device__ __forceinline__ void filter_luma(uint8_t* q, int d, int bs,
                                            int alpha, int beta, int tc0) {
  const int p0 = q[-d], p1 = q[-2 * d], p2 = q[-3 * d], p3 = q[-4 * d];
  const int q0 = q[0], q1 = q[d], q2 = q[2 * d], q3 = q[3 * d];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs < 4) {
    const int avg = (p0 + q0 + 1) >> 1;
    const int tc = tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    if (ap) q[-2 * d] = uint8_t(p1 + clip3(-tc0, tc0,
                                           (p2 + avg - (p1 << 1)) >> 1));
    if (aq) q[d] = uint8_t(q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
    q[-d] = uint8_t(clip3(0, 255, p0 + delta));
    q[0] = uint8_t(clip3(0, 255, q0 - delta));
  } else {
    const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
    const int tp = p1 + p0 + q0, tq = p0 + q0 + q1;
    if (strong && ap) {
      q[-d] = uint8_t((p2 + 2 * tp + q1 + 4) >> 3);
      q[-2 * d] = uint8_t((p2 + tp + 2) >> 2);
      q[-3 * d] = uint8_t((2 * p3 + 3 * p2 + tp + 4) >> 3);
    } else {
      q[-d] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (strong && aq) {
      q[0] = uint8_t((p1 + 2 * tq + q2 + 4) >> 3);
      q[d] = uint8_t((tq + q2 + 2) >> 2);
      q[2 * d] = uint8_t((2 * q3 + 3 * q2 + tq + 4) >> 3);
    } else {
      q[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }
}

// one pel line across a chroma edge (2-pel reach, tc = tc0 + 1)
__device__ __forceinline__ void filter_chroma(uint8_t* q, int d, int bs,
                                              int alpha, int beta, int tc0) {
  const int p0 = q[-d], p1 = q[-2 * d], q0 = q[0], q1 = q[d];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    q[-d] = uint8_t(clip3(0, 255, p0 + delta));
    q[0] = uint8_t(clip3(0, 255, q0 - delta));
  } else {
    q[-d] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
    q[0] = uint8_t((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

// One MB's rows of bS and thresholds, in shared memory.
struct MbParams {
  const int32_t* bs_left;     // (16)
  const int32_t* bs_top;      // (16)
  const int32_t* l_alpha;     // (3) [inner, top, left]
  const int32_t* l_beta;      // (3)
  const int32_t* l_tc0;       // (3, 3) [edge class][bS-1]
  const int32_t* c_alpha;
  const int32_t* c_beta;
  const int32_t* c_tc0;
};

// The threads that filter an MB: luma rows (columns) on threads 0-15, Cb
// and Cr on threads kChroma..kChroma+7 and kChroma+8..kChroma+15. K1's
// 32-thread block has them in one warp (kChroma 16), meeting at block
// barriers. K8 puts chroma on warp 1 (kChroma 32), so the chroma edges
// run beside the luma ones instead of after them in a diverged warp, and
// warps 0 and 1 meet at named barrier 1 while the block's other warps go
// on with their own work.
template <int kChroma>
__device__ __forceinline__ void mb_barrier() {
  if (kChroma == 16) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, 64;" ::: "memory");
  }
}

// Filter one MB; called by every thread of the warps above. y points at
// the MB's top-left luma pel in a plane of row pitch yp, cb and cr at its
// chroma pels (pitch cp), in shared memory; left / top: the MB is on the
// picture's left / top border, whose edges are skipped. A thread's bS and
// thresholds for all its edges are loaded together before the first
// filter, so they cost one shared-memory round trip, not two per edge.
template <int kChroma = 16>
__device__ void deblock_mb(const MbParams& p, bool left, bool top,
                           uint8_t* y, int yp, uint8_t* cb, uint8_t* cr,
                           int cp) {
  const int t = threadIdx.x, c = t - kChroma;
  const bool luma = t < 16, chroma = c >= 0 && c < 16;
  // the bS of the thread's 4 (luma) or 2 (chroma) edges of each direction
  int vbs[4] = {0, 0, 0, 0}, hbs[4] = {0, 0, 0, 0};
  const int32_t *alpha = p.c_alpha, *beta = p.c_beta, *tc0 = p.c_tc0;
  if (luma) {
    alpha = p.l_alpha;
    beta = p.l_beta;
    tc0 = p.l_tc0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vbs[e] = p.bs_left[(t >> 2) * 4 + e];
      hbs[e] = p.bs_top[e * 4 + (t >> 2)];
    }
  } else if (chroma) {
    const int k = c & 7;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      vbs[e] = p.bs_left[(k >> 1) * 4 + 2 * e];
      hbs[e] = p.bs_top[e * 8 + (k >> 1)];
    }
  }
  // thresholds by edge class: 0 inner, 1 top MB edge, 2 left MB edge;
  // tc0 rows by class, columns by bS-1
  const int a_in = alpha[0], a_top = alpha[1], a_left = alpha[2];
  const int b_in = beta[0], b_top = beta[1], b_left = beta[2];
  int vtc[4], htc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    vtc[e] = tc0[(e == 0 ? 6 : 0) + clip3(0, 2, vbs[e] - 1)];
    htc[e] = tc0[(e == 0 ? 3 : 0) + clip3(0, 2, hbs[e] - 1)];
  }

  // vertical edges, left to right; each thread owns one pel row
  if (luma) {
    uint8_t* row = y + t * yp;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (vbs[e] == 0 || (e == 0 && left)) continue;
      filter_luma(row + 4 * e, 1, vbs[e], e ? a_in : a_left,
                  e ? b_in : b_left, vtc[e]);
    }
  } else if (chroma) {
    uint8_t* row = (c < 8 ? cb : cr) + (c & 7) * cp;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (vbs[e] == 0 || (e == 0 && left)) continue;
      filter_chroma(row + 4 * e, 1, vbs[e], e ? a_in : a_left,
                    e ? b_in : b_left, vtc[e]);
    }
  }
  mb_barrier<kChroma>();

  // horizontal edges, top to bottom; each thread owns one pel column
  if (luma) {
    uint8_t* col = y + t;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (hbs[v] == 0 || (v == 0 && top)) continue;
      filter_luma(col + 4 * v * yp, yp, hbs[v], v ? a_in : a_top,
                  v ? b_in : b_top, htc[v]);
    }
  } else if (chroma) {
    uint8_t* col = (c < 8 ? cb : cr) + (c & 7);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (hbs[v] == 0 || (v == 0 && top)) continue;
      filter_chroma(col + 4 * v * cp, cp, hbs[v], v ? a_in : a_top,
                    v ? b_in : b_top, htc[v]);
    }
  }
  mb_barrier<kChroma>();
}

// K1: one block per MB, each taking MB k in raster order from the ticket
// counter; sync = nMB done flags, then the ticket. The MB is filtered in
// a shared tile: luma rows my-4..my+15 x columns mx-4..mx+15 (the 4x4
// corner unused), chroma rows cy-2..cy+7 x columns cx-2..cx+7.
#define PRM_COUNT 62   // bS left 16, top 16; luma 3+3+9, chroma 3+3+9

__global__ void __launch_bounds__(32)
deblock_wf_kernel(DeblockArgs a, int* sync) {
  __shared__ uint8_t ty[20][20];
  __shared__ uint8_t tc[2][10][10];
  __shared__ int32_t prm[PRM_COUNT];
  __shared__ int ticket;
  const int wm = a.width_mbs, n_mbs = wm * a.height_mbs;
  const int mb = mb_take_ticket(sync + n_mbs, &ticket);
  const int t = threadIdx.x;
  const int r = mb / wm, c = mb % wm;
  const int W = wm * 16, Wc = W / 2;
  const int mx = c * 16, my = r * 16, cx = mx / 2, cy = my / 2;
  auto cplane = [&](int p) { return p ? a.cr : a.cb; };

  // ---- before the wait: the MB's parameters, and its own pels, which no
  // MB before it in raster order writes
  {
    int pv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = t + 32 * j;
      pv[j] = i < 16   ? a.bs_left[mb * 16 + i]
              : i < 32 ? a.bs_top[mb * 16 + i - 16]
              : i < 35 ? a.l_alpha[mb * 3 + i - 32]
              : i < 38 ? a.l_beta[mb * 3 + i - 35]
              : i < 47 ? a.l_tc0[mb * 9 + i - 38]
              : i < 50 ? a.c_alpha[mb * 3 + i - 47]
              : i < 53 ? a.c_beta[mb * 3 + i - 50]
              : i < PRM_COUNT ? a.c_tc0[mb * 9 + i - 53] : 0;
    }
    uint8_t v[12];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = t + 32 * j;
      v[j] = __ldcg(&a.y[(my + (i >> 4)) * W + mx + (i & 15)]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + 32 * j, q = i & 63;
      v[8 + j] = __ldcg(&cplane(i >> 6)[(cy + (q >> 3)) * Wc + cx + (q & 7)]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (t + 32 * j < PRM_COUNT) prm[t + 32 * j] = pv[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = t + 32 * j;
      ty[4 + (i >> 4)][4 + (i & 15)] = v[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + 32 * j, q = i & 63;
      tc[i >> 6][2 + (q >> 3)][2 + (q & 7)] = v[8 + j];
    }
  }

  // ---- wait for the left, above and above-right MBs: lanes 0-2 poll
  // one each, on one path, so their loads go out together
  const int dep = t == 0 && c > 0                  ? mb - 1
                  : t == 1 && r > 0                ? mb - wm
                  : t == 2 && r > 0 && c + 1 < wm ? mb - wm + 1
                                                   : -1;
  if (dep >= 0) mb_wait(sync + dep);
  __syncthreads();

  // ---- the margins the left and top MB edges' filters reach: luma 16x4
  // left and 4x16 above (two pels of each per thread), chroma 8x2 left
  // and 2x8 above per plane (one of each)
  {
    const int ll0 = t >> 2, ll1 = (t + 32) >> 2, lc = t & 3;
    const int lt0 = t >> 4, lt1 = (t + 32) >> 4, ltc = t & 15;
    const int p = t >> 4, q = t & 15;
    uint8_t v[6] = {0, 0, 0, 0, 0, 0};
    if (c > 0) {
      v[0] = __ldcg(&a.y[(my + ll0) * W + mx - 4 + lc]);
      v[1] = __ldcg(&a.y[(my + ll1) * W + mx - 4 + lc]);
      v[4] = __ldcg(&cplane(p)[(cy + (q >> 1)) * Wc + cx - 2 + (q & 1)]);
    }
    if (r > 0) {
      v[2] = __ldcg(&a.y[(my - 4 + lt0) * W + mx + ltc]);
      v[3] = __ldcg(&a.y[(my - 4 + lt1) * W + mx + ltc]);
      v[5] = __ldcg(&cplane(p)[(cy - 2 + (q >> 3)) * Wc + cx + (q & 7)]);
    }
    if (c > 0) {
      ty[4 + ll0][lc] = v[0];
      ty[4 + ll1][lc] = v[1];
      tc[p][2 + (q >> 1)][q & 1] = v[4];
    }
    if (r > 0) {
      ty[lt0][4 + ltc] = v[2];
      ty[lt1][4 + ltc] = v[3];
      tc[p][q >> 3][2 + (q & 7)] = v[5];
    }
  }
  __syncthreads();

  const MbParams par{prm,      prm + 16, prm + 32, prm + 35,
                     prm + 38, prm + 47, prm + 50, prm + 53};
  deblock_mb(par, c == 0, r == 0, &ty[4][4], 20, &tc[0][2][2], &tc[1][2][2],
             10);

  // ---- write the tile back (L2, as the next MBs read it), then release
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = t + 32 * j;
    __stcg(&a.y[(my + (i >> 4)) * W + mx + (i & 15)],
           ty[4 + (i >> 4)][4 + (i & 15)]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = t + 32 * j, q = i & 63;
    __stcg(&cplane(i >> 6)[(cy + (q >> 3)) * Wc + cx + (q & 7)],
           tc[i >> 6][2 + (q >> 3)][2 + (q & 7)]);
  }
  {
    const int p = t >> 4, q = t & 15;
    if (c > 0) {
      for (int i = t; i < 64; i += 32) {
        __stcg(&a.y[(my + (i >> 2)) * W + mx - 4 + (i & 3)],
               ty[4 + (i >> 2)][i & 3]);
      }
      __stcg(&cplane(p)[(cy + (q >> 1)) * Wc + cx - 2 + (q & 1)],
             tc[p][2 + (q >> 1)][q & 1]);
    }
    if (r > 0) {
      for (int i = t; i < 64; i += 32) {
        __stcg(&a.y[(my - 4 + (i >> 4)) * W + mx + (i & 15)],
               ty[i >> 4][4 + (i & 15)]);
      }
      __stcg(&cplane(p)[(cy - 2 + (q >> 3)) * Wc + cx + (q & 7)],
             tc[p][q >> 3][2 + (q & 7)]);
    }
  }
  mb_signal(sync + mb);
}

// K8: one block; bands of RB_ROWS MB rows staged in shared memory, double
// buffered (see the header). Shared rows have a pitch 4 bytes wider than
// the plane's, so the 16 luma rows that warp 0's threads own for the
// vertical edges fall in 16 different banks (the chroma rows of warp 1
// likewise); rows move as 4-byte words.
#define RB_THREADS 128
#define RB_ROWS 16                     // MB rows per band
#define RB_MAX_WM 2                    // frames under 3 MBs wide
#define RB_MBS (RB_ROWS * RB_MAX_WM)
#define RB_LP (16 * RB_MAX_WM + 4)     // shared row pitches, bytes
#define RB_CP (8 * RB_MAX_WM + 4)
#define RB_LROWS (4 + 16 * RB_ROWS)    // 4 halo rows, then the band's
#define RB_CROWS (2 + 8 * RB_ROWS)

struct RasterBand {
  uint8_t y[RB_LROWS * RB_LP];
  uint8_t c[2][RB_CROWS * RB_CP];
  // bS left and top (16 per MB), luma alpha, beta (3), tc0 (9), chroma
  // alpha, beta, tc0: each array's rows of the band's MBs, at RB_MBS
  // strides (prm_offset)
  int32_t prm[RB_MBS * PRM_COUNT];
};

// start of parameter array j (DeblockArgs order from bs_left) in a band
__device__ __forceinline__ int prm_offset(int j) {
  constexpr int kStart[8] = {0, 16, 32, 35, 38, 47, 50, 53};
  return kStart[j] * RB_MBS;
}

// rows x (pitch_g bytes) of a plane in device memory into shared rows of
// pitch_s, as asynchronous 4-byte copies spread over the block
__device__ __forceinline__ void rows_to_shared(uint8_t* dst, int pitch_s,
                                               const uint8_t* src,
                                               int pitch_g, int rows) {
  const int wpr = pitch_g >> 2;
  for (int i = threadIdx.x; i < rows * wpr; i += RB_THREADS) {
    const int r = i / wpr, w = i - r * wpr;
    __pipeline_memcpy_async(dst + r * pitch_s + 4 * w,
                            src + r * pitch_g + 4 * w, 4);
  }
}

// shared rows of pitch_s back into the plane, 4-byte words
__device__ __forceinline__ void rows_to_global(uint8_t* dst, int pitch_g,
                                               const uint8_t* src,
                                               int pitch_s, int rows) {
  const int wpr = pitch_g >> 2;
  for (int i = threadIdx.x; i < rows * wpr; i += RB_THREADS) {
    const int r = i / wpr, w = i - r * wpr;
    *reinterpret_cast<uint32_t*>(dst + r * pitch_g + 4 * w) =
        *reinterpret_cast<const uint32_t*>(src + r * pitch_s + 4 * w);
  }
}

__global__ void __launch_bounds__(RB_THREADS)
deblock_raster_kernel(DeblockArgs a) {
  __shared__ __align__(16) RasterBand band[2];
  const int wm = a.width_mbs, hm = a.height_mbs;
  const int W = 16 * wm, Wc = 8 * wm, LP = W + 4, CP = Wc + 4;
  const int n_bands = (hm + RB_ROWS - 1) / RB_ROWS;
  uint8_t* const cplane[2] = {a.cb, a.cr};
  const int32_t* const params[8] = {a.bs_left, a.bs_top, a.l_alpha, a.l_beta,
                                    a.l_tc0,   a.c_alpha, a.c_beta, a.c_tc0};
  constexpr int kWords[8] = {16, 16, 3, 3, 9, 3, 3, 9};  // per MB
  auto rows_of = [&](int k) { return min(RB_ROWS, hm - k * RB_ROWS); };

  // band k's own pels and parameters into band[k & 1]: no MB before the
  // band has changed them
  auto load = [&](int k) {
    RasterBand& b = band[k & 1];
    const int r0 = k * RB_ROWS, rows = rows_of(k), mb0 = r0 * wm;
    rows_to_shared(b.y + 4 * LP, LP, a.y + 16 * r0 * W, W, 16 * rows);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      rows_to_shared(b.c[p] + 2 * CP, CP, cplane[p] + 8 * r0 * Wc, Wc,
                     8 * rows);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = rows * wm * kWords[j];
      const int32_t* src = params[j] + mb0 * kWords[j];
      for (int i = threadIdx.x; i < n; i += RB_THREADS) {
        __pipeline_memcpy_async(b.prm + prm_offset(j) + i, src + i, 4);
      }
    }
    __pipeline_commit();
  };
  // band k written back from its halo rows (band k-1's last rows, final
  // once band k is filtered) on; without its own last 4 luma and 2
  // chroma rows unless it is the last band
  auto store = [&](int k, bool last) {
    const RasterBand& b = band[k & 1];
    const int r0 = k * RB_ROWS, rows = rows_of(k);
    const int ly = k > 0 ? 0 : 4, lc = k > 0 ? 0 : 2;
    rows_to_global(a.y + (16 * r0 - 4 + ly) * W, W, b.y + ly * LP, LP,
                   16 * rows + 4 - ly - (last ? 0 : 4));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      rows_to_global(cplane[p] + (8 * r0 - 2 + lc) * Wc, Wc,
                     b.c[p] + lc * CP, CP, 8 * rows + 2 - lc - (last ? 0 : 2));
    }
  };

  load(0);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int k = 0; k < n_bands; ++k) {
    RasterBand& b = band[k & 1];
    if (k > 0) {
      // band k-1's last rows, filtered, into band k's halo; then band k-1
      // goes back, and its buffer is free for band k+1
      const RasterBand& prev = band[(k - 1) & 1];
      const int lr = 16 * rows_of(k - 1), cr = 8 * rows_of(k - 1);
      for (int i = threadIdx.x; i < LP; i += RB_THREADS) {
        reinterpret_cast<uint32_t*>(b.y)[i] =
            reinterpret_cast<const uint32_t*>(prev.y + lr * LP)[i];
      }
      for (int i = threadIdx.x; i < CP; i += RB_THREADS) {
        const int p = i >= CP / 2, w = i - p * (CP / 2);
        reinterpret_cast<uint32_t*>(b.c[p])[w] =
            reinterpret_cast<const uint32_t*>(prev.c[p] + cr * CP)[w];
      }
      store(k - 1, false);
      __syncthreads();
    }
    if (k + 1 < n_bands) load(k + 1);
    if (threadIdx.x < 64) {
      const int r0 = k * RB_ROWS, n = rows_of(k) * wm;
      for (int i = 0; i < n; ++i) {
        const int rr = i / wm, c = i - rr * wm;
        const int32_t* q = b.prm;
        const MbParams par{q + prm_offset(0) + 16 * i,
                           q + prm_offset(1) + 16 * i,
                           q + prm_offset(2) + 3 * i,
                           q + prm_offset(3) + 3 * i,
                           q + prm_offset(4) + 9 * i,
                           q + prm_offset(5) + 3 * i,
                           q + prm_offset(6) + 3 * i,
                           q + prm_offset(7) + 9 * i};
        deblock_mb<32>(par, c == 0, r0 + rr == 0,
                         b.y + (4 + 16 * rr) * LP + 16 * c, LP,
                         b.c[0] + (2 + 8 * rr) * CP + 8 * c,
                         b.c[1] + (2 + 8 * rr) * CP + 8 * c, CP);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  store(n_bands - 1, true);
}

static DeblockArgs make_args(void* y, void* cb, void* cr, const void* bs_left,
                             const void* bs_top, const void* l_alpha,
                             const void* l_beta, const void* l_tc0,
                             const void* c_alpha, const void* c_beta,
                             const void* c_tc0, int width_mbs,
                             int height_mbs) {
  return DeblockArgs{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr,
                     (const int32_t*)bs_left, (const int32_t*)bs_top,
                     (const int32_t*)l_alpha, (const int32_t*)l_beta,
                     (const int32_t*)l_tc0, (const int32_t*)c_alpha,
                     (const int32_t*)c_beta, (const int32_t*)c_tc0,
                     width_mbs, height_mbs};
}

extern "C" int h264_deblock_wavefront(
    void* y, void* cb, void* cr, const void* bs_left, const void* bs_top,
    const void* l_alpha, const void* l_beta, const void* l_tc0,
    const void* c_alpha, const void* c_beta, const void* c_tc0, void* sync,
    int width_mbs, int height_mbs, void* stream) {
  const DeblockArgs a = make_args(y, cb, cr, bs_left, bs_top, l_alpha, l_beta,
                                  l_tc0, c_alpha, c_beta, c_tc0, width_mbs,
                                  height_mbs);
  deblock_wf_kernel<<<width_mbs * height_mbs, 32, 0, (cudaStream_t)stream>>>(
      a, (int*)sync);
  return (int)cudaGetLastError();
}

extern "C" int h264_deblock_raster(
    void* y, void* cb, void* cr, const void* bs_left, const void* bs_top,
    const void* l_alpha, const void* l_beta, const void* l_tc0,
    const void* c_alpha, const void* c_beta, const void* c_tc0,
    int width_mbs, int height_mbs, void* stream) {
  const DeblockArgs a = make_args(y, cb, cr, bs_left, bs_top, l_alpha, l_beta,
                                  l_tc0, c_alpha, c_beta, c_tc0, width_mbs,
                                  height_mbs);
  if (width_mbs < 1 || width_mbs > RB_MAX_WM || height_mbs < 1) {
    return (int)cudaErrorInvalidValue;
  }
  deblock_raster_kernel<<<1, RB_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
