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
// planes. K8 runs the same per-MB code on the planes in device memory.

#include <cuda_runtime.h>

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

// One MB's rows of bS and thresholds, in device or shared memory.
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

__device__ __forceinline__ MbParams params_in_memory(const DeblockArgs& a,
                                                     int mb) {
  return MbParams{a.bs_left + mb * 16, a.bs_top + mb * 16,
                  a.l_alpha + mb * 3,  a.l_beta + mb * 3,
                  a.l_tc0 + mb * 9,    a.c_alpha + mb * 3,
                  a.c_beta + mb * 3,   a.c_tc0 + mb * 9};
}

// Filter one MB; called by the 32 threads of the block. y points at the
// MB's top-left luma pel in a plane of row pitch yp, cb and cr at its
// chroma pels (pitch cp), in device or shared memory; left / top: the MB
// is on the picture's left / top border, whose edges are skipped.
__device__ void deblock_mb(const MbParams& p, bool left, bool top,
                           uint8_t* y, int yp, uint8_t* cb, uint8_t* cr,
                           int cp) {
  const int t = threadIdx.x;
  // edge class: 0 inner, 1 top MB edge, 2 left MB edge; tc0 by bS-1
  auto tc_of = [](const int32_t* tc0, int cls, int bs) {
    return tc0[cls * 3 + clip3(0, 2, bs - 1)];
  };

  // vertical edges, left to right; each thread owns one pel row
  if (t < 16) {
    uint8_t* row = y + t * yp;
    for (int e = 0; e < 4; ++e) {
      const int bs = p.bs_left[(t >> 2) * 4 + e];
      if (bs == 0 || (e == 0 && left)) continue;
      const int cls = e == 0 ? 2 : 0;
      filter_luma(row + 4 * e, 1, bs, p.l_alpha[cls], p.l_beta[cls],
                  tc_of(p.l_tc0, cls, bs));
    }
  } else {
    const int k = t & 7;
    uint8_t* row = (t < 24 ? cb : cr) + k * cp;
    for (int e = 0; e < 2; ++e) {
      const int bs = p.bs_left[(k >> 1) * 4 + 2 * e];
      if (bs == 0 || (e == 0 && left)) continue;
      const int cls = e == 0 ? 2 : 0;
      filter_chroma(row + 4 * e, 1, bs, p.c_alpha[cls], p.c_beta[cls],
                    tc_of(p.c_tc0, cls, bs));
    }
  }
  __syncthreads();

  // horizontal edges, top to bottom; each thread owns one pel column
  if (t < 16) {
    uint8_t* col = y + t;
    for (int v = 0; v < 4; ++v) {
      const int bs = p.bs_top[v * 4 + (t >> 2)];
      if (bs == 0 || (v == 0 && top)) continue;
      const int cls = v == 0 ? 1 : 0;
      filter_luma(col + 4 * v * yp, yp, bs, p.l_alpha[cls], p.l_beta[cls],
                  tc_of(p.l_tc0, cls, bs));
    }
  } else {
    const int k = t & 7;
    uint8_t* col = (t < 24 ? cb : cr) + k;
    for (int v = 0; v < 2; ++v) {
      const int bs = p.bs_top[v * 8 + (k >> 1)];
      if (bs == 0 || (v == 0 && top)) continue;
      const int cls = v == 0 ? 1 : 0;
      filter_chroma(col + 4 * v * cp, cp, bs, p.c_alpha[cls], p.c_beta[cls],
                    tc_of(p.c_tc0, cls, bs));
    }
  }
  __syncthreads();
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

// K8: one block walks every MB in raster order, in device memory
__global__ void __launch_bounds__(32) deblock_raster_kernel(DeblockArgs a) {
  const int n = a.width_mbs * a.height_mbs;
  const int W = a.width_mbs * 16, Wc = W / 2;
  for (int mb = 0; mb < n; ++mb) {
    const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
    const int coff = (my / 2) * Wc + mx / 2;
    deblock_mb(params_in_memory(a, mb), mx == 0, my == 0,
               a.y + my * W + mx, W, a.cb + coff, a.cr + coff, Wc);
  }
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
  deblock_raster_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
