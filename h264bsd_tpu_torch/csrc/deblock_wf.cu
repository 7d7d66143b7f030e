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
// Validity of the wavefront (K1): MB (r, c) reads pels last written by
// (r, c-1), (r-1, c) and (r-1, c+1), all on earlier anti-diagonals of
// w = 2r + c, and MBs of one diagonal have disjoint read/write footprints
// (pallas_deblock_wf.py:10-20), so one launch per diagonal with one thread
// block per MB reproduces the raster order exactly.
//
// Bound: not the bytes (a 720p frame's planes are 1.38 MB read and written
// once plus 1.3 MB of bS and thresholds, under 2 us at 3.35 TB/s) but the
// chain of 2(hm-1)+wm dependent diagonals: 168 at 720p, 254 at 1080p.
// Design: one launch per diagonal, 32 threads per MB. Threads 0-15 own one
// luma pel row for the vertical edges and one pel column for the
// horizontal ones, threads 16-23 and 24-31 the same for Cb and Cr; a row
// (column) is touched by one thread only, so the four vertical edges need
// no barrier between them, and one barrier separates them from the
// horizontal edges. An edge whose bS is 0 is skipped before any pel is
// loaded, and the frame-border edges (bS 0 by construction) are skipped
// by position too, so no read leaves the planes. A single persistent
// launch with per-row progress flags is left to a later change.

#include <cuda_runtime.h>

#include <algorithm>

#include <cstdint>

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

// Filter MB `mb`; called by the 32 threads of the block with the same mb.
__device__ void deblock_mb(const DeblockArgs& a, int mb) {
  const int t = threadIdx.x;
  const int W = a.width_mbs * 16, Wc = W / 2;
  const int mx = (mb % a.width_mbs) * 16, my = (mb / a.width_mbs) * 16;
  const int* bl = a.bs_left + mb * 16;
  const int* bt = a.bs_top + mb * 16;
  // edge class: 0 inner, 1 top MB edge, 2 left MB edge; tc0 by bS-1
  auto tc_of = [](const int32_t* tc0, int cls, int bs) {
    return tc0[cls * 3 + clip3(0, 2, bs - 1)];
  };

  // vertical edges, left to right; each thread owns one pel row
  if (t < 16) {
    uint8_t* row = a.y + (my + t) * W + mx;
    for (int e = 0; e < 4; ++e) {
      const int bs = bl[(t >> 2) * 4 + e];
      if (bs == 0 || (e == 0 && mx == 0)) continue;
      const int cls = e == 0 ? 2 : 0;
      filter_luma(row + 4 * e, 1, bs, a.l_alpha[mb * 3 + cls],
                  a.l_beta[mb * 3 + cls], tc_of(a.l_tc0 + mb * 9, cls, bs));
    }
  } else {
    const int k = t & 7;
    uint8_t* row = (t < 24 ? a.cb : a.cr) + (my / 2 + k) * Wc + mx / 2;
    for (int e = 0; e < 2; ++e) {
      const int bs = bl[(k >> 1) * 4 + 2 * e];
      if (bs == 0 || (e == 0 && mx == 0)) continue;
      const int cls = e == 0 ? 2 : 0;
      filter_chroma(row + 4 * e, 1, bs, a.c_alpha[mb * 3 + cls],
                    a.c_beta[mb * 3 + cls], tc_of(a.c_tc0 + mb * 9, cls, bs));
    }
  }
  __syncthreads();

  // horizontal edges, top to bottom; each thread owns one pel column
  if (t < 16) {
    uint8_t* col = a.y + my * W + mx + t;
    for (int v = 0; v < 4; ++v) {
      const int bs = bt[v * 4 + (t >> 2)];
      if (bs == 0 || (v == 0 && my == 0)) continue;
      const int cls = v == 0 ? 1 : 0;
      filter_luma(col + 4 * v * W, W, bs, a.l_alpha[mb * 3 + cls],
                  a.l_beta[mb * 3 + cls], tc_of(a.l_tc0 + mb * 9, cls, bs));
    }
  } else {
    const int k = t & 7;
    uint8_t* col = (t < 24 ? a.cb : a.cr) + (my / 2) * Wc + mx / 2 + k;
    for (int v = 0; v < 2; ++v) {
      const int bs = bt[v * 8 + (k >> 1)];
      if (bs == 0 || (v == 0 && my == 0)) continue;
      const int cls = v == 0 ? 1 : 0;
      filter_chroma(col + 4 * v * Wc, Wc, bs, a.c_alpha[mb * 3 + cls],
                    a.c_beta[mb * 3 + cls], tc_of(a.c_tc0 + mb * 9, cls, bs));
    }
  }
  __syncthreads();
}

// K1: the MBs of diagonal w, one block each
__global__ void __launch_bounds__(32)
deblock_wf_kernel(DeblockArgs a, int w, int r_lo) {
  const int r = r_lo + blockIdx.x;
  deblock_mb(a, r * a.width_mbs + (w - 2 * r));
}

// K8: one block walks every MB in raster order
__global__ void __launch_bounds__(32) deblock_raster_kernel(DeblockArgs a) {
  const int n = a.width_mbs * a.height_mbs;
  for (int mb = 0; mb < n; ++mb) deblock_mb(a, mb);
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
    const void* c_alpha, const void* c_beta, const void* c_tc0,
    int width_mbs, int height_mbs, void* stream) {
  const DeblockArgs a = make_args(y, cb, cr, bs_left, bs_top, l_alpha, l_beta,
                                  l_tc0, c_alpha, c_beta, c_tc0, width_mbs,
                                  height_mbs);
  const int n_wf = 2 * (height_mbs - 1) + width_mbs;
  for (int w = 0; w < n_wf; ++w) {
    // rows r with 0 <= w - 2r < width_mbs
    const int r_lo = std::max(0, (w - width_mbs + 2) / 2);
    const int r_hi = std::min(height_mbs - 1, w / 2);
    if (r_hi < r_lo) continue;
    deblock_wf_kernel<<<r_hi - r_lo + 1, 32, 0, (cudaStream_t)stream>>>(
        a, w, r_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
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
