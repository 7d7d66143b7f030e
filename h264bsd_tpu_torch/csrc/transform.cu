// Dequantization and inverse transform of 4x4 residual blocks (K9).
//
// Replaces the TPU kernel _idct_kernel (h264bsd_tpu/ops/pallas_transform.py
// :25), called by idct_blocks_pallas (:64): levels times the per-position
// dequant scales, position 0 replaced by an external DC where skip_dc is
// set, the 4x4 integer IDCT (reference transform.c:157-186) and the
// rounding (x + 32) >> 6, in int32 with arithmetic shifts. Two entry
// points share the block code (idct_block):
//
// h264_idct_blocks is K9 with the JAX package's signature: (N, 16) int32
// levels and scales, (N,) int32 ext_dc and skip_dc, (N, 16) int32 out,
// the three (N, 16) arrays 16-byte aligned. A stream kernel: four
// consecutive lanes take one block, lane r its pixel row r (positions
// 4r..4r+3), so a warp's every load and store is one 16-byte vector a
// lane on 512 contiguous bytes. A lane dequantizes its row and runs the
// row's horizontal butterfly; the group's rows reach each lane by
// shuffles within the four lanes, and the lane runs the vertical
// butterflies of its own output row (the TPU version puts the 16
// positions in sublanes and 512 blocks in lanes). Any N: a group past N
// does nothing, nothing is padded.
//
// h264_residual_sparse is the port's whole residual stage (the plain
// version is residual_planes_sparse, h264bsd_tpu_torch/ops/transform.py,
// with its DC half residual_dc), in one memset and two launches:
// - residual_map_kernel fills slot[mb*26 + b] = e for every valid entry
//   e of the sparse stream (the table is memset to -1 first; ids below 0
//   or from nMB*26 on are padding). A map is needed because the
//   front-end writes the ids class by class, not globally sorted.
// - residual_mb_kernel runs one warp per MB. Lanes 0-15 hold the luma DC
//   levels of its b = 24 entry, lanes 16-23 the chroma DC levels of its
//   b = 25 entry (0 without one). On an Intra_16x16 MB whose nnz_dc[0] is
//   set the 4x4 Hadamard runs across lanes 0-15 by shuffles, with the
//   LEVEL_SCALE_DC scaling (reference transform.c:255-338); otherwise the
//   DC passes through, and an MB that is not Intra_16x16 has no luma DC.
//   The chroma QP is QP_C[clip(qp_y + chroma_qp_offset, 0, 51)]; the 2x2
//   chroma transform and its scaling (transform.c:359-401) run where
//   nnz_dc[1] or nnz_dc[2] is set. Then lane b < 24 makes block b: its
//   shipped AC entry dequantized and transformed with the DC added to
//   position 0 (the butterflies pass position 0 to every output
//   unshifted, so this equals the plain version, which adds the DC after
//   them), or, without an entry, the DC-only residual (dc + 32) >> 6 (the
//   reference's DC-only path, transform.c:191-229). The warp assembles the
//   MB's 384 residuals in shared memory and writes them once, 16 bytes a
//   lane, into res_l (nMB, 16, 16) and res_c (nMB, 2, 8, 8).
//
// Bound: bytes. K9 moves 200 bytes a block (64 of levels, 64 of scales,
// 8 of ext_dc and skip_dc, 64 out) for ~120 int32 operations, far below
// Hopper's ~5 int32 operations per byte of HBM bandwidth: its design is
// about keeping enough coalesced bytes in flight (two 16-byte streaming
// loads a lane, 2048 lanes an SM, 64 KB an SM against the ~15 KB that
// 3.35 TB/s at ~0.6 us of latency needs). The residual stage writes each
// output once and reads each entry, DC entries included, once; the DC
// transforms that ran as ~60 PyTorch launches stay in registers.

#include <cuda_runtime.h>

#include <cstdint>

// chroma QP by clip(qp_y + chroma_qp_offset, 0, 51) (spec Table 8-15,
// reference h264bsd_util.c:53; ops/transform.py QP_C)
__constant__ int kQpC[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

// levelScale[qp % 6][0], the DC transforms' multiplier (ops/transform.py
// LEVEL_SCALE_DC)
__constant__ int kLevelScaleDc[6] = {10, 11, 13, 14, 16, 18};

// levelScale[qp % 6][SCALE_IDX[pos]] per raster position (spec 8.5.9,
// reference transform.c:58-59; ops/transform.py LEVEL_SCALE_POS)
__constant__ int kLevelScalePos[6][16] = {
    {10, 13, 10, 13, 13, 16, 13, 16, 10, 13, 10, 13, 13, 16, 13, 16},
    {11, 14, 11, 14, 14, 18, 14, 18, 11, 14, 11, 14, 14, 18, 14, 18},
    {13, 16, 13, 16, 16, 20, 16, 20, 13, 16, 13, 16, 16, 20, 16, 20},
    {14, 18, 14, 18, 18, 23, 18, 23, 14, 18, 14, 18, 18, 23, 18, 23},
    {16, 20, 16, 20, 20, 25, 20, 25, 16, 20, 16, 20, 20, 25, 20, 25},
    {18, 23, 18, 23, 23, 29, 23, 29, 18, 23, 18, 23, 23, 29, 23, 29}};

// The body of _idct_kernel (pallas_transform.py:30-58) on one dequantized
// raster block d (position 0 already set), in place: horizontal, then
// vertical butterflies, then (x + 32) >> 6.
__device__ __forceinline__ void idct_block(int d[16]) {
  int h[16];
#pragma unroll
  for (int g = 0; g < 4; ++g) {       // positions 4g..4g+3: one pixel row
    const int a = d[4 * g], b = d[4 * g + 1], c = d[4 * g + 2],
              e = d[4 * g + 3];
    const int t0 = a + c, t1 = a - c, t2 = (b >> 1) - e, t3 = b + (e >> 1);
    h[4 * g + 0] = t0 + t3;
    h[4 * g + 1] = t1 + t2;
    h[4 * g + 2] = t1 - t2;
    h[4 * g + 3] = t0 - t3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {       // stride-4 positions: one column
    const int a = h[c], b = h[c + 4], cc = h[c + 8], e = h[c + 12];
    const int t0 = a + cc, t1 = a - cc, t2 = (b >> 1) - e, t3 = b + (e >> 1);
    d[c + 0] = (t0 + t3 + 32) >> 6;
    d[c + 4] = (t1 + t2 + 32) >> 6;
    d[c + 8] = (t1 - t2 + 32) >> 6;
    d[c + 12] = (t0 - t3 + 32) >> 6;
  }
}

// K9: four lanes per block, lane r of a group its pixel row r.
#define IDCT_THREADS 256

__global__ void __launch_bounds__(IDCT_THREADS, 2048 / IDCT_THREADS)
    idct_blocks_kernel(const int4* __restrict__ coeff,
                       const int4* __restrict__ scales,
                       const int32_t* __restrict__ ext_dc,
                       const int32_t* __restrict__ skip_dc,
                       int4* __restrict__ out, int n) {
  // row q = 4k + r of the (4N, 4) view: block k's pixel row r
  const long long q = (long long)blockIdx.x * IDCT_THREADS + threadIdx.x;
  const long long k = q >> 2;
  if (k >= n) return;                       // the whole group of four
  const int r = threadIdx.x & 3;
  const unsigned group = 0xFu << (threadIdx.x & 28);
  // levels and scales are read once: streaming loads; the output stays
  // cached for the caller's next read
  const int4 lv = __ldcs(coeff + q), sc = __ldcs(scales + q);
  int a = lv.x * sc.x;
  const int b = lv.y * sc.y, c = lv.z * sc.z, e = lv.w * sc.w;
  if (r == 0 && __ldcs(skip_dc + k) != 0) a = __ldcs(ext_dc + k);
  // the horizontal butterfly of row r (idct_block's first pass)
  int h[4];
  {
    const int t0 = a + c, t1 = a - c, t2 = (b >> 1) - e, t3 = b + (e >> 1);
    h[0] = t0 + t3;
    h[1] = t1 + t2;
    h[2] = t1 - t2;
    h[3] = t0 - t3;
  }
  // column j of the four rows, from the group's lanes
  int col[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j][i] = __shfl_sync(group, h[j], i, 4);
  }
  // the vertical butterflies' output row r, rounded
  int v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t0 = col[j][0] + col[j][2], t1 = col[j][0] - col[j][2],
              t2 = (col[j][1] >> 1) - col[j][3],
              t3 = col[j][1] + (col[j][3] >> 1);
    const int x = r == 0 ? t0 + t3 : (r == 1 ? t1 + t2 : (r == 2 ? t1 - t2
                                                                : t0 - t3));
    v[j] = (x + 32) >> 6;
  }
  out[q] = make_int4(v[0], v[1], v[2], v[3]);
}

// Offset of raster block b's pel (r, c) in its MB's 384 residuals: luma
// (16, 16) for b < 16, then chroma (2, 8, 8), b = 16 + 4*plane + k.
__device__ __forceinline__ int block_pel(int b, int r, int c) {
  if (b < 16) return ((b >> 2) * 4 + r) * 16 + (b & 3) * 4 + c;
  const int k = (b - 16) & 3;
  return 256 + ((b - 16) >> 2) * 64 + ((k >> 1) * 4 + r) * 8 + (k & 1) * 4 +
         c;
}

// slot[ids[e]] = e for every valid entry (slot memset to -1 before)
__global__ void __launch_bounds__(256) residual_map_kernel(
    const int64_t* ids, int n_entries, int n_ids, int* slot) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int64_t id = ids[e];
  if (id >= 0 && id < n_ids) slot[id] = e;
}

// output k of the 4-point Hadamard pass of the luma DC transform
// (ops/transform.py _butterfly with half=False)
__device__ __forceinline__ int hadamard4(const int d[4], int k) {
  const int t0 = d[0] + d[2], t1 = d[0] - d[2], t2 = d[1] - d[3],
            t3 = d[1] + d[3];
  return k == 0 ? t0 + t3 : (k == 1 ? t1 + t2 : (k == 2 ? t1 - t2 : t0 - t3));
}

// output k of the 2x2 chroma DC transform (ops/transform.py
// chroma_dc_transform): [t0 + t3, t0 - t3, t1 + t2, t1 - t2]
__device__ __forceinline__ int chroma2x2(const int d[4], int k) {
  const int t0 = d[0] + d[2], t1 = d[0] - d[2], t2 = d[1] - d[3],
            t3 = d[1] + d[3];
  return k == 0 ? t0 + t3 : (k == 1 ? t0 - t3 : (k == 2 ? t1 + t2 : t1 - t2));
}

#define RES_WARPS 8
#define FULL_MASK 0xffffffffu

// One warp per MB: the DC transforms, the 24 blocks, one coalesced write.
__global__ void __launch_bounds__(RES_WARPS * 32) residual_mb_kernel(
    const int16_t* levels, const uint8_t* qp_y, const int8_t* cqo,
    const int32_t* nnz_dc, const uint8_t* is_i16, const int* slot,
    int32_t* res_l, int32_t* res_c, int n_mbs) {
  __shared__ __align__(16) int tile[RES_WARPS][384];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int mb = blockIdx.x * RES_WARPS + wid;
  if (mb >= n_mbs) return;                  // the whole warp
  const int e = lane < 26 ? slot[mb * 26 + lane] : -1;
  const int qp = qp_y[mb];
  const int qpc = kQpC[min(max(qp + cqo[mb], 0), 51)];
  const int e_l = __shfl_sync(FULL_MASK, e, 24);
  const int e_c = __shfl_sync(FULL_MASK, e, 25);
  // the untransformed DC of the lane's block: luma DC level `lane`,
  // chroma DC level lane - 16 (cb 0-3, cr 0-3)
  int raw = 0;
  if (lane < 16) {
    if (e_l >= 0) raw = levels[e_l * 16 + lane];
  } else if (lane < 24) {
    if (e_c >= 0) raw = levels[e_c * 16 + lane - 16];
  }
  // 4x4 Hadamard: along each row of 4 lanes, then down the columns;
  // the 2x2 chroma transform within each group of 4 lanes
  int g[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g[j] = __shfl_sync(FULL_MASK, raw, (lane & ~3) + j);
  }
  const int hx = hadamard4(g, lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __shfl_sync(FULL_MASK, hx, (lane & 3) + 4 * i);
  }
  int dc = 0;
  if (lane < 16) {
    if (is_i16[mb]) {
      dc = raw;
      if (nnz_dc[mb * 3] > 0) {
        const int v = hadamard4(h, (lane >> 2) & 3);
        const int lev = kLevelScaleDc[qp % 6], qd = qp / 6;
        dc = qp >= 12 ? v * (lev << (qd - 2))
                      : (v * lev + (qd == 1 ? 1 : 2)) >> (2 - qd);
      }
    }
  } else if (lane < 24) {
    dc = raw;
    if (nnz_dc[mb * 3 + 1] > 0 || nnz_dc[mb * 3 + 2] > 0) {
      const int v = chroma2x2(g, lane & 3);
      const int lev = kLevelScaleDc[qpc % 6], qd = qpc / 6;
      dc = qpc >= 6 ? v * (lev << (qd - 1)) : (v * lev) >> 1;
    }
  }
  int* out = tile[wid];
  if (lane < 24) {
    int d[16];
    if (e >= 0) {
      const int q = lane < 16 ? qp : qpc;
      const int* scale = kLevelScalePos[q % 6];
      const int shift = q / 6;
      const int4* src = reinterpret_cast<const int4*>(levels + e * 16);
      const int4 w0 = src[0], w1 = src[1];
      const int words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int lv = (int)(int16_t)(words[i >> 1] >> (16 * (i & 1)));
        d[i] = lv * (scale[i] << shift);
      }
      d[0] += dc;
      idct_block(d);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = (dc + 32) >> 6;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<int4*>(&out[block_pel(lane, r, 0)]) =
          make_int4(d[4 * r], d[4 * r + 1], d[4 * r + 2], d[4 * r + 3]);
    }
  }
  __syncwarp();
  const int4* t4 = reinterpret_cast<const int4*>(out);
  int4* ol = reinterpret_cast<int4*>(res_l + mb * 256);
  int4* oc = reinterpret_cast<int4*>(res_c + mb * 128);
  ol[lane] = t4[lane];
  ol[lane + 32] = t4[lane + 32];
  oc[lane] = t4[64 + lane];
}

static int blocks_for(int n) { return (n + 255) / 256; }

extern "C" int h264_idct_blocks(const void* coeff, const void* scales,
                                const void* ext_dc, const void* skip_dc,
                                void* out, int n, void* stream) {
  const long long lanes = 4LL * n;         // four a block
  if (n > 0)
    idct_blocks_kernel<<<(unsigned)((lanes + IDCT_THREADS - 1) /
                                    IDCT_THREADS),
                         IDCT_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)coeff, (const int4*)scales, (const int32_t*)ext_dc,
        (const int32_t*)skip_dc, (int4*)out, n);
  return (int)cudaGetLastError();
}

// slot: nMB*26 int32 scratch, filled here
extern "C" int h264_residual_sparse(const void* ids, const void* levels,
                                    const void* qp_y, const void* cqo,
                                    const void* nnz_dc, const void* is_i16,
                                    void* slot, void* res_l, void* res_c,
                                    int n_entries, int n_mbs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_mbs <= 0) return (int)cudaGetLastError();
  int rc = (int)cudaMemsetAsync(slot, 0xFF, sizeof(int) * 26 * n_mbs, s);
  if (rc == 0 && n_entries > 0) {
    residual_map_kernel<<<blocks_for(n_entries), 256, 0, s>>>(
        (const int64_t*)ids, n_entries, 26 * n_mbs, (int*)slot);
    rc = (int)cudaGetLastError();
  }
  if (rc == 0) {
    residual_mb_kernel<<<(n_mbs + RES_WARPS - 1) / RES_WARPS, RES_WARPS * 32,
                         0, s>>>(
        (const int16_t*)levels, (const uint8_t*)qp_y, (const int8_t*)cqo,
        (const int32_t*)nnz_dc, (const uint8_t*)is_i16, (const int*)slot,
        (int32_t*)res_l, (int32_t*)res_c, n_mbs);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
