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
// levels and scales, (N,) int32 ext_dc and skip_dc, (N, 16) int32 out.
//
// h264_residual_sparse is the port's residual stage (the plain version is
// residual_planes_sparse, h264bsd_tpu_torch/ops/transform.py).
// residual_dc_kernel first writes every block's DC-only residual
// (dc + 32) >> 6 into the per-MB residual planes (the reference's DC-only
// path, transform.c:191-229); then residual_entries_kernel runs the block
// code on every shipped AC block (id = mb*26 + b, b < 24; ids past nMB*26
// are padding), its scales from its MB's luma or chroma QP with
// LEVEL_SCALE_POS in constant memory, and writes the block over the base,
// after it on the same stream. Its DC term is added to position 0: the
// butterflies pass position 0 to every output unshifted, so this equals
// the plain version, which adds the DC after them, and equals K9's
// replacement, because an Intra_16x16 or chroma AC block has no level at
// position 0.
//
// Bound: bytes. A block reads 16 levels and writes 16 int32 residuals
// (~100 bytes) for ~120 int32 operations, far below Hopper's ~5 int32
// operations per byte of HBM bandwidth. Design: one thread per block,
// everything in registers, no shared memory. The TPU version puts the 16
// positions in sublanes and 512 blocks in lanes; on the GPU consecutive
// threads take consecutive blocks.

#include <cuda_runtime.h>

#include <cstdint>

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

// K9: one thread per block.
__global__ void __launch_bounds__(256) idct_blocks_kernel(
    const int32_t* coeff, const int32_t* scales, const int32_t* ext_dc,
    const int32_t* skip_dc, int32_t* out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = coeff[k * 16 + i] * scales[k * 16 + i];
  if (skip_dc[k] != 0) d[0] = ext_dc[k];
  idct_block(d);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[k * 16 + i] = d[i];
}

// Offset of raster block b's pel (r, c) in its MB's residual plane:
// luma (16, 16) for b < 16, else chroma (2, 8, 8), b = 16 + 4*plane + k.
__device__ __forceinline__ int block_pel(int b, int r, int c) {
  if (b < 16) return ((b >> 2) * 4 + r) * 16 + (b & 3) * 4 + c;
  const int k = (b - 16) & 3;
  return ((b - 16) >> 2) * 64 + ((k >> 1) * 4 + r) * 8 + (k & 1) * 4 + c;
}

// Every block's DC-only residual, one thread per pel: (nMB * 384).
__global__ void __launch_bounds__(256) residual_dc_kernel(
    const int32_t* dc, int32_t* res_l, int32_t* res_c, int n_mbs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_mbs * 384) return;
  const int mb = t / 384, p = t - mb * 384;
  if (p < 256) {
    const int b = (p >> 6) * 4 + ((p & 15) >> 2);
    res_l[mb * 256 + p] = (dc[mb * 24 + b] + 32) >> 6;
  } else {
    const int q = p - 256, r = q & 63;
    const int k = ((r >> 3) >> 2) * 2 + ((r & 7) >> 2);
    res_c[mb * 128 + q] = (dc[mb * 24 + 16 + (q >> 6) * 4 + k] + 32) >> 6;
  }
}

// The shipped AC blocks over the DC-only base, one thread per entry.
__global__ void __launch_bounds__(256) residual_entries_kernel(
    const int32_t* ids, const int16_t* levels, const int32_t* qp_y,
    const int32_t* qp_c, const int32_t* dc, int32_t* res_l, int32_t* res_c,
    int n_entries, int n_mbs) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int id = ids[e];
  if (id < 0 || id >= n_mbs * 26) return;
  const int mb = id / 26, b = id - mb * 26;
  if (b >= 24) return;                  // DC entries: in dc already
  const int qp = b < 16 ? qp_y[mb] : qp_c[mb];
  const int* scale = kLevelScalePos[qp % 6];
  const int shift = qp / 6;
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    d[i] = (int)levels[e * 16 + i] * (scale[i] << shift);
  d[0] += dc[mb * 24 + b];
  idct_block(d);
  int32_t* out = b < 16 ? res_l + mb * 256 : res_c + mb * 128;
#pragma unroll
  for (int i = 0; i < 16; ++i) out[block_pel(b, i >> 2, i & 3)] = d[i];
}

static int blocks_for(int n) { return (n + 255) / 256; }

extern "C" int h264_idct_blocks(const void* coeff, const void* scales,
                                const void* ext_dc, const void* skip_dc,
                                void* out, int n, void* stream) {
  if (n > 0)
    idct_blocks_kernel<<<blocks_for(n), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)coeff, (const int32_t*)scales,
        (const int32_t*)ext_dc, (const int32_t*)skip_dc, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int h264_residual_sparse(const void* ids, const void* levels,
                                    const void* qp_y, const void* qp_c,
                                    const void* dc, void* res_l, void* res_c,
                                    int n_entries, int n_mbs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_mbs > 0)
    residual_dc_kernel<<<blocks_for(n_mbs * 384), 256, 0, s>>>(
        (const int32_t*)dc, (int32_t*)res_l, (int32_t*)res_c, n_mbs);
  int rc = (int)cudaGetLastError();
  if (rc == 0 && n_entries > 0)
    residual_entries_kernel<<<blocks_for(n_entries), 256, 0, s>>>(
        (const int32_t*)ids, (const int16_t*)levels, (const int32_t*)qp_y,
        (const int32_t*)qp_c, (const int32_t*)dc, (int32_t*)res_l,
        (int32_t*)res_c, n_entries, n_mbs);
  return rc ? rc : (int)cudaGetLastError();
}
