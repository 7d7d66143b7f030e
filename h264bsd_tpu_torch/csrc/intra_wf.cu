// Intra wavefront kernel (K7): reconstructs every intra MB of the frame,
// one launch per anti-diagonal w = 2r + c, one thread block per MB on it.
//
// Replaces the TPU kernel _intra_wf_kernel of intra_pass_wavefront_pallas
// (h264bsd_tpu/ops/pallas_intra_wf.py:600), which batches G MBs of one
// anti-diagonal per vector step.
//
// Validity: an MB predicts from its left (r, c-1), above (r-1, c), above-
// left (r-1, c-1) and above-right (r-1, c+1) neighbours, all on earlier
// diagonals; two MBs of one diagonal are (+1 row, -2 MBs) apart, so the
// rectangle one of them reads (rows 16r-1..16r+15, columns 16c-1..16c+19)
// and the MB the other writes never overlap. Launch order serializes the
// diagonals.
//
// Bound: not the bytes (a 720p frame's planes and residuals are 7 MB
// read and 1.4 MB written, about 2.5 us at 3.35 TB/s) but the chain of
// 2(hm-1)+wm dependent diagonals (168 at 720p, 254 at 1080p), each a
// chain of up to 16 barrier steps inside its MBs. Design: one launch per
// diagonal keeps the dependency in launch order; each MB's read rectangle
// sits in shared memory while its block steps run (intra_mb.cuh). A
// single persistent launch that waits on per-row progress flags instead
// of launch boundaries is left to a later change.

#include <cuda_runtime.h>

#include <algorithm>

#include "intra_mb.cuh"

__global__ void __launch_bounds__(INTRA_THREADS)
intra_wf_kernel(IntraArgs a, int w, int r_lo) {
  __shared__ IntraSmem s;
  const int r = r_lo + blockIdx.x;
  const int mb = r * a.width_mbs + (w - 2 * r);
  const int cls = a.mb_class[mb];
  if (cls != 3 && cls != 4) return;
  intra_mb(a, mb, s);
}

extern "C" int h264_intra_wavefront(
    void* y, void* cb, void* cr, const void* mb_class, const void* i4_modes,
    const void* i4_avail, const void* mb_avail, const void* i16_mode,
    const void* chroma_mode, const void* resid_luma, const void* resid_chroma,
    const void* i4_weights, int width_mbs, int height_mbs, void* stream) {
  IntraArgs a{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr,
              (const int32_t*)mb_class, (const int32_t*)i4_modes,
              (const int32_t*)i4_avail, (const int32_t*)mb_avail,
              (const int32_t*)i16_mode, (const int32_t*)chroma_mode,
              (const int32_t*)resid_luma, (const int32_t*)resid_chroma,
              (const int32_t*)i4_weights, width_mbs, height_mbs};
  const int n_wf = 2 * (height_mbs - 1) + width_mbs;
  for (int w = 0; w < n_wf; ++w) {
    // rows r with 0 <= w - 2r < width_mbs
    const int r_lo = std::max(0, (w - width_mbs + 2) / 2);
    const int r_hi = std::min(height_mbs - 1, w / 2);
    if (r_hi < r_lo) continue;
    intra_wf_kernel<<<r_hi - r_lo + 1, INTRA_THREADS, 0,
                      (cudaStream_t)stream>>>(a, w, r_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
