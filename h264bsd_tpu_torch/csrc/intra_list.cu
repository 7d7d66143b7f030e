// Intra list kernel (K2): reconstructs the listed intra MBs in list order
// (the front-end's decode order), one thread block walking the list.
//
// Replaces the TPU kernel _intra_kernel of intra_pass_pallas
// (h264bsd_tpu/ops/pallas_intra.py:379), which keeps the planes in VMEM
// and walks the MBs as one sequential program.
//
// Bound: not the bytes (a 40x23-MB frame moves about 2 MB of planes,
// residuals and modes, under a microsecond at 3.35 TB/s) but the
// chain of dependent steps: each MB predicts from its reconstructed
// neighbours, and inside an Intra_4x4 MB each of the 16 blocks from the
// blocks before it, so the list is one serial chain of up to 16 barrier
// steps per MB. Design: one block of INTRA_THREADS threads walks the list;
// each MB's read rectangle sits in shared memory while its 16 block
// steps run (see intra_mb.cuh), so a step costs shared-memory latency and
// a barrier rather than a device-memory round trip. Used where the frame
// has at most WF_THRESH intra MBs, and for frames under 3 MBs wide.

#include <cuda_runtime.h>

#include "intra_mb.cuh"

__global__ void __launch_bounds__(INTRA_THREADS)
intra_list_kernel(IntraArgs a, const int32_t* ids, int n_ids) {
  __shared__ IntraSmem s;
  const int n_mbs = a.width_mbs * a.height_mbs;
  for (int k = 0; k < n_ids; ++k) {
    const int mb = ids[k];
    if (mb < 0 || mb >= n_mbs) continue;          // padding entries
    const int cls = a.mb_class[mb];
    if (cls != 3 && cls != 4) continue;
    intra_mb(a, mb, s);
  }
}

extern "C" int h264_intra_list(
    void* y, void* cb, void* cr, const void* mb_class, const void* i4_modes,
    const void* i4_avail, const void* mb_avail, const void* i16_mode,
    const void* chroma_mode, const void* resid_luma, const void* resid_chroma,
    const void* i4_weights, const void* ids, int n_ids, int width_mbs,
    int height_mbs, void* stream) {
  IntraArgs a{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr,
              (const int32_t*)mb_class, (const int32_t*)i4_modes,
              (const int32_t*)i4_avail, (const int32_t*)mb_avail,
              (const int32_t*)i16_mode, (const int32_t*)chroma_mode,
              (const int32_t*)resid_luma, (const int32_t*)resid_chroma,
              (const int32_t*)i4_weights, width_mbs, height_mbs};
  intra_list_kernel<<<1, INTRA_THREADS, 0, (cudaStream_t)stream>>>(
      a, (const int32_t*)ids, n_ids);
  return (int)cudaGetLastError();
}
