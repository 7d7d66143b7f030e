// Intra list kernel (K2): reconstructs the listed intra MBs with the
// result of walking the list in order (the front-end's list is in raster
// order), in one dependency-driven launch.
//
// Replaces the TPU kernel _intra_kernel of intra_pass_pallas
// (h264bsd_tpu/ops/pallas_intra.py:379), which keeps the planes in VMEM
// and walks the MBs as one sequential program.
//
// Bound: not the bytes (a 40x23-MB frame moves about 2 MB of planes,
// residuals and modes, under a microsecond at 3.35 TB/s) but the chain
// of dependent MBs: each predicts from its reconstructed neighbours, and
// inside an Intra_4x4 MB each of the 16 blocks from the blocks before it.
//
// Design. A pre-pass (intra_list_pos_kernel) writes pos[mb] = k for each
// listed entry k (0 <= ids[k] < nMB, class 3 or 4; the first entry where
// an MB repeats); every other MB keeps INT_MAX and is never waited on.
// The main kernel runs one block per list entry, each taking its entry
// k from a ticket counter (mb_sync.cuh). An MB's footprint -- it reads
// rows my-1..my+15 and columns mx-1..mx+19 and writes only itself --
// meets only its 8 neighbours, so the MB waits for the done flag of
// each of the 8 whose pos is below k; then for any list order without
// repeats the result is that of the serial walk. On the front-end's
// raster-ordered lists only the left, above-left, above and above-right
// neighbours are ever waited on, and independent MBs run at once: the
// critical path is the longest chain of listed neighbours (84 MBs on a
// 40x23 all-intra frame, a few on a P picture's scattered intra MBs)
// instead of the whole list. Before its wait a block stages the MB's
// own inputs and the weight table's taps into shared memory; after it,
// one L2 round trip copies the read rectangle (intra_mb_copy_rect), the
// 10 Intra_4x4 steps run on warp 0 in shared memory (intra_mb.cuh), and
// the MB is written back and its flag released. Used where the frame has at
// most WF_THRESH intra MBs, and for frames under 3 MBs wide.

#include <cuda_runtime.h>

#include "intra_mb.cuh"
#include "mb_sync.cuh"

#define POS_THREADS 256

__device__ __forceinline__ bool listed(const int32_t* mb_class, int mb,
                                       int n_mbs) {
  if (mb < 0 || mb >= n_mbs) return false;
  const int cls = mb_class[mb];
  return cls == 3 || cls == 4;
}

// pos[ids[k]] = the first k listing an intra MB (pos starts at INT_MAX)
__global__ void __launch_bounds__(POS_THREADS)
intra_list_pos_kernel(const int32_t* ids, int n_ids,
                      const int32_t* mb_class, int n_mbs, int* pos) {
  const int k = blockIdx.x * POS_THREADS + threadIdx.x;
  if (k >= n_ids) return;
  const int mb = ids[k];
  if (listed(mb_class, mb, n_mbs)) atomicMin(&pos[mb], k);
}

// the 8 neighbours (row, column offsets) whose footprints meet an MB's
__constant__ int kNeighbour[8][2] = {{0, -1}, {-1, -1}, {-1, 0}, {-1, 1},
                                     {0, 1},  {1, -1},  {1, 0},  {1, 1}};

// one block per list entry; sync = nMB done flags, then the ticket
__global__ void __launch_bounds__(INTRA_THREADS)
intra_list_kernel(IntraArgs a, const int32_t* ids, const int32_t* pos,
                  int* sync) {
  __shared__ int taps[I4_TAP_COUNT];
  __shared__ IntraStage st;
  __shared__ IntraRect rect;
  __shared__ int ticket;
  const int wm = a.width_mbs, hm = a.height_mbs, n_mbs = wm * hm;
  const int k = mb_take_ticket(sync + n_mbs, &ticket);
  const int mb = ids[k];
  // padding, a non-intra entry or a repeat: nothing waits on it
  if (!listed(a.mb_class, mb, n_mbs) || pos[mb] != k) return;
  intra_stage_taps(a, taps);
  intra_stage_inputs(a, mb, st);
  const int t = threadIdx.x;
  if (t < 8) {
    const int r = mb / wm + kNeighbour[t][0], c = mb % wm + kNeighbour[t][1];
    if (r >= 0 && r < hm && c >= 0 && c < wm && pos[r * wm + c] < k) {
      mb_wait(sync + r * wm + c);
    }
  }
  __syncthreads();
  intra_mb_copy_rect(a, mb, rect);
  __syncthreads();
  intra_mb_compute(a, mb, st, rect, taps);
  intra_mb_store(a, mb, rect);
  mb_signal(sync + mb);
}

extern "C" int h264_intra_list(
    void* y, void* cb, void* cr, const void* mb_class, const void* i4_modes,
    const void* i4_avail, const void* mb_avail, const void* i16_mode,
    const void* chroma_mode, const void* resid_luma, const void* resid_chroma,
    const void* i4_weights, const void* ids, void* pos, void* sync,
    int n_ids, int width_mbs, int height_mbs, void* stream) {
  IntraArgs a{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr,
              (const int32_t*)mb_class, (const int32_t*)i4_modes,
              (const int32_t*)i4_avail, (const int32_t*)mb_avail,
              (const int32_t*)i16_mode, (const int32_t*)chroma_mode,
              (const int32_t*)resid_luma, (const int32_t*)resid_chroma,
              (const int32_t*)i4_weights, width_mbs, height_mbs};
  const cudaStream_t st = (cudaStream_t)stream;
  intra_list_pos_kernel<<<(n_ids + POS_THREADS - 1) / POS_THREADS,
                          POS_THREADS, 0, st>>>(
      (const int32_t*)ids, n_ids, (const int32_t*)mb_class,
      width_mbs * height_mbs, (int*)pos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  intra_list_kernel<<<n_ids, INTRA_THREADS, 0, st>>>(
      a, (const int32_t*)ids, (const int32_t*)pos, (int*)sync);
  return (int)cudaGetLastError();
}
