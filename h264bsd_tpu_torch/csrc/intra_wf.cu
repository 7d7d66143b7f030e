// Intra wavefront kernel (K7): reconstructs every intra MB of the frame
// in one launch, one persistent thread block per MB row.
//
// Replaces the TPU kernel _intra_wf_kernel of intra_pass_wavefront_pallas
// (h264bsd_tpu/ops/pallas_intra_wf.py:600), which batches G MBs of one
// anti-diagonal per vector step.
//
// Schedule. A block takes its row r from a ticket counter (mb_sync.cuh),
// so row r is only taken once row r-1's block is running: no deadlock at
// any residency. Row r walks its MBs c = 0 .. wm-1 in order, and before
// MB c waits until row r-1's progress counter (its MBs done) reaches
// min(c+2, wm): the MB's left neighbour is its own previous step, and
// its above-left, above and above-right neighbours are done. That is the
// anti-diagonal rule t = 2r + c, and the result is the raster walk's.
// An MB that is not intra (inter, I_PCM, concealed) is skipped but still
// advances the counter. Row r-1 writes only its own MBs, which row r
// reads only in the row above it; row r+1 never writes what row r reads.
//
// Bound: not the bytes (a 720p frame's planes and residuals are 7 MB
// read and 1.4 MB written, about 2.5 us at 3.35 TB/s) but the chain of
// 2(hm-1)+wm dependent MB steps (168 at 720p, 254 at 1080p); each row
// hand-off is paid once per row, not once per MB. What the design does
// about the step:
// - the weight table is staged once per block, not once per MB;
// - the read rectangle slides right with the MB in shared memory (two
//   buffers, alternating): the left neighbour's column never leaves it;
//   the MB's own pels and the 4 columns right of it (which no other
//   block writes) and its inputs are loaded for MB c+1 before MB c's
//   wait, into registers;
// - of the row above only what the wait for MB c gates is loaded after
//   it: the above-right luma pels (columns x+16 .. x+19), and only for
//   an Intra_4x4 MB whose block 3 reads them. The rest of the row (luma
//   x-1 .. x+15, chroma cx-1 .. cx+7) lies in MBs that MB c-1's wait
//   already covered, and warp 0 loads it then;
// - the 16 Intra_4x4 blocks run in 10 steps of up to 2 blocks on warp 0
//   (intra_mb.cuh), chroma on threads 128..255 beside them.

#include <cuda_runtime.h>

#include "intra_mb.cuh"
#include "mb_sync.cuh"

// one MB's inputs and own pels in flight, one piece per thread
struct WfPrefetch {
  int res_l, res_c, mode, avail, cls, mb_avail, i16_mode, chroma_mode;
  uint32_t pels;                // 4 own (or right-hand) pels
};

// Start the loads of MB (r, c)'s inputs: every thread its residual pel
// and the class, threads 0-15 a mode and an availability, thread 0 the
// per-MB scalars; threads 0-79 a word of the luma rows y..y+15, columns
// x..x+19, threads 80-111 a word of the chroma rows. None of these is
// written by another block, and the MB itself is not written yet.
__device__ __forceinline__ WfPrefetch wf_prefetch(const IntraArgs& a, int r,
                                                  int c) {
  const int t = threadIdx.x;
  const int wm = a.width_mbs, mb = r * wm + c;
  const int W = 16 * wm, Wc = 8 * wm;
  WfPrefetch p{};
  p.res_l = a.resid_luma[mb * 256 + t];
  if (t < 128) p.res_c = a.resid_chroma[mb * 128 + t];
  if (t < 16) {
    p.mode = a.i4_modes[mb * 16 + t];
    p.avail = a.i4_avail[mb * 16 + t];
  }
  p.cls = a.mb_class[mb];
  if (t == 0) {
    p.mb_avail = a.mb_avail[mb];
    p.i16_mode = a.i16_mode[mb];
    p.chroma_mode = a.chroma_mode[mb];
  }
  if (t < 80) {
    const int row = t / 5, x = 16 * c + 4 * (t % 5);
    if (x < W) {
      p.pels = __ldcg(reinterpret_cast<const uint32_t*>(
          &a.y[(16 * r + row) * W + x]));
    }
  } else if (t < 112) {
    const int j = t - 80, row = (j >> 1) & 7;
    const uint8_t* plane = j >> 4 ? a.cr : a.cb;
    p.pels = __ldcg(reinterpret_cast<const uint32_t*>(
        &plane[(8 * r + row) * Wc + 8 * c + 4 * (j & 1)]));
  }
  return p;
}

// The prefetched MB (r, c) into shared memory: its inputs into st, its
// pels into rectangle R, and the left neighbour's last luma and chroma
// columns from the previous rectangle L. A barrier must follow.
__device__ __forceinline__ void wf_stage(const IntraArgs& a,
                                         const WfPrefetch& p, int c,
                                         IntraStage& st, IntraRect& R,
                                         const IntraRect& L) {
  const int t = threadIdx.x;
  st.res_l[t] = p.res_l;
  if (t < 128) st.res_c[t >> 6][t & 63] = p.res_c;
  if (t < 16) {
    st.modes[t] = clampi(p.mode, 0, 8);
    st.avail[t] = p.avail;
  }
  if (t == 0) {
    st.cls = p.cls;
    st.mb_avail = p.mb_avail;
    st.i16_mode = p.i16_mode;
    st.chroma_mode = p.chroma_mode;
  }
  if (t < 80) {
    const int row = t / 5, q = t % 5;
    if (16 * c + 4 * q < 16 * a.width_mbs) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        R.ly[1 + row][1 + 4 * q + b] = (p.pels >> (8 * b)) & 0xFF;
      }
    }
  } else if (t < 112) {
    const int j = t - 80, row = (j >> 1) & 7, q = j & 1;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      R.lc[j >> 4][1 + row][1 + 4 * q + b] = (p.pels >> (8 * b)) & 0xFF;
    }
  } else if (c > 0 && t >= 128 && t < 144) {
    R.ly[1 + t - 128][0] = L.ly[1 + t - 128][16];
  } else if (c > 0 && t >= 144 && t < 160) {
    const int j = t - 144;
    R.lc[j >> 3][1 + (j & 7)][0] = L.lc[j >> 3][1 + (j & 7)][8];
  }
}

// Row 0 of MB (r, c)'s rectangle, by warp 0 after the wait: the row
// above, luma columns x-1 .. x+19 (lanes 0-20) and chroma cx-1 .. cx+7
// (lanes 0-17), addresses clamped into the picture, L2-only loads. With
// `ahead` (the luma columns up to x+15 and the chroma row, which the
// previous MB's wait already covered, loaded then) only the above-right
// luma columns x+16 .. x+19 (lanes 17-20) are loaded, and only where the
// MB reads them: an Intra_4x4 MB whose block 3 has its above-right bit.
__device__ __forceinline__ void wf_load_above(const IntraArgs& a, int r, int c,
                                              const IntraStage& st, bool ahead,
                                              IntraRect& R) {
  const int l = threadIdx.x;
  const int W = 16 * a.width_mbs, Wc = W / 2;
  const bool luma = ahead ? (l >= 17 && l < 21 && st.cls == 3 &&
                             (st.avail[3] & 4))
                          : l < 21;
  const bool chroma = !ahead && l < 18;
  int v = 0, vc = 0;
  if (luma) {
    v = __ldcg(&a.y[(16 * r - 1) * W + clampi(16 * c - 1 + l, 0, W - 1)]);
  }
  if (chroma) {
    const uint8_t* plane = l < 9 ? a.cb : a.cr;
    vc = __ldcg(
        &plane[(8 * r - 1) * Wc + clampi(8 * c - 1 + l % 9, 0, Wc - 1)]);
  }
  if (luma) R.ly[0][l] = v;
  if (chroma) R.lc[l / 9][0][l % 9] = vc;
}

// one block per MB row; sync = hm progress counters, then the ticket
__global__ void __launch_bounds__(INTRA_THREADS)
intra_wf_kernel(IntraArgs a, int* sync) {
  __shared__ int taps[I4_TAP_COUNT];
  __shared__ IntraStage st;
  __shared__ IntraRect rect[2];
  __shared__ int ticket;
  const int wm = a.width_mbs, hm = a.height_mbs;
  const int W = 16 * wm, Wc = 8 * wm;
  const int r = mb_take_ticket(sync + hm, &ticket);
  const int t = threadIdx.x;
  intra_stage_taps(a, taps);
  WfPrefetch next = wf_prefetch(a, r, 0);
  // warp 0: the next MB's row above, loaded after this MB's wait
  bool ahead = false;
  int above = 0, above_c = 0;
  for (int c = 0; c < wm; ++c) {
    const int mb = r * wm + c;
    IntraRect& R = rect[c & 1];
    wf_stage(a, next, c, st, R, rect[(c + 1) & 1]);
    const bool intra = next.cls == 3 || next.cls == 4;
    if (c + 1 < wm) next = wf_prefetch(a, r, c + 1);   // overlaps the wait
    if (!intra) {
      ahead = false;
      mb_publish(sync + r, c + 1);
      continue;
    }
    if (r > 0 && t < 32) {
      if (ahead) {
        if (t < 17) R.ly[0][t] = above;
        if (t < 18) R.lc[t / 9][0][t % 9] = above_c;
      }
      if (t == 0) mb_wait_at_least(sync + r - 1, min(c + 2, wm));
      __syncwarp();
      wf_load_above(a, r, c, st, ahead, R);
      // row r-1 has done MBs c and c+1: the next MB's row above, luma
      // columns x+15 .. x+31 and chroma cx+7 .. cx+15
      ahead = c + 1 < wm;
      if (ahead) {
        if (t < 17) above = __ldcg(&a.y[(16 * r - 1) * W + 16 * c + 15 + t]);
        if (t < 18) {
          above_c = __ldcg(&(t < 9 ? a.cb : a.cr)[(8 * r - 1) * Wc + 8 * c +
                                                  7 + t % 9]);
        }
      }
    }
    __syncthreads();
    intra_mb_compute(a, mb, st, R, taps);
    intra_mb_store(a, mb, R);
    mb_publish(sync + r, c + 1);
  }
}

extern "C" int h264_intra_wavefront(
    void* y, void* cb, void* cr, const void* mb_class, const void* i4_modes,
    const void* i4_avail, const void* mb_avail, const void* i16_mode,
    const void* chroma_mode, const void* resid_luma, const void* resid_chroma,
    const void* i4_weights, void* sync, int width_mbs, int height_mbs,
    void* stream) {
  IntraArgs a{(uint8_t*)y, (uint8_t*)cb, (uint8_t*)cr,
              (const int32_t*)mb_class, (const int32_t*)i4_modes,
              (const int32_t*)i4_avail, (const int32_t*)mb_avail,
              (const int32_t*)i16_mode, (const int32_t*)chroma_mode,
              (const int32_t*)resid_luma, (const int32_t*)resid_chroma,
              (const int32_t*)i4_weights, width_mbs, height_mbs};
  intra_wf_kernel<<<height_mbs, INTRA_THREADS, 0, (cudaStream_t)stream>>>(
      a, (int*)sync);
  return (int)cudaGetLastError();
}
