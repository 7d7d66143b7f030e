// Motion-compensation kernels: the uniform kernel (K3+K4) and the
// exception kernel (K5+K6).
//
// mc_uniform_kernel replaces the TPU kernels _uniform_luma_kernel and
// _uniform_chroma_kernel (h264bsd_tpu/ops/pallas_mc.py:174, :226), and
// mc_exception_kernel the TPU kernels _exc_luma_kernel and
// _exc_chroma_kernel (:284, :306), all driven there by _run (:370) from
// mc_predict_grids (:409). Semantics are those of
// h264bsd_tpu_torch/ops/inter.py: the 6-tap half-pel luma filter with
// quarter-pel averages (reference h264bsdPredictSamples
// reconstruct.c:1818-1940, frac code xFrac*4 + yFrac), the 1/8-pel
// bilinear chroma filter, and border overfill as a clamp of every sample
// coordinate into the plane (h264bsdFillBlock reconstruct.c:2244).
//
// Layout: the DPB ring is read in place, (slots, H, W) luma and
// (slots, H/2, W/2) chroma uint8, each block from its own slot
// max(ref_slot, 0), so 1 to 16 references are one pass. The TPU version
// edge-pads every referenced slot per frame because a VMEM window load
// cannot clamp, and runs one pass per group of 4 slots that fit VMEM;
// neither has a counterpart here. Outputs are the MB grids (nMB, 16, 16)
// and (nMB, 8, 8) uint8; the exception kernel writes its quads over the
// uniform kernel's result, after it on the same stream.
//
// Bound: the operations. A 1080p frame's uniform pass reads one
// reference pel per predicted pel (3 MB; neighbouring MBs' windows overlap
// and come mostly from L2) and writes 3 MB, ~2 us at 3.35 TB/s, while its
// filters cost ~14 int32 operations per pel for a half-pel case and ~90
// for the centre ones, several us at Hopper's int32 rate. Design:
// one thread block per MB (per quad for exceptions); the windows are staged in
// shared memory with clamped coordinates, then each thread computes one
// output pel of the one fractional case the block needs. The case is
// uniform across a block (a quad's four blocks each have their own, one
// per 16 threads), so the branch on it does not diverge inside a
// half-warp. The TPU version computes all 16 cases and selects per lane.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kLumaWin = 21;   // 16 + 5 taps
constexpr int kChromaWin = 9;  // 8 + 1
constexpr int kBlkWin = 9;     // 4 + 5
constexpr int kBlkCWin = 3;    // 2 + 1

struct McArgs {
  const uint8_t* dpb_y;       // (n_slots, H, W)
  const uint8_t* dpb_cb;      // (n_slots, H/2, W/2)
  const uint8_t* dpb_cr;
  const int32_t* mv;          // (nMB, 16, 2) quarter-pel, raster blocks
  const int32_t* ref_slot;    // (nMB, 16)
  uint8_t* pred_y;            // (nMB, 16, 16)
  uint8_t* pred_cb;           // (nMB, 8, 8)
  uint8_t* pred_cr;
  int n_slots;
  int width_mbs;
  int height_mbs;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int clip8(int v) { return clampi(v, 0, 255); }

__device__ __forceinline__ int tap6(int p0, int p1, int p2, int p3, int p4,
                                    int p5) {
  return p0 - 5 * p1 + 20 * p2 + 20 * p3 - 5 * p4 + p5;
}

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

// unclipped horizontal 6-tap over p[r][0..5] (half position between
// columns 2 and 3)
__device__ __forceinline__ int hor(const uint8_t* p, int s, int r) {
  const uint8_t* q = p + r * s;
  return tap6(q[0], q[1], q[2], q[3], q[4], q[5]);
}

// unclipped vertical 6-tap over p[0..5][c]
__device__ __forceinline__ int ver(const uint8_t* p, int s, int c) {
  return tap6(p[c], p[s + c], p[2 * s + c], p[3 * s + c], p[4 * s + c],
              p[5 * s + c]);
}

// One predicted luma pel. p points at the pel's window origin: p[2*s+2]
// is its integer sample, rows and columns -2..+3 around it are read.
// frac = xFrac*4 + yFrac (ops/inter.py luma_predict_blocks).
__device__ int luma_pel(const uint8_t* p, int s, int frac) {
  const int g = p[2 * s + 2];
  if (frac == 0) return g;
  const int x_frac = frac >> 2, y_frac = frac & 3;
  if (y_frac == 0) {                               // a, b, c
    const int b0 = clip8((hor(p, s, 2) + 16) >> 5);
    if (x_frac == 2) return b0;
    return avg(x_frac == 1 ? g : p[2 * s + 3], b0);
  }
  if (x_frac == 0) {                               // d, h, n
    const int h0 = clip8((ver(p, s, 2) + 16) >> 5);
    if (y_frac == 2) return h0;
    return avg(y_frac == 1 ? g : p[3 * s + 2], h0);
  }
  if (x_frac != 2 && y_frac != 2) {                // e, g, p, r
    const int b = clip8((hor(p, s, y_frac == 1 ? 2 : 3) + 16) >> 5);
    const int h = clip8((ver(p, s, x_frac == 1 ? 2 : 3) + 16) >> 5);
    return avg(b, h);
  }
  // the centre j from the unclipped horizontal intermediates of rows
  // 0..5, then i, f, k, q average it with a half-pel neighbour
  const int j = clip8((tap6(hor(p, s, 0), hor(p, s, 1), hor(p, s, 2),
                            hor(p, s, 3), hor(p, s, 4), hor(p, s, 5)) +
                       512) >> 10);
  if (frac == 10) return j;
  if (x_frac == 2)                                 // f, q
    return avg(clip8((hor(p, s, y_frac == 1 ? 2 : 3) + 16) >> 5), j);
  return avg(clip8((ver(p, s, x_frac == 1 ? 2 : 3) + 16) >> 5), j);  // i, k
}

// One predicted chroma pel from the 2x2 at p (row pitch s).
__device__ __forceinline__ int chroma_pel(const uint8_t* p, int s, int xf,
                                          int yf) {
  return ((8 - xf) * (8 - yf) * p[0] + xf * (8 - yf) * p[1] +
          (8 - xf) * yf * p[s] + xf * yf * p[s + 1] + 32) >> 6;
}

__device__ __forceinline__ int slot_of(const McArgs& a, int r) {
  return clampi(r, 0, a.n_slots - 1);
}

// Copy the rows x cols window of `plane` (h x w, slot-strided) whose
// top-left sample is (y0, x0) into dst, clamping every coordinate.
__device__ __forceinline__ void load_window(uint8_t* dst, const uint8_t* plane,
                                            int h, int w, int y0, int x0,
                                            int rows, int cols, int t,
                                            int nt) {
  for (int i = t; i < rows * cols; i += nt) {
    const int r = i / cols, c = i - r * cols;
    dst[i] = plane[clampi(y0 + r, 0, h - 1) * w + clampi(x0 + c, 0, w - 1)];
  }
}

// K3+K4: one block of 256 threads per MB, with block 0's MV and slot.
__global__ void __launch_bounds__(256) mc_uniform_kernel(McArgs a) {
  __shared__ uint8_t wy[kLumaWin * kLumaWin];
  __shared__ uint8_t wc[2][kChromaWin * kChromaWin];
  const int mb = blockIdx.x;
  const int t = threadIdx.x;
  const int H = 16 * a.height_mbs, W = 16 * a.width_mbs;
  const int Hc = H / 2, Wc = W / 2;
  const int mvx = a.mv[mb * 32 + 0], mvy = a.mv[mb * 32 + 1];
  const int slot = slot_of(a, a.ref_slot[mb * 16]);
  const int x16 = (mb % a.width_mbs) * 16, y16 = (mb / a.width_mbs) * 16;

  load_window(wy, a.dpb_y + (size_t)slot * H * W, H, W, y16 + (mvy >> 2) - 2,
              x16 + (mvx >> 2) - 2, kLumaWin, kLumaWin, t, 256);
  const int cy0 = (y16 >> 1) + (mvy >> 3), cx0 = (x16 >> 1) + (mvx >> 3);
  if (t < 128) {
    load_window(wc[0], a.dpb_cb + (size_t)slot * Hc * Wc, Hc, Wc, cy0, cx0,
                kChromaWin, kChromaWin, t, 128);
  } else {
    load_window(wc[1], a.dpb_cr + (size_t)slot * Hc * Wc, Hc, Wc, cy0, cx0,
                kChromaWin, kChromaWin, t - 128, 128);
  }
  __syncthreads();

  const int py = t >> 4, px = t & 15;
  const int frac = (mvx & 3) * 4 + (mvy & 3);
  a.pred_y[mb * 256 + t] = (uint8_t)luma_pel(wy + py * kLumaWin + px,
                                             kLumaWin, frac);
  if (t < 128) {
    const int pl = t >> 6, i = t & 63, cy = i >> 3, cx = i & 7;
    uint8_t* out = pl ? a.pred_cr : a.pred_cb;
    out[mb * 64 + i] = (uint8_t)chroma_pel(wc[pl] + cy * kChromaWin + cx,
                                           kChromaWin, mvx & 7, mvy & 7);
  }
}

// K5+K6: one block of 64 threads per exception entry mb*4 + q, the four
// 4x4 blocks of quadrant q, each with its own MV and slot; 16 threads per
// block. Entries >= nMB*4 are padding and return at once.
__global__ void __launch_bounds__(64) mc_exception_kernel(
    McArgs a, const int32_t* exc_ids) {
  __shared__ uint8_t wy[4][kBlkWin * kBlkWin];
  __shared__ uint8_t wc[4][2][kBlkCWin * kBlkCWin];
  const int n_mbs = a.width_mbs * a.height_mbs;
  const int id = exc_ids[blockIdx.x];
  if (id < 0 || id >= n_mbs * 4) return;
  const int mb = id >> 2, q = id & 3;
  const int t = threadIdx.x;
  const int j = t >> 4, i = t & 15;                 // block of the quad, pel
  // raster block of quad position j: quads {0,1,4,5} {2,3,6,7} ...
  const int b = (q >> 1) * 8 + (q & 1) * 2 + (j >> 1) * 4 + (j & 1);
  const int H = 16 * a.height_mbs, W = 16 * a.width_mbs;
  const int Hc = H / 2, Wc = W / 2;
  const int mvx = a.mv[(mb * 16 + b) * 2 + 0];
  const int mvy = a.mv[(mb * 16 + b) * 2 + 1];
  const int slot = slot_of(a, a.ref_slot[mb * 16 + b]);
  const int bx = (mb % a.width_mbs) * 16 + (b & 3) * 4;
  const int by = (mb / a.width_mbs) * 16 + (b >> 2) * 4;

  // each 16-thread group stages its own block's windows
  load_window(wy[j], a.dpb_y + (size_t)slot * H * W, H, W,
              by + (mvy >> 2) - 2, bx + (mvx >> 2) - 2, kBlkWin, kBlkWin, i,
              16);
  const int cy0 = (by >> 1) + (mvy >> 3), cx0 = (bx >> 1) + (mvx >> 3);
  if (i < 9) {
    const size_t off = (size_t)slot * Hc * Wc;
    const int r = i / 3, c = i - r * 3;
    const int yy = clampi(cy0 + r, 0, Hc - 1), xx = clampi(cx0 + c, 0, Wc - 1);
    wc[j][0][i] = a.dpb_cb[off + yy * Wc + xx];
    wc[j][1][i] = a.dpb_cr[off + yy * Wc + xx];
  }
  __syncthreads();

  const int py = i >> 2, px = i & 3;
  const int frac = (mvx & 3) * 4 + (mvy & 3);
  a.pred_y[mb * 256 + ((b >> 2) * 4 + py) * 16 + (b & 3) * 4 + px] =
      (uint8_t)luma_pel(wy[j] + py * kBlkWin + px, kBlkWin, frac);
  if (i < 8) {
    const int pl = i >> 2, k = i & 3, cy = k >> 1, cx = k & 1;
    uint8_t* out = pl ? a.pred_cr : a.pred_cb;
    out[mb * 64 + ((b >> 2) * 2 + cy) * 8 + (b & 3) * 2 + cx] =
        (uint8_t)chroma_pel(wc[j][pl] + cy * kBlkCWin + cx, kBlkCWin,
                            mvx & 7, mvy & 7);
  }
}

static McArgs make_args(const void* dpb_y, const void* dpb_cb, const void* dpb_cr,
                 const void* mv, const void* ref_slot, void* pred_y,
                 void* pred_cb, void* pred_cr, int n_slots, int width_mbs,
                 int height_mbs) {
  return McArgs{(const uint8_t*)dpb_y, (const uint8_t*)dpb_cb,
                (const uint8_t*)dpb_cr, (const int32_t*)mv,
                (const int32_t*)ref_slot, (uint8_t*)pred_y,
                (uint8_t*)pred_cb, (uint8_t*)pred_cr, n_slots, width_mbs,
                height_mbs};
}

extern "C" int h264_mc_uniform(const void* dpb_y, const void* dpb_cb,
                               const void* dpb_cr, const void* mv,
                               const void* ref_slot, void* pred_y,
                               void* pred_cb, void* pred_cr, int n_slots,
                               int width_mbs, int height_mbs, void* stream) {
  mc_uniform_kernel<<<width_mbs * height_mbs, 256, 0,
                      (cudaStream_t)stream>>>(
      make_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, pred_y, pred_cb, pred_cr,
                n_slots, width_mbs, height_mbs));
  return (int)cudaGetLastError();
}

extern "C" int h264_mc_exception(const void* dpb_y, const void* dpb_cb,
                                 const void* dpb_cr, const void* mv,
                                 const void* ref_slot, void* pred_y,
                                 void* pred_cb, void* pred_cr,
                                 const void* exc_ids, int n_exc, int n_slots,
                                 int width_mbs, int height_mbs,
                                 void* stream) {
  mc_exception_kernel<<<n_exc, 64, 0, (cudaStream_t)stream>>>(
      make_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, pred_y, pred_cb, pred_cr,
                n_slots, width_mbs, height_mbs),
      (const int32_t*)exc_ids);
  return (int)cudaGetLastError();
}
