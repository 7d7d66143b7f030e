// Motion compensation of a P picture, and the inter reconstruction it
// feeds.
//
// mc_recon_kernel is the main path's motion-compensation stage: one launch
// per picture. It replaces the TPU kernels _uniform_luma_kernel and
// _uniform_chroma_kernel (K3+K4, h264bsd_tpu/ops/pallas_mc.py:174, :226)
// and _exc_luma_kernel and _exc_chroma_kernel (K5+K6, :284, :306), which
// _run (:370) drives from mc_predict_grids (:409). It also takes in the
// JAX package's inter combine, PCM merge and plane layout
// (h264bsd_tpu/ops/reconstruct.py:168-218), an XLA elementwise pass, not
// a Pallas kernel. Per MB it writes clip(pred + res, 0, 255) for an inter
// MB (mb_class 1 or 2), the raw samples of an I_PCM MB (class 5) when PCM
// grids are given, and 0 for every other MB, straight into the (H, W) and
// (H/2, W/2) planes that the intra pass then completes.
//
// Semantics are those of h264bsd_tpu_torch/ops/inter.py: the 6-tap
// half-pel luma filter with quarter-pel averages (reference
// h264bsdPredictSamples reconstruct.c:1818-1940, frac code xFrac*4 +
// yFrac), the 1/8-pel bilinear chroma filter, and border overfill as a
// clamp of every sample coordinate into the plane (h264bsdFillBlock
// reconstruct.c:2244). Each 4x4 block is predicted with its own MV and
// slot from the dense per-block motion of unpack_meta. The front-end lists
// a quad as an exception exactly when one of its blocks differs from block
// 0, so this gives the bytes of the uniform pass plus the exception quads,
// and needs no exception list.
//
// Bound: the bytes, at the shapes of the main path. Per inter MB the
// kernel reads 384 ring pels (neighbouring windows overlap and come from
// L2) and 1536 bytes of int32 residual, and writes 384 plane bytes; every
// other MB only writes (or copies) its 384 bytes. The filters cost ~14 to
// ~50 int32 operations per pel (the centre cases, computed separably),
// under the bytes' time at 1080p. Design: one block of 96 threads per MB;
// warps 0-1 own the 256 luma pels, warp 2 the 2 x 64 chroma pels, 4
// horizontally adjacent pels per thread, so the residual is one 16-byte
// load and the result one 4-byte store into the plane row. A non-inter MB
// writes and returns at once, without touching the ring. An inter MB whose
// 16 blocks share block 0's MV and slot stages one 21x21 luma and two 9x9
// chroma windows; any other MB stages a 9x9 and two 3x3 windows per 4x4
// block (the branch is per MB, so a warp never splits on it). A window
// whose columns, rounded out to whole words, lie inside the plane is
// staged as aligned 16-, 8- or 4-byte words with the column offset kept in
// the index; only windows that cross the frame's edge go pel by pel with
// clamped coordinates. An integer MV (frac 0, chroma weight (0, 0)) reads
// its samples from the ring directly, without a window. For the five
// fractional cases that need the centre j, the unclipped horizontal 6-tap
// sums of the window's rows are computed once into shared memory
// (int16: -2550..10710) and the vertical tap runs over them.
//
// Row-sharded decode (h264bsd_tpu_torch/parallel/rowshard.py) predicts a
// stripe of height_mbs MB rows at MB row mb_row_offset of whole reference
// frames ref_h pels tall: every kernel here takes both, as the TPU kernels
// take mb_row_offset (pallas_mc.py:411); an MB's reference position is
// its stripe row plus the offset, its output position its stripe row, and
// the coordinate clamp is against the reference planes. The main path
// passes offset 0 and ref_h = 16 * height_mbs.
//
// mc_recon_kernel (C entry h264_mc_recon) takes a whole frame, with
// offset 0 and the frame's own height folded in; mc_recon_stripe_kernel
// (h264_mc_recon_stripe), the same code, takes a stripe.
//
// mc_uniform_kernel and mc_exception_kernel are the same prediction with
// the TPU kernels' own signature (grids (nMB, 16, 16) and (nMB, 8, 8),
// exception quads over the uniform result); no decode calls them. They
// read the DPB ring in place, each block from its own slot max(ref_slot,
// 0), so 1 to 16 references are one pass; the TPU version edge-pads every
// referenced slot per frame because a VMEM window load cannot clamp, and
// runs one pass per group of 4 slots that fit VMEM. One thread block per
// MB (per quad for exceptions) stages its windows pel by pel with clamped
// coordinates, then each thread computes one output pel.

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
  int height_mbs;    // of the grids
  int ref_h;         // luma rows of a reference plane
  int mb_row_offset; // the grids' first MB row in the reference frame
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
// frac = xFrac*4 + yFrac (ops/inter.py luma_predict_blocks). The centre
// j is the vertical tap over the unclipped horizontal sums of rows 0..5:
// from hs (hs[i*hp], computed once per window) when it is given, else
// computed here.
__device__ __forceinline__ int luma_pel(const uint8_t* p, int s, int frac,
                                        const int16_t* hs = nullptr,
                                        int hp = 0) {
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
  // the centre j, then i, f, k, q average it with a half-pel neighbour
  int hr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) hr[i] = hs ? hs[i * hp] : hor(p, s, i);
  const int j = clip8((tap6(hr[0], hr[1], hr[2], hr[3], hr[4], hr[5]) +
                       512) >> 10);
  if (frac == 10) return j;
  if (x_frac == 2)                                 // f, q
    return avg(clip8((hr[y_frac == 1 ? 2 : 3] + 16) >> 5), j);
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
  const int H = a.ref_h, W = 16 * a.width_mbs;
  const int Hc = H / 2, Wc = W / 2;
  const int mvx = a.mv[mb * 32 + 0], mvy = a.mv[mb * 32 + 1];
  const int slot = slot_of(a, a.ref_slot[mb * 16]);
  const int x16 = (mb % a.width_mbs) * 16;
  const int y16 = (mb / a.width_mbs + a.mb_row_offset) * 16;

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
  const int H = a.ref_h, W = 16 * a.width_mbs;
  const int Hc = H / 2, Wc = W / 2;
  const int mvx = a.mv[(mb * 16 + b) * 2 + 0];
  const int mvy = a.mv[(mb * 16 + b) * 2 + 1];
  const int slot = slot_of(a, a.ref_slot[mb * 16 + b]);
  const int bx = (mb % a.width_mbs) * 16 + (b & 3) * 4;
  const int by = (mb / a.width_mbs + a.mb_row_offset) * 16 + (b >> 2) * 4;

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
                 int height_mbs, int ref_h, int mb_row_offset) {
  return McArgs{(const uint8_t*)dpb_y, (const uint8_t*)dpb_cb,
                (const uint8_t*)dpb_cr, (const int32_t*)mv,
                (const int32_t*)ref_slot, (uint8_t*)pred_y,
                (uint8_t*)pred_cb, (uint8_t*)pred_cr, n_slots, width_mbs,
                height_mbs, ref_h, mb_row_offset};
}

extern "C" int h264_mc_uniform(const void* dpb_y, const void* dpb_cb,
                               const void* dpb_cr, const void* mv,
                               const void* ref_slot, void* pred_y,
                               void* pred_cb, void* pred_cr, int n_slots,
                               int width_mbs, int height_mbs, int ref_h,
                               int mb_row_offset, void* stream) {
  mc_uniform_kernel<<<width_mbs * height_mbs, 256, 0,
                      (cudaStream_t)stream>>>(
      make_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, pred_y, pred_cb, pred_cr,
                n_slots, width_mbs, height_mbs, ref_h, mb_row_offset));
  return (int)cudaGetLastError();
}

extern "C" int h264_mc_exception(const void* dpb_y, const void* dpb_cb,
                                 const void* dpb_cr, const void* mv,
                                 const void* ref_slot, void* pred_y,
                                 void* pred_cb, void* pred_cr,
                                 const void* exc_ids, int n_exc, int n_slots,
                                 int width_mbs, int height_mbs, int ref_h,
                                 int mb_row_offset, void* stream) {
  mc_exception_kernel<<<n_exc, 64, 0, (cudaStream_t)stream>>>(
      make_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, pred_y, pred_cb, pred_cr,
                n_slots, width_mbs, height_mbs, ref_h, mb_row_offset),
      (const int32_t*)exc_ids);
  return (int)cudaGetLastError();
}

// ---- mc_recon_kernel: the main path's MC stage --------------------------

constexpr int kReconThreads = 96;   // warps 0-1 luma, warp 2 Cb and Cr
// shared memory, by path: a uniform MB's 21x21 luma window (row pitch 48),
// its horizontal sums (21 x 16 int16) and two 9x9 chroma windows (pitch
// 32); or a split MB's sixteen 9x9 luma windows (pitch 32), their sums (9
// x 4 int16 each) and 2 x 16 3x3 chroma windows (pitch 8)
constexpr int kUniY = 0, kUniHs = kUniY + 21 * 48, kUniC = kUniHs + 21 * 16 * 2;
constexpr int kBlkY = 0, kBlkHs = kBlkY + 16 * 9 * 32, kBlkC = kBlkHs + 16 * 9 * 4 * 2;
constexpr int kReconSmem = kBlkC + 32 * 3 * 8;
static_assert(kUniC + 2 * 9 * 32 <= kReconSmem, "uniform path fits");
static_assert(kUniHs % 16 == 0 && kUniC % 16 == 0 && kBlkHs % 16 == 0 &&
              kBlkC % 16 == 0, "16-byte aligned windows");

struct ReconArgs {
  const uint8_t* dpb_y;       // (n_slots, H, W)
  const uint8_t* dpb_cb;      // (n_slots, H/2, W/2)
  const uint8_t* dpb_cr;
  const uint32_t* mv;         // (nMB, 16) int16 pairs (x low, y high)
  const int8_t* ref_slot;     // (nMB, 16)
  const uint8_t* mb_class;    // (nMB,)
  const int32_t* res_l;       // (nMB, 16, 16)
  const int32_t* res_c;       // (nMB, 2, 8, 8)
  const uint8_t* pcm_y;       // (nMB, 16, 16), or null: no I_PCM samples
  const uint8_t* pcm_cb;      // (nMB, 8, 8)
  const uint8_t* pcm_cr;
  uint8_t* y;                 // (H, W), H = 16 * height_mbs
  uint8_t* cb;                // (H/2, W/2)
  uint8_t* cr;
  int n_slots;
  int width_mbs;
  int height_mbs;
};

struct Motion {
  int x, y, slot;   // quarter-pel MV, DPB slot clamped into the ring
};

__device__ __forceinline__ Motion unpack_motion(uint32_t w, int slot) {
  return Motion{(int)(int16_t)(w & 0xFFFF), (int)(int16_t)(w >> 16), slot};
}

__device__ __forceinline__ bool needs_j(int frac) {
  const int xf = frac >> 2, yf = frac & 3;
  return xf && yf && (xf == 2 || yf == 2);
}

// A ROWS x COLS window of a plane (one slot, h x w pels), staged into
// shared memory. When its columns, rounded out to NW whole Words from xa =
// x0 rounded down, lie inside the plane, its rows go as aligned Words and
// the window starts at column x0 - xa of the staged rows (offset());
// otherwise pel by pel with clamped columns, from column 0 (offset() -1).
// Rows are clamped into the plane either way.
template <typename Word, int ROWS, int COLS>
struct Window {
  static constexpr int B = sizeof(Word);
  static constexpr int NW = (COLS + 2 * B - 2) / B;

  __device__ static __forceinline__ int offset(int x0, int w) {
    const int xa = x0 & ~(B - 1);
    return (xa >= 0 && xa + NW * B <= w) ? x0 - xa : -1;
  }

  __device__ static __forceinline__ int staged_offset(int x0, int w) {
    return max(offset(x0, w), 0);
  }

  // Thread t of NT stages the window whose top-left sample is (y0, x0)
  // into dst (row pitch `pitch`): all its loads are issued before any of
  // its stores, so a thread waits for one memory round trip, however many
  // words or pels it moves. Returns the staged offset.
  template <int NT>
  __device__ static __forceinline__ int stage(uint8_t* dst, int pitch,
                                              const uint8_t* plane, int h,
                                              int w, int y0, int x0, int t) {
    const int off = offset(x0, w);
    if (off >= 0) {
      constexpr int N = (ROWS * NW + NT - 1) / NT;
      const uint8_t* base = plane + (x0 - off);
      Word v[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = t + j * NT;
        if (i < ROWS * NW)
          v[j] = reinterpret_cast<const Word*>(
              base + (size_t)clampi(y0 + i / NW, 0, h - 1) * w)[i % NW];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = t + j * NT;
        if (i < ROWS * NW)
          reinterpret_cast<Word*>(dst + (i / NW) * pitch)[i % NW] = v[j];
      }
      return off;
    }
    constexpr int N = (ROWS * COLS + NT - 1) / NT;
    uint8_t v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = t + j * NT;
      if (i < ROWS * COLS)
        v[j] = plane[(size_t)clampi(y0 + i / COLS, 0, h - 1) * w +
                     clampi(x0 + i % COLS, 0, w - 1)];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = t + j * NT;
      if (i < ROWS * COLS) dst[(i / COLS) * pitch + i % COLS] = v[j];
    }
    return 0;
  }
};

// the windows: a uniform MB's luma (row pitch 48) and chroma (pitch 32),
// a split MB's per-block luma (pitch 32) and chroma (pitch 8)
using UniLuma = Window<uint4, 21, 21>;
using UniChroma = Window<uint2, 9, 9>;
using BlkLuma = Window<uint4, 9, 9>;
using BlkChroma = Window<uint32_t, 3, 3>;
static_assert(UniLuma::NW * 16 <= 48 && UniChroma::NW * 8 <= 32 &&
              BlkLuma::NW * 16 <= 32 && BlkChroma::NW * 4 <= 8,
              "staged rows fit their pitch");

// row[x..x+3] of a plane row w pels wide, each column clamped into it: as
// aligned words and a funnel shift when all four lie inside (w is a
// multiple of 8, so the second word does too).
__device__ __forceinline__ void direct4(const uint8_t* row, int x, int w,
                                        int out[4]) {
  if (x >= 0 && x + 4 <= w) {
    const int xa = x & ~3, sh = x & 3;
    const uint32_t lo = *reinterpret_cast<const uint32_t*>(row + xa);
    const uint32_t hi =
        sh ? *reinterpret_cast<const uint32_t*>(row + xa + 4) : lo;
    const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = (v >> (8 * k)) & 0xFF;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = row[clampi(x + k, 0, w - 1)];
  }
}

// One block per MB. Thread t owns 4 horizontally adjacent pels: luma row
// t/4, columns 4*(t%4).. for t < 64; for t >= 64, u = t - 64, row (u/2)%8,
// columns 4*(u%2).. of Cb (u < 16) or Cr. kStripe: the planes are a
// stripe at MB row mb_row_offset of reference frames ref_h rows tall
// (mc_recon_stripe_kernel); else the whole frame (mc_recon_kernel, the
// main path). The two stay apart because the offset costs the main path:
// with it the kernel takes 80 registers a thread instead of 72, so 8
// blocks fit an SM instead of 9, and this latency-bound kernel took 9%
// longer on the 1080p case.
template <bool kStripe>
__device__ __forceinline__ void mc_recon_mb(const ReconArgs a, int ref_h,
                                            int mb_row_offset) {
  __shared__ __align__(16) uint8_t smem[kReconSmem];
  const int mb = blockIdx.x, t = threadIdx.x;
  // H, Hc: the reference planes' rows; y16: the MB's row in the reference
  // frame, out16 in the output planes
  const int W = 16 * a.width_mbs, H = kStripe ? ref_h : 16 * a.height_mbs;
  const int Wc = W / 2, Hc = H / 2;
  const int x16 = (mb % a.width_mbs) * 16;
  const int out16 = (mb / a.width_mbs) * 16;
  const int y16 = kStripe ? out16 + 16 * mb_row_offset : out16;
  const bool luma = t < 64;
  const int u = luma ? t : t - 64;
  const int pl = luma ? 0 : 1 + (u >> 4);            // 0 Y, 1 Cb, 2 Cr
  const int r = luma ? u >> 2 : (u >> 1) & 7;
  const int c0 = luma ? (u & 3) * 4 : (u & 1) * 4;
  const int pw = luma ? W : Wc, ph = luma ? H : Hc;
  uint8_t* out_plane = pl == 0 ? a.y : (pl == 1 ? a.cb : a.cr);
  uint32_t* out = reinterpret_cast<uint32_t*>(
      out_plane + (size_t)((luma ? out16 : out16 / 2) + r) * pw +
      (luma ? x16 : x16 / 2) + c0);

  // the MB's class and motion in one round trip (lanes 0-15 and 16-31 of
  // each warp read blocks 0-15)
  const int lane = t & 31;
  const int cls = a.mb_class[mb];
  const uint32_t mw = a.mv[mb * 16 + (lane & 15)];
  const int ref = clampi(a.ref_slot[mb * 16 + (lane & 15)], 0, a.n_slots - 1);
  // cheap MBs first: 0, or the I_PCM samples, without touching the ring
  if (cls != 1 && cls != 2) {
    uint32_t v = 0;
    if (cls == 5 && a.pcm_y != nullptr) {
      const uint8_t* src =
          luma ? a.pcm_y + mb * 256 + r * 16 + c0
               : (pl == 1 ? a.pcm_cb : a.pcm_cr) + mb * 64 + r * 8 + c0;
      v = *reinterpret_cast<const uint32_t*>(src);
    }
    *out = v;
    return;
  }
  const int4 res = *reinterpret_cast<const int4*>(
      luma ? a.res_l + mb * 256 + r * 16 + c0
           : a.res_c + mb * 128 + (pl - 1) * 64 + r * 8 + c0);
  const uint8_t* ring = pl == 0 ? a.dpb_y : (pl == 1 ? a.dpb_cb : a.dpb_cr);
  const size_t slot_pels = (size_t)ph * pw;

  // uniform: all 16 blocks carry block 0's MV and slot (each warp decides
  // alike); a block's motion comes from the lane that loaded it
  const unsigned full = 0xFFFFFFFFu;
  const uint32_t mw0 = __shfl_sync(full, mw, 0);
  const int ref0 = __shfl_sync(full, ref, 0);
  const bool uniform = __all_sync(full, mw == mw0 && ref == ref0);
  auto motion_of = [&](int b) {
    return unpack_motion(__shfl_sync(full, mw, b), __shfl_sync(full, ref, b));
  };

  int pred[4];
  if (uniform) {
    const Motion m = motion_of(0);
    const int frac = (m.x & 3) * 4 + (m.y & 3);
    const int xf = m.x & 7, yf = m.y & 7;
    const uint8_t* base = ring + m.slot * slot_pels;
    uint8_t* wy = smem + kUniY;
    int16_t* hs = reinterpret_cast<int16_t*>(smem + kUniHs);
    uint8_t* wc = smem + kUniC + (pl - 1) * 9 * 32;
    const int ly0 = y16 + (m.y >> 2) - 2, lx0 = x16 + (m.x >> 2) - 2;
    const int cy0 = y16 / 2 + (m.y >> 3), cx0 = x16 / 2 + (m.x >> 3);
    int off = 0;
    if (luma && frac)
      off = UniLuma::stage<64>(wy, 48, base, H, W, ly0, lx0, t);
    if (!luma && (xf | yf))
      off = UniChroma::stage<16>(wc, 32, base, Hc, Wc, cy0, cx0, u & 15);
    __syncthreads();
    if (luma && needs_j(frac))
      for (int i = t; i < 21 * 16; i += 64)
        hs[i] = (int16_t)hor(wy + (i >> 4) * 48 + off + (i & 15), 48, 0);
    __syncthreads();
    if (luma) {
      if (frac == 0) {
        direct4(base + (size_t)clampi(y16 + r + (m.y >> 2), 0, H - 1) * W,
                x16 + c0 + (m.x >> 2), W, pred);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pred[k] = luma_pel(wy + r * 48 + off + c0 + k, 48, frac,
                             hs + r * 16 + c0 + k, 16);
      }
    } else if (!(xf | yf)) {
      direct4(base + (size_t)clampi(cy0 + r, 0, Hc - 1) * Wc, cx0 + c0, Wc,
              pred);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pred[k] = chroma_pel(wc + r * 32 + off + c0 + k, 32, xf, yf);
    }
  } else {
    // per 4x4 block: a 9x9 luma window (4 threads each) unless its MV is
    // integer, and two 3x3 chroma windows (one thread each)
    uint8_t* wb = smem + kBlkY;
    int16_t* hb = reinterpret_cast<int16_t*>(smem + kBlkHs);
    uint8_t* cw = smem + kBlkC;
    {
      const int b = luma ? t >> 2 : u & 15;
      const Motion m = motion_of(b);
      const int bx = x16 + (b & 3) * 4, by = y16 + (b >> 2) * 4;
      const uint8_t* base = ring + m.slot * slot_pels;
      const int frac = (m.x & 3) * 4 + (m.y & 3);
      const int lx0 = bx + (m.x >> 2) - 2;
      int off = 0;
      if (luma && frac)
        off = BlkLuma::stage<4>(wb + b * 288, 32, base, H, W,
                                by + (m.y >> 2) - 2, lx0, t & 3);
      if (!luma)
        BlkChroma::stage<1>(cw + u * 24, 8, base, Hc, Wc,
                            (by >> 1) + (m.y >> 3), (bx >> 1) + (m.x >> 3),
                            0);
      __syncthreads();
      if (luma && needs_j(frac))
        for (int i = t & 3; i < 36; i += 4)
          hb[b * 36 + i] = (int16_t)hor(
              wb + b * 288 + (i >> 2) * 32 + off + (i & 3), 32, 0);
      __syncthreads();
    }
    if (luma) {
      const int b = (r >> 2) * 4 + (c0 >> 2), rr = r & 3;
      const Motion m = motion_of(b);
      const int bx = x16 + c0, by = y16 + (r & ~3);
      const int frac = (m.x & 3) * 4 + (m.y & 3);
      const uint8_t* base = ring + m.slot * slot_pels;
      if (frac == 0) {
        direct4(base + (size_t)clampi(by + rr + (m.y >> 2), 0, H - 1) * W,
                bx + (m.x >> 2), W, pred);
      } else {
        const int off = BlkLuma::staged_offset(bx + (m.x >> 2) - 2, W);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pred[k] = luma_pel(wb + b * 288 + rr * 32 + off + k, 32, frac,
                             hb + b * 36 + rr * 4 + k, 4);
      }
    } else {
      // pels c0..c0+3 of chroma row r: two blocks, two pels each
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = (r >> 1) * 4 + (c0 >> 1) + h;
        const Motion m = motion_of(b);
        const int bx = x16 + (b & 3) * 4;
        const int off =
            BlkChroma::staged_offset((bx >> 1) + (m.x >> 3), Wc);
        const uint8_t* w = cw + ((pl - 1) * 16 + b) * 24 + (r & 1) * 8 + off;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          pred[2 * h + k] = chroma_pel(w + k, 8, m.x & 7, m.y & 7);
      }
    }
  }
  // the inter combine, stored as one word into the plane row
  *out = (uint32_t)clip8(pred[0] + res.x) |
         (uint32_t)clip8(pred[1] + res.y) << 8 |
         (uint32_t)clip8(pred[2] + res.z) << 16 |
         (uint32_t)clip8(pred[3] + res.w) << 24;
}

__global__ void __launch_bounds__(kReconThreads) mc_recon_kernel(
    ReconArgs a) {
  mc_recon_mb<false>(a, 0, 0);
}

__global__ void __launch_bounds__(kReconThreads) mc_recon_stripe_kernel(
    ReconArgs a, int ref_h, int mb_row_offset) {
  mc_recon_mb<true>(a, ref_h, mb_row_offset);
}

// the ReconArgs of h264_mc_recon and h264_mc_recon_stripe
static ReconArgs recon_args(const void* dpb_y, const void* dpb_cb,
                            const void* dpb_cr, const void* mv,
                            const void* ref_slot, const void* mb_class,
                            const void* res_l, const void* res_c,
                            const void* pcm_y, const void* pcm_cb,
                            const void* pcm_cr, void* y, void* cb, void* cr,
                            int n_slots, int width_mbs, int height_mbs) {
  return ReconArgs{(const uint8_t*)dpb_y,  (const uint8_t*)dpb_cb,
                   (const uint8_t*)dpb_cr, (const uint32_t*)mv,
                   (const int8_t*)ref_slot, (const uint8_t*)mb_class,
                   (const int32_t*)res_l,  (const int32_t*)res_c,
                   (const uint8_t*)pcm_y,  (const uint8_t*)pcm_cb,
                   (const uint8_t*)pcm_cr, (uint8_t*)y,
                   (uint8_t*)cb,           (uint8_t*)cr,
                   n_slots,                width_mbs,
                   height_mbs};
}

extern "C" int h264_mc_recon(const void* dpb_y, const void* dpb_cb,
                             const void* dpb_cr, const void* mv,
                             const void* ref_slot, const void* mb_class,
                             const void* res_l, const void* res_c,
                             const void* pcm_y, const void* pcm_cb,
                             const void* pcm_cr, void* y, void* cb, void* cr,
                             int n_slots, int width_mbs, int height_mbs,
                             void* stream) {
  mc_recon_kernel<<<width_mbs * height_mbs, kReconThreads, 0,
                    (cudaStream_t)stream>>>(
      recon_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l, res_c,
                 pcm_y, pcm_cb, pcm_cr, y, cb, cr, n_slots, width_mbs,
                 height_mbs));
  return (int)cudaGetLastError();
}

extern "C" int h264_mc_recon_stripe(
    const void* dpb_y, const void* dpb_cb, const void* dpb_cr,
    const void* mv, const void* ref_slot, const void* mb_class,
    const void* res_l, const void* res_c, const void* pcm_y,
    const void* pcm_cb, const void* pcm_cr, void* y, void* cb, void* cr,
    int n_slots, int width_mbs, int height_mbs, int ref_h,
    int mb_row_offset, void* stream) {
  mc_recon_stripe_kernel<<<width_mbs * height_mbs, kReconThreads, 0,
                           (cudaStream_t)stream>>>(
      recon_args(dpb_y, dpb_cb, dpb_cr, mv, ref_slot, mb_class, res_l, res_c,
                 pcm_y, pcm_cb, pcm_cr, y, cb, cr, n_slots, width_mbs,
                 height_mbs),
      ref_h, mb_row_offset);
  return (int)cudaGetLastError();
}
