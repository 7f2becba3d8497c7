// K1 + K2 + K5: OpenCV-convention CLAHE on [B, H, W] float32 slices in
// [0, 1], and on the row bands of a row-sharded slice (K5).
//
// K1 replaces mies_tpu/kernels/clahe.py:_hist_rows_kernel (and answers
// _hist_kernel). One counting core (count_rows, templated on the pixel
// source) serves three entry points:
//   * mies_tile_hists: per-tile 256-bin counts of the uint8 levels of f32
//     pixels, the level quantize done in the kernel;
//   * mies_tile_hists_bins: counts of int32 bin indices that are already
//     computed, into nbins <= 1024 bins per region, over a window of a
//     larger array at a row and column offset (the skimage convention's
//     regions, read in place);
//   * mies_tile_luts_opencv: the float counts continued to the OpenCV LUT
//     in the same launch: the integer clip and redistribution, the cdf and
//     the rint'ed uint8-valued LUT, which the TPU program computed between
//     its two Pallas calls (mies_tpu/kernels/clahe.py clahe_tpu, the XLA
//     code after tile_hists_rows_pallas).
// The TPU built its histograms from nibble onehot matmuls because it has
// no scatter; Hopper has shared-memory atomics. A block counts a strip of
// at most kPixelsPerBlock pixels of one tile. Its lanes map to the tile in
// two dimensions (a warp covers a row segment, the block walks rows; no
// integer divide per pixel), read 16 bytes a lane on rows that are 16-byte
// aligned in tiles inside the image, and resolve the bottom/right
// reflect-101 pad of a ragged image (cv2's rule, any number of bounces) by
// index only in the edge tiles that reach into it. Hot bins cost nothing
// measurable on Hopper: a batch of one level everywhere (every lane of
// every warp counting the same bin) ran as fast as the X-ray phantom, and
// per-warp sub-histograms and run merging inside a lane's 4 pixels each
// made the kernel slower (PERF.md section 6), so the block counts into
// one shared histogram. Bound: one read of the image (4 B a pixel).
// When a tile takes several blocks (large tiles: a 4096^2 slice at 8x8),
// each adds its counts to a zeroed int32 scratch with integer atomics
// (exact in any order); for the LUT entry the block that arrives last at
// the tile's counter reads the totals back and builds the LUT. The wrapper
// zeroes counts and counters before every launch whose tiles split.
//
// K2 (mies_apply_lut) replaces mies_tpu/kernels/clahe.py:_apply33_kernel
// (and answers _apply_kernel_slab, _apply_kernel and the clahe_variants
// kernels): the OpenCV bilinear blend of the four neighbouring tiles' LUTs
// at each pixel's level, then the u8norm epilogue clip(rint(v),0,255)/255
// (opencv: integer LUTs) or the clip01 epilogue clip(v, 0, 1) (fraction:
// fractional LUTs cdf / tile_area). The TPU selected LUT entries by onehot
// matmul because it has no gather. Here a block owns (a strip of) one
// interpolation cell, the region between four tile centres whose pixels
// all blend the same four LUTs: it stages just those four, interleaved as
// one float4 per level (4 KB), so a pixel takes one 16-byte shared load.
// The cell's rows and columns are found on the device with the blend's own
// f32 formula, so no rounding edge can send a pixel to a LUT the block did
// not stage. Each thread keeps its columns (one float4 of them on aligned
// rows) while the block walks the rows: the column weights are computed
// once per column, the row weight once per row. u8norm divides by 255
// through a 256-entry table of the correctly rounded quotients. Bound: 4 B
// read + 4 B written per pixel. Every multiply/add of the blend is an
// explicit _rn intrinsic in the parent's order: nvcc contracts a*b+c to
// FMA by default, which would break the bit-exactness against the plain
// version (and against cv2).
//
// K5 (mies_apply_lut_band) replaces mies_tpu/kernels/clahe.py:
// _blocks4_fracs_kernel (blocks4_fracs_apply, the apply of one row band of a
// row-sharded slice, parallel/clahe_shard.py clahe_band): the same blend of
// a tile-aligned [hb, W] band against the FULL [gy, gx, 256] LUT grid, at
// the band's global rows. The TPU kernel received the fractions as input
// blocks only because Mosaic could not derive them from a row offset traced
// inside shard_map; here the offset is a launch argument and the fractions
// are derived in the kernel with K2's arithmetic at global row y + y_off, so
// no fraction arrays exist. K2 and K5 share the kernel (K2 passes 0).

#include <cuda_runtime.h>

#include "cells.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerBlock = 8192;  // a block's share of a tile or cell
static_assert(kThreads == kBins, "the LUT epilogue runs one thread a bin");

// Source index of a position in OpenCV's bottom/right BORDER_REFLECT_101
// pad, at any number of bounces (cv2's rule pads a full tile on an axis
// that divides evenly, which can be longer than a small image); periodic
// with period 2n - 2, as borderInterpolate and numpy 'reflect'.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < n) return i;
  if (n == 1) return 0;
  const int m = i % (2 * n - 2);
  return m < n ? m : 2 * n - 2 - m;
}

// --- K1: the counting core -------------------------------------------------

// The pixel sources: f32 values quantized to levels, or int32 bins whose
// values outside [0, nbins) are not counted (the wrapper's binning never
// makes one).
struct FloatLevels {
  const float* p;
  __device__ int bin(int i) const { return level_of(p[i]); }
  __device__ void bins4(int i, int (&v)[4]) const {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[0] = level_of(f.x); v[1] = level_of(f.y);
    v[2] = level_of(f.z); v[3] = level_of(f.w);
  }
};

struct IntBins {
  const int* p;
  __device__ int bin(int i) const { return p[i]; }
  __device__ void bins4(int i, int (&v)[4]) const {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

// One shared atomic a pixel into the block's single histogram: on the
// X-ray phantom and on a flat batch (every lane on one bin) this was
// faster than per-warp sub-histograms or merging equal neighbours
// (PERF.md, section 6).
__device__ __forceinline__ void count(int* h, int v, int nbins) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(nbins))
    atomicAdd(&h[v], 1);
}

// The geometry of one block's share of a tile: rows [r0, r1) and columns
// [c0, c0 + tw) of the (padded) slice, read from an [H, W] slice.
struct Strip {
  int r0, r1, c0, tw, H, W;
};

// Count the strip into the block's histogram h. Lanes in groups of a
// power of two L >= the row's units (capped at 32) each take one row; a
// unit is 4 pixels (vector) or 1 (scalar, or any pixel of an edge tile
// that reaches into the pad).
template <class Src>
__device__ void count_rows(const Src& src, const Strip& s, bool vec,
                           int* h, int nbins) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = vec ? s.tw >> 2 : s.tw;
  int lg = 0;
  while ((1 << lg) < units && lg < 5) ++lg;
  const int rows_per_warp = 32 >> lg;
  const int sub = lane >> lg, col = lane & ((1 << lg) - 1);
  const int step = kWarps * rows_per_warp;
  const bool inside = s.r1 <= s.H && s.c0 + s.tw <= s.W;
  for (int r = s.r0 + warp * rows_per_warp + sub; r < s.r1; r += step) {
    if (vec) {
      const int base = r * s.W + s.c0;
      for (int u = col; u < units; u += 1 << lg) {
        int v[4];
        src.bins4(base + 4 * u, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) count(h, v[k], nbins);
      }
    } else if (inside) {
      const int base = r * s.W + s.c0;
      for (int u = col; u < units; u += 1 << lg)
        count(h, src.bin(base + u), nbins);
    } else {
      const int base = reflect101(r, s.H) * s.W;
      for (int u = col; u < units; u += 1 << lg)
        count(h, src.bin(base + reflect101(s.c0 + u, s.W)), nbins);
    }
  }
}

// Zero the block's histogram, count its strip into it. Ends synchronised.
template <class Src>
__device__ void count_strip(const Src& src, const Strip& s, bool vec,
                            int* hist, int nbins) {
  for (int k = threadIdx.x; k < nbins; k += kThreads) hist[k] = 0;
  __syncthreads();
  count_rows(src, s, vec, hist, nbins);
  __syncthreads();
}

// Block (j, i * splits + sub, b): rows [sub * rpb, (sub + 1) * rpb) of tile
// (i, j), whose rows in the slice start at row i * th (+ y0 of the window)
// and whose columns at x0 + j * tw.
struct TileBlock {
  int i, j, b, sub, splits;
  __device__ TileBlock(int th, int rpb) {
    splits = (th + rpb - 1) / rpb;
    j = blockIdx.x;
    i = blockIdx.y / splits;
    sub = blockIdx.y - i * splits;
    b = blockIdx.z;
  }
};

// A block's counts of a tile: stored when it counted the whole tile, else
// added to the zeroed output.
__device__ __forceinline__ void put_counts(int* out, const int* counts,
                                           int nbins, int splits) {
  for (int k = threadIdx.x; k < nbins; k += kThreads) {
    if (splits == 1) {
      out[k] = counts[k];
    } else if (counts[k] != 0) {
      atomicAdd(&out[k], counts[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tile_hists_kernel(const float* __restrict__ x, int* __restrict__ hist,
                  int H, int W, int gy, int gx, int th, int tw, int rpb,
                  int vec_ok) {
  extern __shared__ int hists_f[];
  const TileBlock t(th, rpb);
  const int r0 = t.i * th + t.sub * rpb;
  const Strip s{r0, min(r0 + rpb, (t.i + 1) * th), t.j * tw, tw, H, W};
  const bool vec = vec_ok && (tw & 3) == 0 && s.r1 <= H && s.c0 + tw <= W;
  count_strip(FloatLevels{x + static_cast<size_t>(t.b) * H * W}, s, vec,
              hists_f, kBins);
  put_counts(hist + ((static_cast<size_t>(t.b) * gy + t.i) * gx + t.j) * kBins,
             hists_f, kBins, t.splits);
}

__global__ void __launch_bounds__(kThreads)
tile_hists_bins_kernel(const int* __restrict__ bins, int* __restrict__ hist,
                       int H, int W, int y0, int x0, int gy, int gx, int th,
                       int tw, int nbins, int rpb, int vec_ok) {
  extern __shared__ int hists_b[];
  const TileBlock t(th, rpb);
  // the window's rows and columns as a strip of a slice that starts at
  // the window's corner: the window always lies inside the slice
  const int r0 = y0 + t.i * th + t.sub * rpb;
  const Strip s{r0, min(r0 + rpb, y0 + (t.i + 1) * th), x0 + t.j * tw, tw, H,
                W};
  const bool vec = vec_ok && (tw & 3) == 0 && (x0 & 3) == 0;
  count_strip(IntBins{bins + static_cast<size_t>(t.b) * H * W}, s, vec,
              hists_b, nbins);
  put_counts(hist + ((static_cast<size_t>(t.b) * gy + t.i) * gx + t.j) * nbins,
             hists_b, nbins, t.splits);
}

// --- K1's LUT epilogue -----------------------------------------------------

// Inclusive scan of one int per thread over the block (kThreads threads);
// `warp_tot` holds kWarps ints of shared memory. Ends synchronised.
__device__ __forceinline__ int block_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_tot[w] : 0;
  __syncthreads();
  return v + before;
}

// OpenCV's clip, redistribution, cdf and LUT of one tile's 256 counts,
// one bin per thread (mies_tpu/kernels/clahe.py clahe_tpu's XLA code and
// ops.histogram._luts_opencv): all in integers, and the LUT entry
// clip(rint(f32(cdf) * lut_scale), 0, 255). Every value is an integer
// below 2^24 (the wrapper checks the tile area), so this equals the float
// formulation bit for bit.
__device__ void opencv_lut(int h, int clip, float lut_scale, float* lut,
                           int* warp_tot) {
  const int t = threadIdx.x;
  // the excess: the last thread's inclusive scan is the block's sum
  __shared__ int excess_s;
  const int ex = block_scan(max(h - clip, 0), warp_tot);
  if (t == kThreads - 1) excess_s = ex;
  __syncthreads();
  const int excess = excess_s;
  h = min(h, clip) + (excess >> 8);  // excess / 256
  const int residual = excess & (kBins - 1);
  if (residual > 0) {
    const int step = max(kBins / residual, 1);
    if (t % step == 0 && t / step < residual) h += 1;
  }
  const int cdf = block_scan(h, warp_tot);
  lut[t] = fminf(fmaxf(rintf(__fmul_rn(static_cast<float>(cdf), lut_scale)),
                       0.0f), 255.0f);
}

// Block (j, i * splits + sub, b) counts its strip of tile (i, j) as
// tile_hists_kernel does; the block holding the tile's whole count (the
// only one, or the last of `splits` to arrive) writes the tile's LUT to
// luts[b, i, j, :]. scratch: [B * gy * gx * 256] counts then [B * gy * gx]
// arrival counters, zeroed by the caller when tiles split.
__global__ void __launch_bounds__(kThreads)
tile_luts_kernel(const float* __restrict__ x, float* __restrict__ luts,
                 int* __restrict__ scratch, int H, int W, int gy, int gx,
                 int th, int tw, int rpb, int vec_ok, int clip,
                 float lut_scale) {
  extern __shared__ int hists_l[];
  __shared__ int warp_tot[kWarps];
  __shared__ int last;
  const TileBlock t(th, rpb);
  const int r0 = t.i * th + t.sub * rpb;
  const Strip s{r0, min(r0 + rpb, (t.i + 1) * th), t.j * tw, tw, H, W};
  const bool vec = vec_ok && (tw & 3) == 0 && s.r1 <= H && s.c0 + tw <= W;
  count_strip(FloatLevels{x + static_cast<size_t>(t.b) * H * W}, s, vec,
              hists_l, kBins);
  const size_t tile = (static_cast<size_t>(t.b) * gy + t.i) * gx + t.j;
  int h = hists_l[threadIdx.x];
  if (t.splits > 1) {
    int* counts = scratch + tile * kBins;
    int* arrived = scratch + static_cast<size_t>(gridDim.z) * gy * gx * kBins +
                   tile;
    if (h != 0) atomicAdd(&counts[threadIdx.x], h);
    __threadfence();  // this block's counts are visible before it arrives
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrived, 1) == t.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    h = __ldcg(&counts[threadIdx.x]);  // from L2: every block's adds
  }
  opencv_lut(h, clip, lut_scale, luts + tile * kBins, warp_tot);
}

// --- K2 / K5: the LUT blend on interpolation cells -------------------------
// (the cells and their edges: cells.cuh, shared with K8)

template <bool kClip01>
__device__ __forceinline__ float blend(const float4& q, float omx, float xa,
                                       float omy, float ya,
                                       const float* div255) {
  const float top = __fadd_rn(__fmul_rn(q.x, omx), __fmul_rn(q.y, xa));
  const float bot = __fadd_rn(__fmul_rn(q.z, omx), __fmul_rn(q.w, xa));
  const float res = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, ya));
  if (kClip01) return fminf(fmaxf(res, 0.0f), 1.0f);
  return div255[static_cast<int>(fminf(fmaxf(rintf(res), 0.0f), 255.0f))];
}

// x and out hold H rows starting at global row y_off (0 for a whole
// slice). Block (cx_slot * col_splits + csub, cy_slot * row_splits + rsub,
// b) owns rows [rsub * rpb, (rsub + 1) * rpb) of cell row cy = cell of
// y_off + cy_slot, and column units [csub * kThreads, ...) of cell column
// cx = cx_slot - 1. A cell's pixels all blend the LUTs of tile rows ty1 =
// max(cy, 0), ty2 = min(cy + 1, gy - 1) and tile columns tx1, tx2 alike.
template <bool kClip01>
__global__ void __launch_bounds__(kThreads)
apply_lut_kernel(const float* __restrict__ x, const float* __restrict__ luts,
                 float* __restrict__ out, int H, int W, int gy, int gx,
                 int th, int tw, float inv_th, float inv_tw, int y_off,
                 int rpb, int row_splits, int col_splits, int vec_ok) {
  __shared__ float4 quad[kBins];
  __shared__ float div255[kBins];
  const int cy_slot = blockIdx.y / row_splits;
  const int rsub = blockIdx.y - cy_slot * row_splits;
  const int cx_slot = blockIdx.x / col_splits;
  const int csub = blockIdx.x - cx_slot * col_splits;
  const int b = blockIdx.z;

  // this block's rows (local to x) and columns, by the blend's formula
  const int cy = cell_of(y_off, inv_th) + cy_slot, cx = cx_slot - 1;
  if (cy > gy - 1) return;
  const int g_lo = cell_start(cy, th, inv_th, y_off, y_off + H);
  const int g_hi = cell_start(cy + 1, th, inv_th, y_off, y_off + H);
  // the last strip takes whatever rows the cell has left
  const int r_lo = g_lo - y_off + rsub * rpb;
  const int r_hi = rsub == row_splits - 1 ? g_hi - y_off
                                          : min(r_lo + rpb, g_hi - y_off);
  const int x_lo = cell_start(cx, tw, inv_tw, 0, W);
  const int x_hi = cell_start(cx + 1, tw, inv_tw, 0, W);
  if (r_lo >= r_hi || x_lo >= x_hi) return;
  // column units: scalar head, float4 body (rows 16-byte aligned), scalar
  // tail
  const Units units(x_lo, x_hi, vec_ok);
  const int u_lo = csub * kThreads;
  if (u_lo >= units.n) return;
  const int nu = min(units.n - u_lo, kThreads);

  // the cell's four LUTs, one float4 per level
  {
    const int ty1 = max(cy, 0), ty2 = min(cy + 1, gy - 1);
    const int tx1 = max(cx, 0), tx2 = min(cx + 1, gx - 1);
    const float* lb = luts + static_cast<size_t>(b) * gy * gx * kBins;
    const int v = threadIdx.x;
    quad[v] = make_float4(lb[(ty1 * gx + tx1) * kBins + v],
                          lb[(ty1 * gx + tx2) * kBins + v],
                          lb[(ty2 * gx + tx1) * kBins + v],
                          lb[(ty2 * gx + tx2) * kBins + v]);
    if (!kClip01) div255[v] = __fdiv_rn(static_cast<float>(v), 255.0f);
  }
  __syncthreads();

  // this thread's unit and first row; it keeps the unit while it walks
  const int rows_per_pass = kThreads / nu;
  const int rrow = threadIdx.x / nu;
  if (rrow >= rows_per_pass) return;
  const int u = u_lo + threadIdx.x - rrow * nu;
  const bool vec = units.is_vec(u);
  const int c = units.col(u);
  // OpenCV: txf = x * (1/tw) - 0.5; tx1 = max(floor, 0);
  // tx2 = min(UNCLIPPED floor + 1, gx - 1); xa = txf - floor
  float xa[4], omx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float txf = cell_pos(c + k, inv_tw);
    xa[k] = __fsub_rn(txf, floorf(txf));
    omx[k] = __fsub_rn(1.0f, xa[k]);
  }
  const float* img = x + static_cast<size_t>(b) * H * W;
  float* dst = out + static_cast<size_t>(b) * H * W;
  for (int r = r_lo + rrow; r < r_hi; r += rows_per_pass) {
    const float tyf = cell_pos(r + y_off, inv_th);
    const float ya = __fsub_rn(tyf, floorf(tyf));
    const float omy = __fsub_rn(1.0f, ya);
    const size_t at = static_cast<size_t>(r) * W + c;
    if (vec) {
      const float4 p = *reinterpret_cast<const float4*>(img + at);
      float4 o;
      o.x = blend<kClip01>(quad[level_of(p.x)], omx[0], xa[0], omy, ya, div255);
      o.y = blend<kClip01>(quad[level_of(p.y)], omx[1], xa[1], omy, ya, div255);
      o.z = blend<kClip01>(quad[level_of(p.z)], omx[2], xa[2], omy, ya, div255);
      o.w = blend<kClip01>(quad[level_of(p.w)], omx[3], xa[3], omy, ya, div255);
      *reinterpret_cast<float4*>(dst + at) = o;
    } else {
      dst[at] = blend<kClip01>(quad[level_of(img[at])], omx[0], xa[0], omy,
                               ya, div255);
    }
  }
}

// K1's rows of one tile per block: the whole tile up to kPixelsPerBlock
// pixels, else strips of about that many.
int rows_per_block(int th, int tw) {
  return min(th, max(1, (kPixelsPerBlock + tw - 1) / tw));
}

// Zero what several blocks per tile add into.
cudaError_t zero_if_split(int* p, size_t count, int th, int rpb,
                          cudaStream_t stream) {
  if (rpb >= th) return cudaSuccess;
  return cudaMemsetAsync(p, 0, count * sizeof(int), stream);
}

// K2 / K5's launch: cells of up to th + 1 rows (the f32 weights may move a
// cell edge by one) in strips of about kPixelsPerBlock pixels, and column
// units (a cell spans at most tw + 1 columns) in chunks of kThreads.
cudaError_t launch_apply(const float* x, const float* luts, float* out, int B,
                         int H, int W, int gy, int gx, int th, int tw,
                         float inv_th, float inv_tw, int y_off, int clip01,
                         cudaStream_t stream) {
  const int rpb = max(1, kPixelsPerBlock / (tw + 1));
  const int row_splits = (th + 1 + rpb - 1) / rpb;
  const int vec_ok = rows_aligned(x, W) && rows_aligned(out, W);
  const int max_units = vec_ok ? (tw + 1) / 4 + 8 : tw + 1;
  const int col_splits = (max_units + kThreads - 1) / kThreads;
  const int cells_y = min(gy + 1, (H + th - 1) / th + 1);
  const dim3 grid((gx + 1) * col_splits, cells_y * row_splits, B);
  if (clip01) {
    apply_lut_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, luts, out, H, W, gy, gx, th, tw, inv_th, inv_tw, y_off, rpb,
        row_splits, col_splits, vec_ok);
  } else {
    apply_lut_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, luts, out, H, W, gy, gx, th, tw, inv_th, inv_tw, y_off, rpb,
        row_splits, col_splits, vec_ok);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, W] f32; hist: [B, gy, gx, 256] int32. (th, tw) is the tile of
// the image padded up to a multiple of the grid.
extern "C" int mies_tile_hists(const float* x, int* hist, int B, int H, int W,
                               int gy, int gx, int th, int tw,
                               cudaStream_t stream) {
  const int rpb = rows_per_block(th, tw);
  const cudaError_t err = zero_if_split(
      hist, static_cast<size_t>(B) * gy * gx * kBins, th, rpb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_hists_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads,
                      kBins * sizeof(int), stream>>>(x, hist, H, W, gy, gx, th,
                                                    tw, rpb,
                                                    rows_aligned(x, W));
  return static_cast<int>(cudaGetLastError());
}

// bins: [B, H, W] int32; hist: [B, gy, gx, nbins] int32 (nbins <= 1024),
// counted over the window rows [y0, y0 + gy*th) and columns
// [x0, x0 + gx*tw).
extern "C" int mies_tile_hists_bins(const int* bins, int* hist, int B, int H,
                                    int W, int y0, int x0, int gy, int gx,
                                    int th, int tw, int nbins,
                                    cudaStream_t stream) {
  if (nbins < 1 || nbins > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows_per_block(th, tw);
  const cudaError_t err = zero_if_split(
      hist, static_cast<size_t>(B) * gy * gx * nbins, th, rpb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_hists_bins_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads,
                           nbins * sizeof(int), stream>>>(
      bins, hist, H, W, y0, x0, gy, gx, th, tw, nbins, rpb,
      rows_aligned(bins, W));
  return static_cast<int>(cudaGetLastError());
}

// x: [B, H, W] f32; luts: [B, gy, gx, 256] f32, the OpenCV LUTs of the
// tiles (th, tw) of x padded by cv2's rule; scratch: B * gy * gx * 257
// int32 (used, and zeroed here, only when a tile takes several blocks).
// clip: the integer max(int(clip_limit * tile_area / 256), 1); lut_scale:
// the f32 255 / tile_area; tile_area < 2^24.
extern "C" int mies_tile_luts_opencv(const float* x, float* luts, int* scratch,
                                     int B, int H, int W, int gy, int gx,
                                     int th, int tw, int clip, float lut_scale,
                                     cudaStream_t stream) {
  if (static_cast<long long>(th) * tw >= (1LL << 24) || clip < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows_per_block(th, tw);
  const cudaError_t err = zero_if_split(
      scratch, static_cast<size_t>(B) * gy * gx * (kBins + 1), th, rpb,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_luts_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads,
                     kBins * sizeof(int), stream>>>(
      x, luts, scratch, H, W, gy, gx, th, tw, rpb, rows_aligned(x, W), clip,
      lut_scale);
  return static_cast<int>(cudaGetLastError());
}

// x, out: [B, H, W] f32; luts: [B, gy, gx, 256] f32 (integer-valued for
// the u8norm epilogue, fractional for clip01). inv_th / inv_tw are the
// host's correctly rounded f32 reciprocals; clip01 selects the epilogue.
extern "C" int mies_apply_lut(const float* x, const float* luts, float* out,
                              int B, int H, int W, int gy, int gx, int th,
                              int tw, float inv_th, float inv_tw, int clip01,
                              cudaStream_t stream) {
  return static_cast<int>(launch_apply(x, luts, out, B, H, W, gy, gx, th, tw,
                                       inv_th, inv_tw, 0, clip01, stream));
}

// K5. x, out: [B, H, W] f32, a band of H = (rows of tiles) * th rows whose
// first row is global row y_off (a multiple of th) of a slice W = gx * tw
// wide; luts: [B, gy, gx, 256] f32, the whole slice's grid.
extern "C" int mies_apply_lut_band(const float* x, const float* luts,
                                   float* out, int B, int H, int W, int gy,
                                   int gx, int th, int tw, float inv_th,
                                   float inv_tw, int y_off, int clip01,
                                   cudaStream_t stream) {
  if (th < 1 || H % th != 0 || y_off % th != 0 || y_off < 0 ||
      y_off + H > gy * th || W != gx * tw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_apply(x, luts, out, B, H, W, gy, gx, th, tw,
                                       inv_th, inv_tw, y_off, clip01, stream));
}
