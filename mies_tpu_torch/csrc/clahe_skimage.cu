// K6a + K6: the skimage (equalize_adapthist) convention of CLAHE.
//
// K6a (mies_skimage_maps) replaces XLA-side code, not a Pallas kernel:
// mies_tpu/ops/histogram.py:_clip_histogram_skimage + _skimage_maps. One
// warp per region, kMapWarps regions a block, no shared memory and no block
// barrier: lane l holds the contiguous bins [l P, l P + P) in registers
// (P = 8 up to 256 bins: two int4 loads and two float4 stores a lane; P =
// 32 up to 1024; bins at or past nbins never count and are never stored).
// Phases 1-2 (clip, uniform spread, top-up of near-limit bins) are per-lane
// sums over the lane's bins and one __reduce_add_sync each. Phase 3, the
// iterative strided sweep, runs on warp-uniform n, index and sweep_start,
// so the loop never returns to the host (the plain version synchronises
// with the host at every step): a lane keeps its bins under the limit as a
// bit mask; each step takes step = max(n_under / max(n, 1), 1), finds the
// lane's first selected bin with one modulo (the first t >= max(index,
// l P) with (t - index) % step == 0), selects every step-th under-limit bin
// from there (a mask of bits step apart), and one warp reduction gives the
// selected count (off n) and the count that reached the limit (off
// n_under). No loop over a lane's bins carries a dependence. A step with
// no under-limit bin at or past index ends the sweep at once: the steps it
// skips select nothing (stalled sweeps, and most of a sweep whose last
// under-limit bins lie behind index, are made of them). Then a
// serial inclusive scan of the lane's bins, a warp exclusive scan of the
// lane totals by __shfl_up_sync (5 levels), __fmul_rn by the f32 scale
// 16383 / k_elems, min and floor. Integers until the scale: bit-equal to
// the plain version. Bound: 8 B per bin (the counts read, the maps
// written); what costs is the latency of the data-dependent number of
// phase-3 steps, one warp reduction each.
//
// K6 (mies_skimage_apply) replaces mies_tpu/kernels/clahe.py:
// _apply_maps_rows_kernel (kc % 64 == 0) and _apply_maps_kernel (every other
// kc) with one kernel for any kr, kc: skimage's bilinear blend of the four
// neighbouring region maps at each pixel's bin, floored. The TPU selected
// map entries by onehot matmul because it has no gather; on Hopper the
// gather is a shared-memory load. A block owns (a strip of) one kr x kc
// interpolation block of the padded binned image, cut to the crop: every
// pixel there blends the same four corner maps, staged from clamped region
// indices (the edge-replicated map grid without a padded copy) as one
// float4 per bin (00, 01, 10, 11; 4 KB at 256 bins), so a pixel takes one
// 16-byte shared load. Blocks of more than about kernels/clahe.py
// SK_PIXELS_PER_BLOCK pixels are cut into strips of rows (so a 4096^2
// slice at grid 8 x 8 fills the card).
// Each thread keeps its column unit (four columns on 16-byte aligned rows:
// an int4 load of bins and a float4 store; scalar head and tail) while it
// walks the strip's rows: wx = (x - bx kc) / kc by __fdiv_rn once per
// column, wy and 1 - wy once per row (regions.cuh), no integer divide per
// pixel. Per pixel the coefficients (1 - wy)(1 - wx), (1 - wy) wx,
// wy (1 - wx), wy wx, the four sel * coeff terms summed in corner order
// with _rn intrinsics (nvcc would otherwise contract them into FMAs), then
// floorf: the plain version's order, so bit-equal. Only the pixels of the
// unpadded crop are written. The launch geometry (blocks, strips, column
// chunks) is kernels/clahe.py skimage_launch's. Bound: 4 B of bins read
// and 4 B written per output pixel.

#include <cuda_runtime.h>

#include <cstdint>

#include "cells.cuh"
#include "regions.cuh"

namespace {

constexpr int kThreads = 256;  // kernels/clahe.py THREADS (K6)
constexpr int kMaxBins = 1024;  // kernels/clahe.py MAX_BINS: 32 lanes x 32
constexpr int kMapWarps = 4;  // K6a's regions a block, a warp each
constexpr int kMaxGridYZ = 65535;
constexpr float kMaxGray = 16383.0f;  // NR_OF_GRAY - 1
constexpr unsigned kFull = 0xffffffffu;

// Warp w of block b owns region b * kMapWarps + w; lane l its bins
// [l P, l P + P) cut to nbins. vec: the lane's P bins as int4 / float4 when
// they are all valid (hists and maps 16-byte aligned, nbins % 4 == 0).
template <int P>
__global__ void __launch_bounds__(32 * kMapWarps)
skimage_maps_kernel(const int* __restrict__ hists, float* __restrict__ maps,
                    int R, int nbins, int clim, float scale, int vec) {
  const int region = blockIdx.x * kMapWarps + threadIdx.x / 32;
  if (region >= R) return;  // warp-uniform: no block barrier below
  const int lane = threadIdx.x % 32;
  const int lo = lane * P;                        // the lane's first bin
  const int nv = min(max(nbins - lo, 0), P);      // its valid bins
  const bool full = vec && nv == P;
  const size_t base = static_cast<size_t>(region) * nbins + lo;
  int h[P];
  if (full) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(hists + base + i);
      h[i] = q.x, h[i + 1] = q.y, h[i + 2] = q.z, h[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) h[i] = i < nv ? hists[base + i] : 0;
  }

  // phase 1: clip at the limit, count the excess
  int part = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (h[i] > clim) part += h[i] - clim;
    h[i] = min(h[i], clim);
  }
  int n = __reduce_add_sync(kFull, part);

  // phase 2: uniform spread to the bins below clim - incr, then the top-up
  // of bins at or above that (on the UPDATED hist, as skimage does)
  const int incr = n / nbins;
  const int upper = clim - incr;
  part = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nv && h[i] < upper) {
      h[i] += incr;
      ++part;
    }
  }
  n -= __reduce_add_sync(kFull, part) * incr;
  part = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nv && h[i] >= upper && h[i] < clim) {
      part += clim - h[i];
      h[i] = clim;
    }
  }
  n -= __reduce_add_sync(kFull, part);

  // phase 3: from sweep index `index`, every under-limit bin at stride
  // max(n_under / n, 1) gets one; a full sweep without progress stalls.
  // n, n_under, index and sweep_start are warp-uniform, so is the loop.
  // The lane's bins under the limit are a bit mask; a step selects the
  // lane's first bin at index + a multiple of step (one modulo), then every
  // step-th bin after it (a pattern of bits step apart, shifted there).
  // Only a selected bin can reach the limit, so n_under drops by those,
  // summed in the same warp reduction as the selected ones.
  unsigned under = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    under |= static_cast<unsigned>(i < nv && h[i] < clim) << i;
  }
  int n_under = __reduce_add_sync(kFull, __popc(under));
  int index = 0, sweep_start = n;
  bool stalled = false;
  while (n > 0 && !stalled) {
    // no bin under the limit at or past index: the sweep's remaining steps
    // select nothing, so go to its end at once (n is what they leave)
    const int past = index - lo;
    const unsigned ahead = past <= 0 ? under : past < 32 ? under >> past : 0u;
    if (!__any_sync(kFull, ahead != 0u)) {
      stalled = n == sweep_start;
      sweep_start = n;
      index = 0;
      continue;
    }
    const int step = max(n_under / max(n, 1), 1);
    const int t0 = max(index, lo);
    const int rem = (t0 - index) % step;
    const int first = t0 - lo + (rem ? step - rem : 0);
    unsigned stride = 1;  // bits 0, step, 2 step, ...
    for (int w = step; w < 32; w <<= 1) stride |= stride << w;
    const unsigned sel = first < P ? (stride << first) & under : 0u;
    unsigned full = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      h[i] += (sel >> i) & 1u;
      full |= static_cast<unsigned>(h[i] >= clim) << i;
    }
    const unsigned filled = sel & full;
    under &= ~filled;
    const int taken = __reduce_add_sync(
        kFull, static_cast<int>((__popc(sel) << 16) | __popc(filled)));
    n -= taken >> 16;
    n_under -= taken & 0xffff;
    if (++index == nbins) {
      stalled = n == sweep_start;
      sweep_start = n;
      index = 0;
    }
  }

  // inclusive cumsum: the lane's bins, then the lanes before it
  int run = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    run += h[i];  // 0 past nbins
    h[i] = run;
  }
  int before = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, before, off);
    if (lane >= off) before += y;
  }
  before -= run;  // exclusive
  float m[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    m[i] = floorf(
        fminf(__fmul_rn(__int2float_rn(h[i] + before), scale), kMaxGray));
  }
  if (full) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      *reinterpret_cast<float4*>(maps + base + i) =
          make_float4(m[i], m[i + 1], m[i + 2], m[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < nv) maps[base + i] = m[i];
    }
  }
}

// skimage's blend of the corner quad q at weights (omy, wy) x (omx, wx)
__device__ __forceinline__ float blend4(const float4& q, float omy, float wy,
                                        float omx, float wx) {
  float acc = __fmul_rn(q.x, __fmul_rn(omy, omx));
  acc = __fadd_rn(acc, __fmul_rn(q.y, __fmul_rn(omy, wx)));
  acc = __fadd_rn(acc, __fmul_rn(q.z, __fmul_rn(wy, omx)));
  acc = __fadd_rn(acc, __fmul_rn(q.w, __fmul_rn(wy, wx)));
  return floorf(acc);
}

// Block ((strip * nbx + bxi) * col_splits + csub, byi, b) owns rows
// [strip * rpb, (strip + 1) * rpb) of interpolation block (by, bx) =
// (y0 / kr + byi, x0 / kc + bxi) of slice b, cut to the crop, and its
// column units [csub * kThreads, ...).
__global__ void __launch_bounds__(kThreads)
skimage_apply_kernel(const int* __restrict__ bins,
                     const float* __restrict__ maps, float* __restrict__ out,
                     int H, int W, int nr, int nc, int kr, int kc, int nbins,
                     int y0, int x0, int H0, int W0, int nbx, int rpb,
                     int col_splits, int vec_ok) {
  extern __shared__ float4 quad[];  // [nbins]: corners 00, 01, 10, 11
  const int csub = blockIdx.x % col_splits;
  const int rest = blockIdx.x / col_splits;
  const int bx = x0 / kc + rest % nbx, strip = rest / nbx;
  const int by = y0 / kr + static_cast<int>(blockIdx.y);
  const int b = blockIdx.z;
  const Span sy = region_span(by, kr, y0, H0);
  const Span sx = region_span(bx, kc, x0, W0);
  const int r_lo = sy.lo + strip * rpb, r_hi = min(r_lo + rpb, sy.hi);
  if (r_lo >= r_hi) return;  // block-uniform, before the barrier
  const Units units(sx.lo, sx.hi, vec_ok);
  const int u_lo = csub * kThreads;
  if (u_lo >= units.n) return;
  const int nu = min(units.n - u_lo, kThreads);

  {
    const int my0 = min(max(by - 1, 0), nr - 1), my1 = min(by, nr - 1);
    const int mx0 = min(max(bx - 1, 0), nc - 1), mx1 = min(bx, nc - 1);
    const float* mb = maps + static_cast<size_t>(b) * nr * nc * nbins;
    const float* m00 = mb + static_cast<size_t>(my0 * nc + mx0) * nbins;
    const float* m01 = mb + static_cast<size_t>(my0 * nc + mx1) * nbins;
    const float* m10 = mb + static_cast<size_t>(my1 * nc + mx0) * nbins;
    const float* m11 = mb + static_cast<size_t>(my1 * nc + mx1) * nbins;
    for (int v = threadIdx.x; v < nbins; v += kThreads)
      quad[v] = make_float4(m00[v], m01[v], m10[v], m11[v]);
  }
  __syncthreads();

  // this thread's unit and first row; it keeps the unit while it walks
  const int rows_per_pass = kThreads / nu;
  const int rrow = threadIdx.x / nu;
  if (rrow >= rows_per_pass) return;
  const int u = u_lo + threadIdx.x - rrow * nu;
  const bool vec = units.is_vec(u);
  const int c = units.col(u);
  Weights wx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wx[k] = region_weights(c + k, bx, kc);
  const int* src = bins + static_cast<size_t>(b) * H * W;
  float* dst = out + static_cast<size_t>(b) * H0 * W0;
  // the wrapper's binning keeps bins in [0, nbins); the clamp keeps the
  // shared loads inside the quads whatever the input
  auto q = [&](int v) { return quad[min(max(v, 0), nbins - 1)]; };
  for (int y = r_lo + rrow; y < r_hi; y += rows_per_pass) {
    const Weights wy = region_weights(y, by, kr);
    const int* s = src + static_cast<size_t>(y) * W + c;
    float* d = dst + static_cast<size_t>(y - y0) * W0 + (c - x0);
    if (vec) {
      const int4 v = *reinterpret_cast<const int4*>(s);
      float4 o;
      o.x = blend4(q(v.x), wy.lo, wy.hi, wx[0].lo, wx[0].hi);
      o.y = blend4(q(v.y), wy.lo, wy.hi, wx[1].lo, wx[1].hi);
      o.z = blend4(q(v.z), wy.lo, wy.hi, wx[2].lo, wx[2].hi);
      o.w = blend4(q(v.w), wy.lo, wy.hi, wx[3].lo, wx[3].hi);
      *reinterpret_cast<float4*>(d) = o;
    } else {
      *d = blend4(q(*s), wy.lo, wy.hi, wx[0].lo, wx[0].hi);
    }
  }
}

}  // namespace

// hists: [R, nbins] int32 region counts; maps: [R, nbins] f32. clim is the
// integer clip limit, scale the f32 16383 / k_elems. 1 <= nbins <= 1024.
extern "C" int mies_skimage_maps(const int* hists, float* maps, int R,
                                 int nbins, int clim, float scale,
                                 cudaStream_t stream) {
  if (R < 1 || nbins < 1 || nbins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = nbins % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(hists) |
                   reinterpret_cast<uintptr_t>(maps)) % 16 == 0;
  const unsigned blocks = (R + kMapWarps - 1) / kMapWarps;
  if (nbins <= 32 * 8) {
    skimage_maps_kernel<8><<<blocks, 32 * kMapWarps, 0, stream>>>(
        hists, maps, R, nbins, clim, scale, vec);
  } else {
    skimage_maps_kernel<32><<<blocks, 32 * kMapWarps, 0, stream>>>(
        hists, maps, R, nbins, clim, scale, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// bins: [B, H, W] int32, the padded binned image; maps: [B, nr, nc, nbins]
// f32; out: [B, H0, W0] f32, the crop whose top-left corner is (y0, x0).
// nbx, nby, rpb, strips, col_splits: kernels/clahe.py skimage_launch;
// vec_ok: bins and out rows 16-byte aligned and x0 % 4 == 0 (refused if
// the pointers say otherwise).
extern "C" int mies_skimage_apply(const int* bins, const float* maps,
                                  float* out, int B, int H, int W, int nr,
                                  int nc, int kr, int kc, int nbins, int y0,
                                  int x0, int H0, int W0, int nbx, int nby,
                                  int rpb, int strips, int col_splits,
                                  int vec_ok, cudaStream_t stream) {
  const long long blocks_x =
      static_cast<long long>(nbx) * strips * col_splits;
  if (rpb < 1 || strips < 1 || col_splits < 1 || nbins < 1 ||
      nbins > kMaxBins || nby > kMaxGridYZ || B > kMaxGridYZ ||
      blocks_x > 0x7fffffffLL ||
      (vec_ok && !(rows_aligned(bins, W) && rows_aligned(out, W0) &&
                   x0 % 4 == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), nby, B);
  skimage_apply_kernel<<<grid, kThreads, nbins * sizeof(float4), stream>>>(
      bins, maps, out, H, W, nr, nc, kr, kc, nbins, y0, x0, H0, W0, nbx, rpb,
      col_splits, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
