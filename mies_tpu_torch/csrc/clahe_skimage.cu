// K6a + K6: the skimage (equalize_adapthist) convention of CLAHE.
//
// K6a (mies_skimage_maps) replaces XLA-side code, not a Pallas kernel:
// mies_tpu/ops/histogram.py:_clip_histogram_skimage + _skimage_maps. One
// block per region, one thread per bin. Phases 1-2 (clip, uniform spread,
// top-up of near-limit bins) use block sums; phase 3, the iterative strided
// sweep, runs in the block: each step counts the bins under the limit and
// the bins it tops up with __syncthreads_count, so the loop never returns
// to the host (the plain version synchronises with the host at every step).
// Then an inclusive block scan for the cumsum, __fmul_rn by the f32 scale
// 16383 / k_elems, min and floor. Integers until the scale: bit-equal to the
// plain version. Bound: its latency (a few KB per region, a data-dependent
// number of barrier steps), not bytes.
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

#include "cells.cuh"
#include "regions.cuh"

namespace {

constexpr int kThreads = 256;  // kernels/clahe.py THREADS
constexpr int kMaxBins = 1024;  // kernels/clahe.py MAX_BINS
constexpr int kMaxGridYZ = 65535;
constexpr float kMaxGray = 16383.0f;  // NR_OF_GRAY - 1

// Sum of one int per thread over the block (all threads must call it).
__device__ __forceinline__ int block_sum(int v, int* acc) {
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  if (v) atomicAdd(acc, v);
  __syncthreads();
  const int total = *acc;
  __syncthreads();
  return total;
}

// blockDim.x = nbins rounded up to a warp; thread t owns bin t < nbins.
__global__ void skimage_maps_kernel(const int* __restrict__ hists,
                                    float* __restrict__ maps, int nbins,
                                    int clim, float scale) {
  extern __shared__ int scan[];  // blockDim.x ints
  __shared__ int acc;
  const int t = threadIdx.x;
  const bool valid = t < nbins;
  const size_t base = static_cast<size_t>(blockIdx.x) * nbins;
  int h = valid ? hists[base + t] : 0;

  // phase 1: clip at the limit, count the excess
  int n = block_sum(h > clim ? h - clim : 0, &acc);
  h = min(h, clim);

  // phase 2: uniform spread to the bins below clim - incr, then the top-up
  // of bins at or above that (on the UPDATED hist, as skimage does)
  const int incr = n / nbins;
  const int upper = clim - incr;
  const bool low = valid && h < upper;
  n -= __syncthreads_count(low) * incr;
  if (low) h += incr;
  const bool mid = valid && h >= upper && h < clim;
  n -= block_sum(mid ? clim - h : 0, &acc);
  if (mid) h = clim;

  // phase 3: from sweep index `index`, every under-limit bin at stride
  // max(n_under / n, 1) gets one; a full sweep without progress stalls.
  // n, index and sweep_start are block-uniform, so is the loop.
  int index = 0, sweep_start = n;
  bool stalled = false;
  while (n > 0 && !stalled) {
    const bool under = valid && h < clim;
    const int step = max(__syncthreads_count(under) / max(n, 1), 1);
    const bool sel = under && t >= index && (t - index) % step == 0;
    n -= __syncthreads_count(sel);
    h += sel;
    if (++index == nbins) {
      stalled = n == sweep_start;
      sweep_start = n;
      index = 0;
    }
  }

  // inclusive scan (Hillis-Steele) of the integer counts
  scan[t] = valid ? h : 0;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const int add = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  if (valid)
    maps[base + t] =
        floorf(fminf(__fmul_rn(__int2float_rn(scan[t]), scale), kMaxGray));
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
// integer clip limit, scale the f32 16383 / k_elems. nbins <= 1024.
extern "C" int mies_skimage_maps(const int* hists, float* maps, int R,
                                 int nbins, int clim, float scale,
                                 cudaStream_t stream) {
  const int threads = (nbins + 31) / 32 * 32;
  skimage_maps_kernel<<<R, threads, threads * sizeof(int), stream>>>(
      hists, maps, nbins, clim, scale);
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
