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
// kc) with one kernel for any kr, kc. One block per kr x kc interpolation
// block of the padded binned image; its four corner maps (4 x nbins f32) are
// staged in shared memory from clamped region indices, which is the
// edge-replicated map grid without a padded copy. The TPU selected map
// entries by onehot matmul because it has no gather; here they are
// shared-memory gathers. Per pixel: wy = r / kr and wx = c / kc by
// __fdiv_rn, the four coefficients with __fsub_rn/__fmul_rn, the four
// sel * coeff terms summed in corner order with __fadd_rn (nvcc would
// otherwise contract them into FMAs), floorf. Only the pixels of the
// unpadded crop are written. Bound: 4 B of bins read and 4 B written per
// output pixel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads)
skimage_apply_kernel(const int* __restrict__ bins,
                     const float* __restrict__ maps, float* __restrict__ out,
                     int H, int W, int nr, int nc, int kr, int kc, int nbins,
                     int y0, int x0, int H0, int W0) {
  extern __shared__ float corner[];  // [4][nbins]: 00, 01, 10, 11
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  // the part of this block inside the crop [y0, y0+H0) x [x0, x0+W0)
  const int ya = max(by * kr, y0), yb = min((by + 1) * kr, y0 + H0);
  const int xa = max(bx * kc, x0), xb = min((bx + 1) * kc, x0 + W0);
  if (ya >= yb || xa >= xb) return;  // block-uniform, before any barrier

  const float* mb = maps + static_cast<size_t>(b) * nr * nc * nbins;
  for (int k = threadIdx.x; k < 4 * nbins; k += blockDim.x) {
    const int e = k / nbins, bin = k % nbins;
    const int my = min(max(by - 1 + (e >> 1), 0), nr - 1);
    const int mx = min(max(bx - 1 + (e & 1), 0), nc - 1);
    corner[k] = mb[(static_cast<size_t>(my) * nc + mx) * nbins + bin];
  }
  __syncthreads();

  const int* src = bins + static_cast<size_t>(b) * H * W;
  float* dst = out + static_cast<size_t>(b) * H0 * W0;
  const int cols = xb - xa, npx = (yb - ya) * cols;
  const float fkr = static_cast<float>(kr), fkc = static_cast<float>(kc);
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int y = ya + p / cols, x = xa + p % cols;
    // the wrapper's binning keeps bins in [0, nbins)
    const int v = min(max(src[static_cast<size_t>(y) * W + x], 0), nbins - 1);
    const float wy = __fdiv_rn(static_cast<float>(y - by * kr), fkr);
    const float wx = __fdiv_rn(static_cast<float>(x - bx * kc), fkc);
    const float omy = __fsub_rn(1.0f, wy), omx = __fsub_rn(1.0f, wx);
    float acc = __fmul_rn(corner[v], __fmul_rn(omy, omx));
    acc = __fadd_rn(acc, __fmul_rn(corner[nbins + v], __fmul_rn(omy, wx)));
    acc = __fadd_rn(acc, __fmul_rn(corner[2 * nbins + v], __fmul_rn(wy, omx)));
    acc = __fadd_rn(acc, __fmul_rn(corner[3 * nbins + v], __fmul_rn(wy, wx)));
    dst[static_cast<size_t>(y - y0) * W0 + (x - x0)] = floorf(acc);
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
extern "C" int mies_skimage_apply(const int* bins, const float* maps,
                                  float* out, int B, int H, int W, int nr,
                                  int nc, int kr, int kc, int nbins, int y0,
                                  int x0, int H0, int W0,
                                  cudaStream_t stream) {
  const dim3 grid((x0 + W0 + kc - 1) / kc, (y0 + H0 + kr - 1) / kr, B);
  skimage_apply_kernel<<<grid, kThreads, 4 * nbins * sizeof(float), stream>>>(
      bins, maps, out, H, W, nr, nc, kr, kc, nbins, y0, x0, H0, W0);
  return static_cast<int>(cudaGetLastError());
}
