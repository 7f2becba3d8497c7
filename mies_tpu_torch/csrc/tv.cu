// K12: TV-Chambolle denoising (skimage denoise_tv_chambolle) on [B, H, W]
// float32, each slice stopping on its own.
//
// Replaces mies_tpu/kernels/tv.py:_tv_kernel, which held a whole 512^2
// slice and its dual field in VMEM for the whole while loop; a 1 MB slice
// does not fit an SM's 228 KB, so here one step of the loop is two
// kernels, launched by mies_tv_step:
//   A (tv_update), one thread per pixel: the divergence d of the old dual
//     field p, out = img + d, the forward gradient g of out (neighbours'
//     out recomputed from p), |g|, and the new p written to the other
//     buffer (neighbours read the old p); per block, the sums of d^2 and
//     |g| in float64, by a fixed tree;
//   B (tv_energy), one block per slice: the block sums in a fixed order,
//     then the slice's state (iteration, E_prev, E_init, stop), exactly the
//     reference's loop test: E = (sum d^2 + weight sum |g|) / size, stop
//     when |E_prev - E| < eps E_init from the second iteration.
// A stopped slice's blocks return at once, so its out stays that of the
// iteration in which stop turned true (vmap-of-while semantics). The
// caller runs max_num_iter steps: the launch count is fixed by the config,
// nothing waits on the host, and no float atomics make reruns differ.
// Sums are float64 rounded to float32 once (near-exact, so the stop
// iteration is reproducible); per-pixel arithmetic is _rn throughout.
//
// Bound: operations (about 22 f32 operations per pixel and iteration);
// the bytes the function needs are img in and out once. This first kernel
// re-reads p, img and out from device memory (L2) every step.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

// d = -(p1 + p2) + p1(y-1) + p2(x-1), zero beyond the first row / column
__device__ __forceinline__ float tv_div(const float* p1, const float* p2,
                                        int y, int x, int W) {
  const int i = y * W + x;
  float v = -__fadd_rn(p1[i], p2[i]);
  v = __fadd_rn(v, y > 0 ? p1[i - W] : 0.0f);
  return __fadd_rn(v, x > 0 ? p2[i - 1] : 0.0f);
}

__device__ __forceinline__ void block_sum2(double* a, double* b, int tid) {
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      a[tid] += a[tid + s];
      b[tid] += b[tid + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
tv_update(const float* __restrict__ img, const float* __restrict__ p_in,
          float* __restrict__ p_out, float* __restrict__ out,
          double* __restrict__ partial, const int* __restrict__ stop, int B,
          int H, int W, float tau_w) {
  const int b = blockIdx.z;
  if (stop[b]) return;  // the whole block belongs to slice b
  __shared__ double s_dd[kThreads], s_nrm[kThreads];
  const size_t plane = static_cast<size_t>(B) * H * W;
  const size_t slice = static_cast<size_t>(b) * H * W;
  const float* p1 = p_in + slice;
  const float* p2 = p_in + plane + slice;
  const float* im = img + slice;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  double dd = 0.0, nrm = 0.0;
  if (y < H && x < W) {
    const int i = y * W + x;
    const float d = tv_div(p1, p2, y, x, W);
    const float o = __fadd_rn(im[i], d);
    const float g1 = y < H - 1
        ? __fsub_rn(__fadd_rn(im[i + W], tv_div(p1, p2, y + 1, x, W)), o)
        : 0.0f;
    const float g2 = x < W - 1
        ? __fsub_rn(__fadd_rn(im[i + 1], tv_div(p1, p2, y, x + 1, W)), o)
        : 0.0f;
    const float norm =
        __fsqrt_rn(__fadd_rn(__fmul_rn(g1, g1), __fmul_rn(g2, g2)));
    const float factor = __fadd_rn(1.0f, __fmul_rn(tau_w, norm));
    p_out[slice + i] = __fdiv_rn(__fsub_rn(p1[i], __fmul_rn(0.25f, g1)), factor);
    p_out[plane + slice + i] =
        __fdiv_rn(__fsub_rn(p2[i], __fmul_rn(0.25f, g2)), factor);
    out[slice + i] = o;
    dd = static_cast<double>(__fmul_rn(d, d));
    nrm = static_cast<double>(norm);
  }
  s_dd[tid] = dd;
  s_nrm[tid] = nrm;
  block_sum2(s_dd, s_nrm, tid);
  if (tid == 0) {
    const size_t nb = static_cast<size_t>(gridDim.x) * gridDim.y;
    const size_t k = (b * nb + blockIdx.y * gridDim.x + blockIdx.x) * 2;
    partial[k] = s_dd[0];
    partial[k + 1] = s_nrm[0];
  }
}

__global__ void __launch_bounds__(kThreads)
tv_energy(const double* __restrict__ partial, int nb, int* __restrict__ iters,
          float* __restrict__ e_prev, float* __restrict__ e_init,
          int* __restrict__ stop, float weight, float eps, float size) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (stop[b]) return;
  __shared__ double s_dd[kThreads], s_nrm[kThreads];
  double dd = 0.0, nrm = 0.0;
  for (int j = tid; j < nb; j += kThreads) {
    const size_t k = (static_cast<size_t>(b) * nb + j) * 2;
    dd += partial[k];
    nrm += partial[k + 1];
  }
  s_dd[tid] = dd;
  s_nrm[tid] = nrm;
  block_sum2(s_dd, s_nrm, tid);
  if (tid == 0) {
    const float e_dd = static_cast<float>(s_dd[0]);
    const float e_n = static_cast<float>(s_nrm[0]);
    const float e = __fdiv_rn(__fadd_rn(e_dd, __fmul_rn(weight, e_n)), size);
    const int i = iters[b];
    const float ei = i == 0 ? e : e_init[b];
    const bool st = i > 0 && fabsf(__fsub_rn(e_prev[b], e)) < __fmul_rn(eps, ei);
    e_init[b] = ei;
    e_prev[b] = e;
    stop[b] = st ? 1 : 0;
    iters[b] = i + 1;
  }
}

}  // namespace

// One iteration. img, out: [B, H, W] f32; p_in, p_out: [2, B, H, W] f32
// (p1 then p2); partial: B * ceil(W/32) * ceil(H/8) * 2 f64 scratch;
// iters, stop: [B] int32 and e_prev, e_init: [B] f32, zero before the first
// step. tau_w = f32(0.25) / f32(weight); size = f32(H * W).
extern "C" int mies_tv_step(const float* img, const float* p_in, float* p_out,
                            float* out, double* partial, int* iters,
                            float* e_prev, float* e_init, int* stop, int B,
                            int H, int W, float weight, float eps, float tau_w,
                            float size, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  tv_update<<<grid, dim3(kTileW, kTileH), 0, stream>>>(
      img, p_in, p_out, out, partial, stop, B, H, W, tau_w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tv_energy<<<B, kThreads, 0, stream>>>(partial, grid.x * grid.y, iters,
                                        e_prev, e_init, stop, weight, eps,
                                        size);
  return static_cast<int>(cudaGetLastError());
}
