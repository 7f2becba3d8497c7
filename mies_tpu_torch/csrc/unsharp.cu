// K4: unsharp mask ('nearest' border, clipped) with the uint8 quantize
// folded in, on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/unsharp_gauss.py:_unsharp_kern_scratch (and
// answers _unsharp_kern, its pre-padded twin):
//   u = clip(x + a * (x - G*x), 0, 1),  out = clip(rint(u * 255), 0, 255)
// stored directly as uint8 (Mosaic could not store u8 and emitted int32;
// CUDA can). G is the separable scipy Gaussian, vertical pass first, then
// horizontal, each summed in ascending tap order (acc = t0 x0; acc += ti xi)
// with _rn intrinsics so nvcc cannot contract them to FMA: the result is
// bit-exact against the plain version. Bound: 4 B read + 1 B written per
// pixel, plus 2 * ntaps FMA-free multiply-adds. Design: a 32 x 16 output
// tile per block with its r-pixel halo staged in shared memory; the
// 'nearest' border is a clamp of the load index, which is exact for
// scipy's per-pass pads because the vertical pass of an edge-replicated
// column is the edge column of the vertical result. The vertical pass
// runs over the halo columns too and stays in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 16;  // the widest halo the shared tile holds
constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kPitch = kTileW + 2 * kMaxR;

struct Taps {
  float t[2 * kMaxR + 1];
};

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
unsharp_kernel(const float* __restrict__ x, void* __restrict__ out, int H,
               int W, int r, Taps taps, float amount, int quantize) {
  __shared__ float in[(kTileH + 2 * kMaxR) * kPitch];
  __shared__ float mid[kTileH * kPitch];
  __shared__ float tp[2 * kMaxR + 1];
  const int b = blockIdx.z, y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;
  const int ntaps = 2 * r + 1;
  const float* img = x + static_cast<size_t>(b) * H * W;

  if (tid < ntaps) tp[tid] = taps.t[tid];
  const int rows = kTileH + 2 * r, cols = kTileW + 2 * r;
  for (int p = tid; p < rows * cols; p += nthreads) {
    const int ty = p / cols, tx = p % cols;
    const int sy = min(max(y0 - r + ty, 0), H - 1);
    const int sx = min(max(x0 - r + tx, 0), W - 1);
    in[ty * kPitch + tx] = img[static_cast<size_t>(sy) * W + sx];
  }
  __syncthreads();

  // vertical pass over the tile rows and every halo column
  for (int p = tid; p < kTileH * cols; p += nthreads) {
    const int ty = p / cols, tx = p % cols;
    const float* src = in + ty * kPitch + tx;
    float acc = __fmul_rn(tp[0], src[0]);
    for (int t = 1; t < ntaps; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(tp[t], src[t * kPitch]));
    }
    mid[ty * kPitch + tx] = acc;
  }
  __syncthreads();

  // horizontal pass, unsharp blend, clip and quantize
  for (int p = tid; p < kTileH * kTileW; p += nthreads) {
    const int ty = p / kTileW, tx = p % kTileW;
    const int y = y0 + ty, c = x0 + tx;
    if (y >= H || c >= W) continue;
    const float* src = mid + ty * kPitch + tx;
    float g = __fmul_rn(tp[0], src[0]);
    for (int t = 1; t < ntaps; ++t) g = __fadd_rn(g, __fmul_rn(tp[t], src[t]));
    const float xc = in[(ty + r) * kPitch + tx + r];
    float u = __fadd_rn(xc, __fmul_rn(amount, __fsub_rn(xc, g)));
    u = fminf(fmaxf(u, 0.0f), 1.0f);
    const size_t at = static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + c;
    if (quantize) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(u, 255.0f)), 0.0f), 255.0f);
      static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(q);
    } else {
      static_cast<float*>(out)[at] = u;
    }
  }
}

}  // namespace

// x: [B, H, W] f32; out: [B, H, W] uint8 if quantize else f32.
// taps: host pointer to the ntaps = 2r + 1 Gaussian taps (r <= 16).
extern "C" int mies_unsharp(const float* x, void* out, int B, int H, int W,
                            const float* taps, int ntaps, float amount,
                            int quantize, cudaStream_t stream) {
  if (ntaps < 1 || ntaps > 2 * kMaxR + 1 || ntaps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t{};
  for (int i = 0; i < ntaps; ++i) t.t[i] = taps[i];
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  unsharp_kernel<<<grid, dim3(kThreadsX, kThreadsY), 0, stream>>>(
      x, out, H, W, ntaps / 2, t, amount, quantize);
  return static_cast<int>(cudaGetLastError());
}
