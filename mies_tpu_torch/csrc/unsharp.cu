// K4: unsharp mask ('nearest' border, clipped) with the uint8 quantize
// folded in, on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/unsharp_gauss.py:_unsharp_kern_scratch (and
// answers _unsharp_kern, its pre-padded twin):
//   u = clip(x + a * (x - G*x), 0, 1),  out = clip(rint(u * 255), 0, 255)
// stored directly as uint8 (Mosaic could not store u8 and emitted int32;
// CUDA can), or u as f32. G is the separable scipy Gaussian, vertical pass
// first, then horizontal, each summed in ascending tap order with _rn
// intrinsics so nvcc cannot contract them to FMA: bit-exact against the
// plain version. The 'nearest' border is a clamp of the load index, exact
// for scipy's per-pass pads because the vertical pass of an edge-replicated
// column is the edge column of the vertical result.
//
// Design: K7's first half (csrc/unsharp_gauss.cu, csrc/strip.cuh) with the
// quantize as its epilogue. A block owns a strip of kStripW output columns
// and walks down kStripRows rows of one slice, one thread per column of the
// strip and its halo of r on each side: a thread pushes its x column's next
// row into a window of 2 r + 1 values and sums the vertical pass from it,
// the block stages those sums and x in shared memory (double-buffered by
// the step's parity: one barrier a step), and a thread sums the horizontal
// pass at its output column, blends, clips and stores. The input is read
// once per strip (1.09 of its columns at r = 6: the halo), where a 32 x 16
// tile staged with its halo read it 2.4 times, and no staged element pays
// an integer division. At the shipped radii, r 6 (radius 1.5: the flagship
// and mammogram chains) and r 4 (radius 1.0: the skimage config), the
// window and the taps sit in registers and a step takes two rows; every
// other r in 0..kMaxR runs the same body with its window in a shared-memory
// ring and its taps in shared memory, one row a step.
//
// Runs of 32 rows ran faster than K7's 64 on an H100 (twice the blocks, so
// more warps in flight); 16 ran no faster.
//
// Bound: 4 B read + 1 B (or 4 B) written per pixel; 4 (2 r + 1) + 8 f32
// operations per pixel, which the _rn arithmetic issues unfused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "strip.cuh"

namespace {

using strip::Column;
using strip::clampi;
using strip::round32;
using strip::row_dot;
using strip::unsharp;

constexpr int kMaxR = 16;       // kernels/unsharp_gauss.py MAX_RADIUS
constexpr int kStripW = 128;    // output columns of a strip
constexpr int kStripRows = 32;  // output rows a block walks

struct Taps {
  float t[2 * kMaxR + 1];
};

// u at the staged rows' column j (its first horizontal tap), stored at
// out[at] as uint8 levels or as f32
template <int N>
__device__ __forceinline__ void finish(void* out, size_t at, const float* k,
                                       const float* g1, const float* xr,
                                       int j, int r, float amount,
                                       int quantize) {
  const float u = unsharp(xr[j + r], row_dot<N>(k, g1 + j, 2 * r + 1),
                          amount);
  if (quantize) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(u, 255.0f)), 0.0f), 255.0f);
    static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(q);
  } else {
    static_cast<float*>(out)[at] = u;
  }
}

// Block (strip x, run of rows y, slice b). R > 0: the radius at compile
// time (window and taps in registers, two rows a step); R = 0: the radius
// rr at runtime (a shared-memory ring and taps, one row a step).
template <int R>
__global__ void __launch_bounds__(round32(kStripW + 2 * (R > 0 ? R : kMaxR)))
unsharp_strip(const float* __restrict__ x, void* __restrict__ out, int H,
              int W, int rr, const __grid_constant__ Taps taps, float amount,
              int quantize) {
  constexpr bool kStatic = R > 0;
  constexpr int N = kStatic ? 2 * R + 1 : 0;
  const int r = kStatic ? R : rr, n = 2 * r + 1;
  const int ng = kStripW + 2 * r;  // vertical pass: the strip and its halo
  // staged rows: the vertical pass and x at two rows, by the step's parity
  // ([2][2][ng] each)
  extern __shared__ float sm[];
  float* g1rows = sm;
  float* xrows = g1rows + 4 * ng;
  const int j = threadIdx.x;
  const int b = blockIdx.z, x0 = blockIdx.x * kStripW;
  Column<N> xc{{}, x + static_cast<size_t>(b) * H * W, H, W,
               clampi(x0 - r + j, W)};
  // the taps: registers at a compile-time radius, shared memory at runtime
  float kr[kStatic ? N : 1];
  const float* k = kr;
  if constexpr (kStatic) {
#pragma unroll
    for (int t = 0; t < N; ++t) kr[t] = taps.t[t];
  } else {
    float* ks = xrows + 4 * ng;
    for (int t = j; t < n; t += blockDim.x) ks[t] = taps.t[t];
    k = ks;
    xc.w = {ks + n + j, n, ng, 0};  // [n][ng]
    __syncthreads();
  }

  const int ys = blockIdx.y * kStripRows, ye = min(ys + kStripRows, H);
  const bool g_on = j < ng, o_on = j < kStripW && x0 + j < W;
  const size_t base = static_cast<size_t>(b) * H * W + x0 + j;
  if (g_on) xc.start(ys, r);
  int parity = 0;
  for (int u = ys; u < ye;) {
    float* g1 = g1rows + parity * 2 * ng;
    float* xr = xrows + parity * 2 * ng;
    parity ^= 1;
    if (kStatic && u + 1 < ye) {
      if (g_on) {
        xc.push2(u, r);
        g1[j] = xc.w.template dot<0>(k);
        g1[ng + j] = xc.w.template dot<1>(k);
        xr[j] = xc.w.template centre<0>();
        xr[ng + j] = xc.w.template centre<1>();
      }
      __syncthreads();
      if (o_on) {
        const size_t at = base + static_cast<size_t>(u) * W;
        finish<N>(out, at, k, g1, xr, j, r, amount, quantize);
        finish<N>(out, at + W, k, g1 + ng, xr + ng, j, r, amount, quantize);
      }
      u += 2;
      continue;
    }
    if (g_on) {
      xc.push1(u, r);
      g1[j] = xc.w.template dot<1>(k);
      xr[j] = xc.w.template centre<1>();
    }
    __syncthreads();
    if (o_on) {
      finish<N>(out, base + static_cast<size_t>(u) * W, k, g1, xr, j, r,
                amount, quantize);
    }
    ++u;
  }
}

// Shared memory bytes a block needs at radius r: at most 26,372, within the
// 48 KB a launch may take without opting in.
constexpr int smem_bytes(int r, bool runtime) {
  return static_cast<int>(sizeof(float)) *
         (8 * (kStripW + 2 * r) +
          (runtime ? (2 * r + 1) * (1 + kStripW + 2 * r) : 0));
}
static_assert(smem_bytes(kMaxR, true) <= 48 * 1024, "K4 opts in to no more");

template <int R>
int launch(const float* x, void* out, int B, int H, int W, int r,
           const Taps& t, float amount, int quantize, cudaStream_t stream) {
  const int smem = smem_bytes(r, R == 0);
  const dim3 grid((W + kStripW - 1) / kStripW,
                  (H + kStripRows - 1) / kStripRows, B);
  unsharp_strip<R><<<grid, round32(kStripW + 2 * r), smem, stream>>>(
      x, out, H, W, r, t, amount, quantize);
  return static_cast<int>(cudaGetLastError());
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
  const int r = ntaps / 2;
  switch (r) {
    case 6:  // radius 1.5 at truncate 4
      return launch<6>(x, out, B, H, W, r, t, amount, quantize, stream);
    case 4:  // radius 1.0
      return launch<4>(x, out, B, H, W, r, t, amount, quantize, stream);
    default:
      return launch<0>(x, out, B, H, W, r, t, amount, quantize, stream);
  }
}
