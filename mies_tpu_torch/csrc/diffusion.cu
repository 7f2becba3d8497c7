// K9 (Perona-Malik) and K10 (SRAD): one explicit diffusion step per launch
// on [B, H, W] float32, ping-ponged between two buffers by the caller.
//
// Replace mies_tpu/kernels/diffusion.py:_pm_kernel and :_srad_kernel,
// which kept a whole slice in VMEM across every iteration; a 512^2 f32
// slice (1 MB) does not fit an SM's 228 KB, so here each iteration reads
// the last one's image from device memory (L2 at these sizes) and writes
// its own. One thread per output pixel, a 32 x 8 block, the stencil read
// directly; the borders resolved by index (no padded copy):
//   K9: forward differences, conduction g (option 1: exp(-(d/k)^2),
//       2: 1/(1 + (d/k)^2)), flux ((gamma * 1) * g) * d, backward-
//       difference divergence, zero flux across the border;
//       out = v + (div0 + div1);
//   K10: the instantaneous coefficient of variation of Yu & Acton on the
//       edge-replicated image, c clipped to [0, 1], evaluated at the pixel
//       and its south and east neighbours; past the last row / column c
//       takes the virtual-ring values C(0, 0, dW, dE) / C(dN, dS, 0, 0) of
//       the replicated ring; out = v + dt/4 (c_S dS + c dN + c_E dE + c dW);
//       q0(t) = q0 exp(-rho t) in f32 on the card each iteration.
// Every product, sum and quotient is rounded on its own (_rn intrinsics, no
// --use_fast_math: expf is the accurate one) in the plain version's order.
//
// Bound: operations per iteration (K9 about 18 f32 operations per pixel,
// K10 about 41 counting one conduction per pixel); the bytes the function
// needs are the image in and out once. Temporal blocking (several steps
// per launch on a tile with a wider halo) is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;

__device__ __forceinline__ float pm_flux(float d, float inv_k2, float gamma,
                                         int option) {
  const float d2 = __fmul_rn(d, d);
  const float g = option == 1
      ? expf(__fmul_rn(-d2, inv_k2))
      : __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(d2, inv_k2)));
  return __fmul_rn(__fmul_rn(gamma, g), d);
}

__global__ void __launch_bounds__(kTileW * kTileH)
pm_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
          float inv_k2, float gamma, int option) {
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  if (y >= H || x >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const float* v = in + base;
  const int i = y * W + x;
  const float c = v[i];
  const float f0 = pm_flux(y < H - 1 ? __fsub_rn(v[i + W], c) : 0.0f,
                           inv_k2, gamma, option);
  const float f0m = y > 0
      ? pm_flux(__fsub_rn(c, v[i - W]), inv_k2, gamma, option) : 0.0f;
  const float f1 = pm_flux(x < W - 1 ? __fsub_rn(v[i + 1], c) : 0.0f,
                           inv_k2, gamma, option);
  const float f1m = x > 0
      ? pm_flux(__fsub_rn(c, v[i - 1]), inv_k2, gamma, option) : 0.0f;
  out[base + i] = __fadd_rn(c, __fadd_rn(__fsub_rn(f0, f0m),
                                         __fsub_rn(f1, f1m)));
}

// the SRAD conduction at one position, from its four differences
__device__ __forceinline__ float srad_c(float dn, float ds, float dw, float de,
                                        float v, float q02, float eps) {
  const float ii = __fadd_rn(v, eps);
  const float g2 = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dn, dn), __fmul_rn(ds, ds)),
                          __fmul_rn(dw, dw)),
                __fmul_rn(de, de)),
      __fmul_rn(ii, ii));
  const float el =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(dn, ds), dw), de), ii);
  const float a = __fadd_rn(1.0f, __fmul_rn(0.25f, el));
  const float q2 = __fdiv_rn(
      __fsub_rn(__fmul_rn(0.5f, g2), __fmul_rn(0.0625f, __fmul_rn(el, el))),
      __fadd_rn(__fmul_rn(a, a), 1e-12f));
  const float c = __fdiv_rn(
      1.0f, __fadd_rn(1.0f, __fdiv_rn(__fsub_rn(q2, q02),
                                      __fadd_rn(__fmul_rn(q02,
                                                          __fadd_rn(1.0f, q02)),
                                                1e-12f))));
  return c != c ? c : fminf(fmaxf(c, 0.0f), 1.0f);  // clip, NaN passes
}

__global__ void __launch_bounds__(kTileW * kTileH)
srad_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
            int W, int t, float q0, float rho, float eps, float dt4) {
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  if (y >= H || x >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const float* v = in + base;
  const float q0t = __fmul_rn(q0, expf(__fmul_rn(-rho, static_cast<float>(t))));
  const float q02 = __fmul_rn(q0t, q0t);
  // the edge-replicated image
  auto at = [&](int yy, int xx) {
    return v[min(max(yy, 0), H - 1) * W + min(max(xx, 0), W - 1)];
  };
  const float vc = at(y, x);
  const float dn = __fsub_rn(at(y - 1, x), vc);
  const float ds = __fsub_rn(at(y + 1, x), vc);
  const float dw = __fsub_rn(at(y, x - 1), vc);
  const float de = __fsub_rn(at(y, x + 1), vc);
  const float c = srad_c(dn, ds, dw, de, vc, q02, eps);
  float cs, ce;
  if (y == H - 1) {
    cs = srad_c(0.0f, 0.0f, dw, de, vc, q02, eps);
  } else {
    const float vs = at(y + 1, x);
    cs = srad_c(__fsub_rn(vc, vs), __fsub_rn(at(y + 2, x), vs),
                __fsub_rn(at(y + 1, x - 1), vs), __fsub_rn(at(y + 1, x + 1), vs),
                vs, q02, eps);
  }
  if (x == W - 1) {
    ce = srad_c(dn, ds, 0.0f, 0.0f, vc, q02, eps);
  } else {
    const float ve = at(y, x + 1);
    ce = srad_c(__fsub_rn(at(y - 1, x + 1), ve), __fsub_rn(at(y + 1, x + 1), ve),
                __fsub_rn(vc, ve), __fsub_rn(at(y, x + 2), ve), ve, q02, eps);
  }
  const float div = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(cs, ds), __fmul_rn(c, dn)),
                __fmul_rn(ce, de)),
      __fmul_rn(c, dw));
  out[base + static_cast<size_t>(y) * W + x] = __fadd_rn(vc, __fmul_rn(dt4, div));
}

dim3 grid_of(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

}  // namespace

// One Perona-Malik step: in, out [B, H, W] f32 (distinct buffers);
// inv_k2 = f32(1 / kappa^2), gamma = f32(gamma), option 1 or 2.
extern "C" int mies_perona_malik(const float* in, float* out, int B, int H,
                                 int W, float inv_k2, float gamma, int option,
                                 cudaStream_t stream) {
  if (option != 1 && option != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pm_kernel<<<grid_of(B, H, W), dim3(kTileW, kTileH), 0, stream>>>(
      in, out, H, W, inv_k2, gamma, option);
  return static_cast<int>(cudaGetLastError());
}

// One SRAD step at iteration t: in, out [B, H, W] f32 (distinct buffers);
// q0, rho, eps and dt4 = f32(dt / 4) as f32 constants.
extern "C" int mies_srad(const float* in, float* out, int B, int H, int W,
                         int t, float q0, float rho, float eps, float dt4,
                         cudaStream_t stream) {
  srad_kernel<<<grid_of(B, H, W), dim3(kTileW, kTileH), 0, stream>>>(
      in, out, H, W, t, q0, rho, eps, dt4);
  return static_cast<int>(cudaGetLastError());
}
