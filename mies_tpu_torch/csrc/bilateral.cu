// K3: k x k bilateral filter (k odd, <= 9) on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/bilateral.py:_bilateral_kernel_scratch (and
// answers _bilateral_kernel, its pre-padded twin). Per output pixel p:
//   out(p) = sum_q w(p, q) I(q) / sum_q w(p, q),
//   w(p, q) = spatial[dy, dx] * expf(-(I(q) - I(p))^2 * inv_two_sc2).
// Bound: the k^2 expf per pixel (25 at k = 5) on the SFUs and FMA pipes;
// the image itself is read once. Design: one thread per output pixel, a
// 32 x 8 output tile per block with its r-pixel halo staged in shared
// memory (the border resolved at load time, so no padded copy of the
// image exists), and a row-major scan of the window. The TPU kernel halved
// its exp count with symmetric pairs, which pays off only when a whole
// strip lives in one core's registers; here that is left to a later
// change. expf (not __expf) and _rn intrinsics keep the arithmetic within
// f32 summation-order ULPs of the plain version (atol 2e-6).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 9;
constexpr int kMaxR = kMaxK / 2;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kPitch = kTileW + 2 * kMaxR;

struct Spatial {
  float w[kMaxK * kMaxK];
};

// np.pad source index of position i on an axis of length n, at any distance.
// mode 0: numpy 'symmetric' (scipy 'reflect'): d c b a | a b c d | d c b a
// mode 1: numpy 'reflect' (scipy 'mirror'):    d c b | a b c d | c b a
// mode 2: numpy 'edge' (scipy 'nearest')
__device__ __forceinline__ int border_index(int i, int n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == 2) return min(max(i, 0), n - 1);
  if (mode == 0) {
    const int p = 2 * n;
    const int m = ((i % p) + p) % p;
    return m < n ? m : p - 1 - m;
  }
  if (n == 1) return 0;
  const int p = 2 * n - 2;
  const int m = ((i % p) + p) % p;
  return m < n ? m : p - m;
}

__global__ void __launch_bounds__(kTileW * kTileH)
bilateral_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                 int W, int k, Spatial spatial, float inv_two_sc2, int mode) {
  __shared__ float tile[(kTileH + 2 * kMaxR) * kPitch];
  __shared__ float sw[kMaxK * kMaxK];
  const int r = k / 2;
  const int b = blockIdx.z, y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float* img = x + static_cast<size_t>(b) * H * W;

  if (tid < k * k) sw[tid] = spatial.w[tid];
  const int rows = kTileH + 2 * r, cols = kTileW + 2 * r;
  for (int p = tid; p < rows * cols; p += kTileW * kTileH) {
    const int ty = p / cols, tx = p % cols;
    const int sy = border_index(y0 - r + ty, H, mode);
    const int sx = border_index(x0 - r + tx, W, mode);
    tile[ty * kPitch + tx] = img[static_cast<size_t>(sy) * W + sx];
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, c = x0 + threadIdx.x;
  if (y >= H || c >= W) return;
  const float center = tile[(threadIdx.y + r) * kPitch + threadIdx.x + r];
  float num = 0.0f, den = 0.0f;
  for (int dy = 0; dy < k; ++dy) {
    const float* row = tile + (threadIdx.y + dy) * kPitch + threadIdx.x;
    for (int dx = 0; dx < k; ++dx) {
      const float q = row[dx];
      const float d = __fsub_rn(q, center);
      const float e = expf(__fmul_rn(-__fmul_rn(d, d), inv_two_sc2));
      const float wgt = __fmul_rn(sw[dy * k + dx], e);
      num = __fadd_rn(num, __fmul_rn(wgt, q));
      den = __fadd_rn(den, wgt);
    }
  }
  out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + c] =
      __fdiv_rn(num, den);
}

}  // namespace

// x, out: [B, H, W] f32. spatial: host pointer to k*k f32 weights (copied
// into the launch's arguments). mode: 0 symmetric, 1 reflect, 2 edge.
extern "C" int mies_bilateral(const float* x, float* out, int B, int H, int W,
                              int k, const float* spatial, float inv_two_sc2,
                              int mode, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k % 2 == 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spatial sp{};
  for (int t = 0; t < k * k; ++t) sp.w[t] = spatial[t];
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  bilateral_kernel<<<grid, dim3(kTileW, kTileH), 0, stream>>>(
      x, out, H, W, k, sp, inv_two_sc2, mode);
  return static_cast<int>(cudaGetLastError());
}
