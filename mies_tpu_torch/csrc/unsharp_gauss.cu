// K7: unsharp mask followed by a Gaussian blur, both with scipy's 'nearest'
// border applied per 1-D pass, on [B, H, W] float32, in one kernel.
//
// Replaces mies_tpu/kernels/unsharp_gauss.py:_kern (unsharp_gauss_tpu, the
// compiler's _try_fuse_unsharp_gauss peephole of BASELINE w3):
//   U = clip(x + a * (x - G1*x), 0, 1),   out = G2*U,
// G1 and G2 separable scipy Gaussians (vertical pass, then horizontal),
// each pass summed in ascending tap order with _rn intrinsics so nvcc
// cannot contract them to FMA: bit-exact against the unfused plain pair.
//
// The border is the hard part: scipy pads PER PASS, so padding x once and
// convolving twice is wrong at the edges. Exactly:
//   * G1's pads are edge pads of x (the vertical pass commutes with column
//     replication), so x is staged by clamped index;
//   * G2's row pad replicates U's edge rows: U is computed only at image
//     positions, and the staged U rows and columns are U at the CLAMPED
//     coordinate, which G1 reads from x at clamp(clamped row -/+ r1);
//   * G2's column pad replicates the edge columns of V, the result of G2's
//     row pass: V is staged over clamped columns too.
// Design: one block per 32 x 32 output tile; the taps, x with an r1 + r2
// halo, the G1 row pass, U over an r2 halo and V sit in dynamic shared
// memory (r1 = r2 = 6: 30 KB). Bound: 4 B read + 4 B written per pixel;
// about 110 f32 operations per pixel, plus the halo's recomputation.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxR = 64;  // widest radius of each Gaussian the taps hold
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

struct Taps {
  float k1[2 * kMaxR + 1];
  float k2[2 * kMaxR + 1];
};

__device__ __forceinline__ int clampi(int i, int n) {
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
unsharp_gauss_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int H, int W, int r1, int r2, Taps taps, float amount) {
  extern __shared__ float smem[];
  const int R = r1 + r2;
  const int XW = kTile + 2 * R;   // staged x: XW x XW, clamped
  const int UW = kTile + 2 * r2;  // staged U: UW x UW
  const int n1 = 2 * r1 + 1, n2 = 2 * r2 + 1;
  float* k1 = smem;               // the taps, indexed per tap from here
  float* k2 = k1 + n1;
  float* xs = k2 + n2;            // [XW][XW]; reused for V [kTile][UW]
  float* y1 = xs + XW * XW;       // G1 row pass: [UW][XW]
  float* us = y1 + UW * XW;       // [UW][UW]
  const int b = blockIdx.z, y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int ybase = y0 - R, xbase = x0 - R;
  const int tid = threadIdx.x;
  const float* img = x + static_cast<size_t>(b) * H * W;

  if (tid < n1) k1[tid] = taps.k1[tid];
  if (tid < n2) k2[tid] = taps.k2[tid];

  for (int p = tid; p < XW * XW; p += kThreads) {
    const int i = p / XW, j = p % XW;
    xs[p] = img[static_cast<size_t>(clampi(ybase + i, H)) * W +
                clampi(xbase + j, W)];
  }
  __syncthreads();

  // G1, vertical: at U's rows (clamped) over every staged column
  for (int p = tid; p < UW * XW; p += kThreads) {
    const int i = p / XW, j = p % XW;
    const int gy = clampi(y0 - r2 + i, H);
    float acc = __fmul_rn(k1[0], xs[(clampi(gy - r1, H) - ybase) * XW + j]);
    for (int t = 1; t < n1; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k1[t],
                                     xs[(clampi(gy - r1 + t, H) - ybase) * XW + j]));
    }
    y1[p] = acc;
  }
  __syncthreads();

  // G1, horizontal, and the unsharp blend at U's (clamped) positions
  for (int p = tid; p < UW * UW; p += kThreads) {
    const int i = p / UW, j = p % UW;
    const int gy = clampi(y0 - r2 + i, H), gx = clampi(x0 - r2 + j, W);
    const float* row = y1 + i * XW;
    float g = __fmul_rn(k1[0], row[clampi(gx - r1, W) - xbase]);
    for (int t = 1; t < n1; ++t) {
      g = __fadd_rn(g, __fmul_rn(k1[t], row[clampi(gx - r1 + t, W) - xbase]));
    }
    const float xc = xs[(gy - ybase) * XW + gx - xbase];
    const float u = __fadd_rn(xc, __fmul_rn(amount, __fsub_rn(xc, g)));
    us[p] = fminf(fmaxf(u, 0.0f), 1.0f);
  }
  __syncthreads();

  // G2, vertical: V over the tile's rows and U's (clamped) columns
  float* vs = xs;
  for (int p = tid; p < kTile * UW; p += kThreads) {
    const int i = p / UW, j = p % UW;
    const float* col = us + i * UW + j;
    float acc = __fmul_rn(k2[0], col[0]);
    for (int t = 1; t < n2; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k2[t], col[t * UW]));
    }
    vs[p] = acc;
  }
  __syncthreads();

  // G2, horizontal, over V's replicated edge columns
  float* dst = out + static_cast<size_t>(b) * H * W;
  for (int p = tid; p < kTile * kTile; p += kThreads) {
    const int i = p / kTile, j = p % kTile;
    if (y0 + i >= H || x0 + j >= W) continue;
    const float* row = vs + i * UW + j;
    float acc = __fmul_rn(k2[0], row[0]);
    for (int t = 1; t < n2; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k2[t], row[t]));
    }
    dst[static_cast<size_t>(y0 + i) * W + x0 + j] = acc;
  }
}

// Shared memory bytes a block needs for Gaussians of radii r1 and r2
// (kernels/unsharp_gauss.py:unsharp_gauss_smem repeats the formula).
int smem_bytes(int r1, int r2) {
  const int XW = kTile + 2 * (r1 + r2), UW = kTile + 2 * r2;
  const int taps = 2 * (r1 + r2) + 2;
  return static_cast<int>(sizeof(float)) *
         (taps + XW * XW + UW * XW + UW * UW);
}

}  // namespace

// x, out: [B, H, W] f32. k1, k2: host pointers to the 2 r1 + 1 and 2 r2 + 1
// Gaussian taps (r1, r2 <= 64, and the staged tiles within a block's
// shared memory).
extern "C" int mies_unsharp_gauss(const float* x, float* out, int B, int H,
                                  int W, const float* k1, int n1,
                                  const float* k2, int n2, float amount,
                                  cudaStream_t stream) {
  if (n1 < 1 || n1 > 2 * kMaxR + 1 || n1 % 2 == 0 || n2 < 1 ||
      n2 > 2 * kMaxR + 1 || n2 % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r1 = n1 / 2, r2 = n2 / 2;
  const int smem = smem_bytes(r1, r2);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        unsharp_gauss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Taps t{};
  for (int i = 0; i < n1; ++i) t.k1[i] = k1[i];
  for (int i = 0; i < n2; ++i) t.k2[i] = k2[i];
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  unsharp_gauss_kernel<<<grid, kThreads, smem, stream>>>(x, out, H, W, r1, r2,
                                                          t, amount);
  return static_cast<int>(cudaGetLastError());
}
