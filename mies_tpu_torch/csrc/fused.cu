// K13: bilateral filter (k odd, <= 9) -> unsharp mask ('nearest' border on
// the bilateral OUTPUT, clipped) -> optional uint8 quantize, on [B, H, W]
// float32, in one kernel.
//
// Replaces mies_tpu/kernels/fused.py:_fused_kernel (bilateral_unsharp_tpu,
// the opt-in tail of the flagship chain under MIES_TPU_FUSE_TAIL=1):
//   Bl = bilateral(x),  u = clip(Bl + a * (Bl - G*Bl), 0, 1),
//   out = clip(rint(u * 255), 0, 255) as uint8, or u as f32.
// The arithmetic is K3's (csrc/bilateral.cu: row-major window scan, expf,
// _rn intrinsics, one __fdiv_rn) followed by K4's (csrc/unsharp.cu: the
// vertical Gaussian pass, then the horizontal one, each in ascending tap
// order), so K13 is bit-equal to K3 -> K4 on the card.
//
// The border is the hard part. The unfused unsharp pads the bilateral
// OUTPUT by edge replication (scipy 'nearest', per pass), not the padded
// input: so the bilateral is computed at the tile plus an rg halo taken at
// CLAMPED image coordinates, and the out-of-image halo is the edge
// bilateral value itself (the vertical pass of an edge-replicated column is
// the edge column of the vertical result, as in K4). The bilateral reads
// its own border by index (numpy symmetric / reflect / edge, as K3).
// Design: one block per 64 x 64 output tile and image; the input with an
// rb + rg halo, then the bilateral over the tile + rg halo, sit in dynamic
// shared memory, and the vertical pass reuses the input's space
// (rb = 2, rg = 6: 48.7 KB). Bound: 4 B read + 1 B (or 4 B) written per
// pixel; the bilateral's k^2 expf per position, over (64 + 2 rg)^2 / 64^2
// = 1.41 positions per output pixel at rg = 6 (the halo recomputation the
// fusion pays for skipping one write and one read of the bilateral).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 9;
constexpr int kMaxRg = 64;        // widest Gaussian radius the taps hold
constexpr int kTile = 64;         // output tile, rows and columns
constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

struct Params {
  float spatial[kMaxK * kMaxK];
  float taps[2 * kMaxRg + 1];
};

// np.pad source index of position i on an axis of length n, at any distance
// (K3's): mode 0 numpy 'symmetric' (scipy 'reflect'), 1 numpy 'reflect'
// (scipy 'mirror'), 2 numpy 'edge' (scipy 'nearest').
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

__device__ __forceinline__ int clampi(int i, int n) {
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
bilateral_unsharp_kernel(const float* __restrict__ x, void* __restrict__ out,
                         int H, int W, int k, int rg, Params prm,
                         float inv_two_sc2, int mode, float amount,
                         int quantize) {
  extern __shared__ float smem[];
  const int rb = k / 2, R = rb + rg;
  const int XW = kTile + 2 * R;   // staged input: XW x XW, border by index
  const int BW = kTile + 2 * rg;  // bilateral: BW x BW, clamped positions
  const int nt = 2 * rg + 1;
  float* sw = smem;               // k * k spatial weights
  float* tp = sw + k * k;         // nt taps
  float* xs = tp + nt;            // [XW][XW]; then the vertical pass [kTile][BW]
  float* bs = xs + XW * XW;       // [BW][BW]
  const int b = blockIdx.z, y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int ybase = y0 - R, xbase = x0 - R;
  const int tid = threadIdx.x;
  const float* img = x + static_cast<size_t>(b) * H * W;

  if (tid < k * k) sw[tid] = prm.spatial[tid];
  if (tid < nt) tp[tid] = prm.taps[tid];
  for (int p = tid; p < XW * XW; p += kThreads) {
    const int i = p / XW, j = p % XW;
    xs[p] = img[static_cast<size_t>(border_index(ybase + i, H, mode)) * W +
                border_index(xbase + j, W, mode)];
  }
  __syncthreads();

  // the bilateral at each staged position's clamped image coordinate
  for (int p = tid; p < BW * BW; p += kThreads) {
    const int i = p / BW, j = p % BW;
    const int sy = clampi(y0 - rg + i, H) - ybase;
    const int sx = clampi(x0 - rg + j, W) - xbase;
    const float center = xs[sy * XW + sx];
    float num = 0.0f, den = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      const float* row = xs + (sy - rb + dy) * XW + sx - rb;
      for (int dx = 0; dx < k; ++dx) {
        const float q = row[dx];
        const float d = __fsub_rn(q, center);
        const float e = expf(__fmul_rn(-__fmul_rn(d, d), inv_two_sc2));
        const float wgt = __fmul_rn(sw[dy * k + dx], e);
        num = __fadd_rn(num, __fmul_rn(wgt, q));
        den = __fadd_rn(den, wgt);
      }
    }
    bs[p] = __fdiv_rn(num, den);
  }
  __syncthreads();

  // vertical Gaussian pass over the tile's rows and every staged column
  float* vs = xs;
  for (int p = tid; p < kTile * BW; p += kThreads) {
    const int i = p / BW, j = p % BW;
    const float* col = bs + i * BW + j;
    float acc = __fmul_rn(tp[0], col[0]);
    for (int t = 1; t < nt; ++t) acc = __fadd_rn(acc, __fmul_rn(tp[t], col[t * BW]));
    vs[p] = acc;
  }
  __syncthreads();

  // horizontal pass, unsharp blend, clip and quantize
  for (int p = tid; p < kTile * kTile; p += kThreads) {
    const int i = p / kTile, j = p % kTile;
    const int y = y0 + i, c = x0 + j;
    if (y >= H || c >= W) continue;
    const float* row = vs + i * BW + j;
    float g = __fmul_rn(tp[0], row[0]);
    for (int t = 1; t < nt; ++t) g = __fadd_rn(g, __fmul_rn(tp[t], row[t]));
    const float xc = bs[(i + rg) * BW + j + rg];
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

// Shared memory bytes of a block for a k x k bilateral and a Gaussian of
// radius rg (kernels/fused.py:smem_bytes repeats the formula).
int smem_bytes(int k, int rg) {
  const int XW = kTile + 2 * (k / 2 + rg), BW = kTile + 2 * rg;
  return static_cast<int>(sizeof(float)) *
         (k * k + 2 * rg + 1 + XW * XW + BW * BW);
}

}  // namespace

// x: [B, H, W] f32; out: [B, H, W] uint8 if quantize else f32.
// spatial: host pointer to the k*k bilateral spatial weights; taps: host
// pointer to the nt = 2 rg + 1 Gaussian taps (rg <= 64). mode: 0
// symmetric, 1 reflect, 2 edge (the bilateral's border).
extern "C" int mies_bilateral_unsharp(const float* x, void* out, int B, int H,
                                      int W, int k, const float* spatial,
                                      float inv_two_sc2, int mode,
                                      const float* taps, int nt, float amount,
                                      int quantize, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k % 2 == 0 || mode < 0 || mode > 2 || nt < 3 ||
      nt > 2 * kMaxRg + 1 || nt % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rg = nt / 2;
  const int smem = smem_bytes(k, rg);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_unsharp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params prm{};
  for (int t = 0; t < k * k; ++t) prm.spatial[t] = spatial[t];
  for (int t = 0; t < nt; ++t) prm.taps[t] = taps[t];
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  bilateral_unsharp_kernel<<<grid, kThreads, smem, stream>>>(
      x, out, H, W, k, rg, prm, inv_two_sc2, mode, amount, quantize);
  return static_cast<int>(cudaGetLastError());
}
