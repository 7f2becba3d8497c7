// K11: non-local means (skimage fast_mode semantics) on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/nlmeans.py:_nlm_chunk_kernel (the TPU ran the
// 84-pair table of d = 6 as ceil(84/12) chunked kernels only to bound its
// compile time; here the whole table runs in one launch). Per output pixel
// p and per pair {t, -t} of the half shift table, in table order:
//   S_f = sum_k (u(p+k) - u(p+t+k))^2,   S_r = sum_k (u(p-t+k) - u(p+k))^2
//   w = exp(-D) if D <= 5 else 0,        D = max(S - bias, 0) * inv_h2sn
//   num += w_f u(p+t) + w_r u(p-t),      den += w_f + w_r
//   out = (num + 2 u(p)) / (den + 2)
// over the numpy-'reflect' extension u of the slice (reads never leave the
// offset + d wide extension, so no edge ring is needed). Each box sums the
// rows of a column, then the columns in ascending order: the plain
// version's shifted-add order, with every product and sum rounded on its
// own (_rn intrinsics; no --use_fast_math, so expf is the accurate one).
//
// Bound: operations. A box per pair and pixel is the least work (21 f32
// operations per pair and pixel at s = 5, the pair's two ends sharing one
// box field); this first kernel computes both ends' boxes directly, 2 s^2
// squared differences per pair and pixel, from shared memory. Design: one
// thread per output pixel, a 32 x 8 tile per block, the tile and its
// offset + d halo staged once in shared memory (the reflect resolved by
// index at load), the pair loop in registers. Shared memory bounds the
// halo: (8 + 2R)(32 + 2R) floats for R = s/2 + d, at most 227 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr float kCutoff = 5.0f;

// numpy 'reflect' source index (d c b | a b c d | c b a) at any distance;
// the pixels a thread computes read within one bounce, the tile's ragged
// overhang may read further and is never used
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int p = 2 * n - 2;
  const int m = ((i % p) + p) % p;
  return m < n ? m : p - m;
}

__device__ __forceinline__ float nlm_weight(float ssd, float bias,
                                            float inv_h2sn) {
  const float dist = __fmul_rn(fmaxf(__fsub_rn(ssd, bias), 0.0f), inv_h2sn);
  return dist <= kCutoff ? expf(-dist) : 0.0f;
}

__global__ void __launch_bounds__(kTileW * kTileH)
nlm_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
           int s, int d, float bias, float inv_h2sn) {
  extern __shared__ float tile[];
  const int off = s / 2, R = off + d;
  const int pitch = kTileW + 2 * R, rows = kTileH + 2 * R;
  const int b = blockIdx.z, y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float* img = x + static_cast<size_t>(b) * H * W;
  for (int p = tid; p < rows * pitch; p += kTileW * kTileH) {
    const int sy = reflect_index(y0 - R + p / pitch, H);
    const int sx = reflect_index(x0 - R + p % pitch, W);
    tile[p] = img[static_cast<size_t>(sy) * W + sx];
  }
  __syncthreads();

  const int y = y0 + threadIdx.y, c = x0 + threadIdx.x;
  if (y >= H || c >= W) return;
  const float* p0 = tile + (threadIdx.y + R) * pitch + threadIdx.x + R;
  float num = 0.0f, den = 0.0f;
  // the half table in its order: t = (ty, tx), first nonzero component > 0
  for (int ty = 0; ty <= d; ++ty) {
    for (int tx = (ty == 0 ? 1 : -d); tx <= d; ++tx) {
      const int t = ty * pitch + tx;
      float sf = 0.0f, sr = 0.0f;
      for (int kx = -off; kx <= off; ++kx) {
        float cf = 0.0f, cr = 0.0f;
        for (int ky = -off; ky <= off; ++ky) {
          const float* q = p0 + ky * pitch + kx;
          const float a = q[0];
          const float df = __fsub_rn(a, q[t]);
          const float dr = __fsub_rn(q[-t], a);
          cf = __fadd_rn(cf, __fmul_rn(df, df));
          cr = __fadd_rn(cr, __fmul_rn(dr, dr));
        }
        sf = __fadd_rn(sf, cf);
        sr = __fadd_rn(sr, cr);
      }
      const float wf = nlm_weight(sf, bias, inv_h2sn);
      const float wr = nlm_weight(sr, bias, inv_h2sn);
      num = __fadd_rn(num, __fadd_rn(__fmul_rn(wf, p0[t]),
                                     __fmul_rn(wr, p0[-t])));
      den = __fadd_rn(den, __fadd_rn(wf, wr));
    }
  }
  out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + c] =
      __fdiv_rn(__fadd_rn(num, __fmul_rn(2.0f, p0[0])), __fadd_rn(den, 2.0f));
}

}  // namespace

// x, out: [B, H, W] f32. s: odd patch size; d: patch distance; bias and
// inv_h2sn: the f32 constants. The caller checks s/2 + d <= min(H, W) - 1.
extern "C" int mies_nl_means(const float* x, float* out, int B, int H, int W,
                             int s, int d, float bias, float inv_h2sn,
                             cudaStream_t stream) {
  if (s < 1 || s % 2 == 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int R = s / 2 + d;
  const size_t smem = static_cast<size_t>(kTileH + 2 * R) *
                      (kTileW + 2 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  nlm_kernel<<<grid, dim3(kTileW, kTileH), smem, stream>>>(
      x, out, H, W, s, d, bias, inv_h2sn);
  return static_cast<int>(cudaGetLastError());
}
