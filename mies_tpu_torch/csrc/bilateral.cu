// K3: k x k bilateral filter (k odd, <= 9) on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/bilateral.py:_bilateral_kernel_scratch (and
// answers _bilateral_kernel, its pre-padded twin). Per output pixel p:
//   out(p) = sum_q w(p, q) I(q) / sum_q w(p, q),
//   w(p, q) = spatial[q - p] * expf(-(I(q) - I(p))^2 * inv_two_sc2),
// the window scanned row-major, every product and sum rounded on its own
// (_rn intrinsics: nvcc contracts nothing into an FMA), expf (not __expf):
// within f32 summation-order ULPs of the plain version (atol 2e-6).
//
// Bound: at k 5 the image read and written once (8 B a pixel) just outweighs
// the symmetric form's operations: (k^2 - 1) / 2 pair weights of 5 (diff,
// square, scale, exp, spatial) and k^2 taps of 3 (product, two sums), 136 a
// pixel. The weight is symmetric: (I(q) - I(p))^2 == (I(p) - I(q))^2 exactly
// in f32 and the spatial weights of +d and -d are equal (the launch refuses
// weights that are not), so w(p, q) == w(q, p) bit for bit. The kernel
// computes each unordered pair's weight once, at its origin o for the
// half-offsets d (dy > 0, or dy == 0 < dx): (k^2 - 1) / 2 expf per pixel (12
// at k 5, where one thread per pixel computed 25), as the TPU kernel
// credited its 12 half-offsets forward and in reverse. A pixel reads its
// forward taps' weights from its own registers and its reverse taps' at
// o = p - d from shared memory, and sums all k^2 taps in the row-major order of
// the per-pixel scan, so the result is bit-equal to it; the centre tap's
// weight is spatial[0] * expf(-0 * inv_two_sc2), once per launch.
//
// Design: a block owns a strip of kStripW output columns, one thread each,
// and walks down kRunRows rows of one slice. A step stages one input row
// (the border resolved by index at load time, for any shape and distance)
// into a ring of r + 1 rows in shared memory; a thread shifts that row into
// its k x k window of registers, computes the pair weights of its origin,
// the pixel r rows up, into a ring of r + 1 rows of weights, and, after a
// barrier, sums that pixel's k^2 taps. The origins across the strip's sides
// (r columns each) and above its run (r rows) are the only ones computed by
// two blocks: 132 / 128 x 34 / 32 = 1.10 of the pixels at k 5 (a 32 x 16
// tile would recompute 1.27), the side ones spread over the threads as one
// flat list rather than given a warp of their own. k is a template
// parameter (1, 3, 5, 7, 9): every tap is unrolled, its window value and
// weight sit in registers or at a fixed offset, and no staged element pays
// a division. On an H100, runs of 32 rows ran faster than 64 (more blocks
// in flight), and one barrier a step (rings of r + 2 rows, each pixel
// summed a step later) ran no faster than two.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "strip.cuh"

namespace {

using strip::kSmemMax;

constexpr int kMaxK = 9;
constexpr int kStripW = 128;      // output columns of a strip; threads
constexpr int kRunRows = 32;      // output rows a block walks

struct Spatial {
  float half[(kMaxK * kMaxK - 1) / 2];  // by half-offset index
  float centre;
};

// The strip's geometry at kernel size K.
template <int K>
struct Geo {
  static constexpr int R = K / 2;
  static constexpr int NH = R * (K + 1);      // half-offsets: (K^2 - 1) / 2
  static constexpr int SC = kStripW + 4 * R;  // staged columns x0 - 2R ..
  static constexpr int WC = kStripW + 2 * R;  // origin columns x0 - R ..
  static constexpr int D = R + 1;             // rows in each ring
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(float)) * D * (SC + NH * WC);
  // index of the half-offset (dy, dx), dy == 0 < dx or dy > 0: its
  // row-major distance from the centre, less one
  __host__ __device__ static constexpr int h(int dy, int dx) {
    return dy * K + dx - 1;
  }
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

// the weight of the pair (origin value a, partner value q) at spatial sw
__device__ __forceinline__ float pair_weight(float a, float q, float sw,
                                             float inv_two_sc2) {
  const float d = __fsub_rn(q, a);
  return __fmul_rn(sw, expf(__fmul_rn(-__fmul_rn(d, d), inv_two_sc2)));
}

// Block (strip x, run of rows y, slice b); thread j: output column x0 + j.
template <int K>
__global__ void __launch_bounds__(kStripW)
bilateral_strip(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, const __grid_constant__ Spatial sp, float inv_two_sc2,
                int mode) {
  using G = Geo<K>;
  constexpr int R = G::R, NH = G::NH, SC = G::SC, WC = G::WC, D = G::D;
  extern __shared__ float sm[];
  float* rows = sm;          // [D][SC]: input rows s - R .. s
  float* wts = sm + D * SC;  // [D][NH][WC]: weights of origin rows o - R .. o
  const int j = threadIdx.x;
  const int b = blockIdx.z, x0 = blockIdx.x * kStripW;
  const int ys = blockIdx.y * kRunRows, ye = min(ys + kRunRows, H);
  const float* img = x + static_cast<size_t>(b) * H * W;
  // the staged columns this thread loads: j, and j + kStripW if staged
  const bool two = j + kStripW < SC;
  const int c0 = border_index(x0 - 2 * R + j, W, mode);
  const int c1 = two ? border_index(x0 - 2 * R + j + kStripW, W, mode) : 0;
  float pa = 0.0f, pb = 0.0f;  // row s's staged values, loaded a step ahead
  auto load = [&](int row) {
    const float* src = img + static_cast<size_t>(border_index(row, H, mode)) * W;
    pa = src[c0];
    if (two) pb = src[c1];
  };
  const float wc = __fmul_rn(
      sp.centre, expf(__fmul_rn(-__fmul_rn(0.0f, 0.0f), inv_two_sc2)));

  float v[K][K] = {};               // rows s - 2R .. s, columns x - R .. x + R
  float fw[NH > 0 ? NH : 1] = {};  // this thread's origin's weights
  int slot = 0;                     // ring slot of row s
  load(ys - 2 * R);
  // step s stages row s; its origin row is o = s - R, output row o once
  // o >= ys (the first 2R steps only fill the windows)
  for (int s = ys - 2 * R; s < ye + R; ++s) {
    float* srow = rows + slot * SC;
    srow[j] = pa;
    if (two) srow[j + kStripW] = pb;
    if (s + 1 < ye + R) load(s + 1);
    __syncthreads();
#pragma unroll
    for (int i = 0; i + 1 < K; ++i) {
#pragma unroll
      for (int c = 0; c < K; ++c) v[i][c] = v[i + 1][c];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) v[K - 1][c] = srow[j + R + c];
    const int ws = slot + 1 == D ? 0 : slot + 1;  // ring slot of row o
    float* wrow = wts + ws * NH * WC;
    if (s >= ys) {
      // this thread's origin (o, x0 + j): one weight per half-offset
#pragma unroll
      for (int dy = 0; dy <= R; ++dy) {
#pragma unroll
        for (int dx = -R; dx <= R; ++dx) {
          if (dy == 0 && dx <= 0) continue;
          const int h = G::h(dy, dx);
          fw[h] = pair_weight(v[R][R], v[R + dy][R + dx], sp.half[h],
                              inv_two_sc2);
          wrow[h * WC + R + j] = fw[h];
        }
      }
      // the origins across the strip's sides: columns x0 - R .. x0 - 1 and
      // x0 + kStripW .. + R - 1, one (column, half-offset) item a thread
      if constexpr (R > 0) {
        for (int i = j; i < 2 * R * NH; i += kStripW) {
          const int hc = i / NH, h = i - hc * NH;
          const int oc = hc < R ? hc : kStripW + hc;  // column - (x0 - R)
          const int dy = (h + 1 + R) / K, dx = h + 1 - dy * K;
          const int ps = ws + dy < D ? ws + dy : ws + dy - D;
          wrow[h * WC + oc] = pair_weight(rows[ws * SC + oc + R],
                                          rows[ps * SC + oc + R + dx],
                                          sp.half[h], inv_two_sc2);
        }
      }
    }
    __syncthreads();
    if (s >= ys + R && x0 + j < W) {
      // output (o, x0 + j): the k^2 taps in row-major order; a reverse tap
      // (ty, tx) < 0 reads the weight its origin (o + ty, x + tx) computed
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int ty = -R; ty <= R; ++ty) {
        const int sl = ws + ty < 0 ? ws + ty + D : ws + ty;
        const float* wr = wts + sl * NH * WC + R + j;
#pragma unroll
        for (int tx = -R; tx <= R; ++tx) {
          float w;
          if (ty < 0 || (ty == 0 && tx < 0)) {
            w = wr[G::h(-ty, -tx) * WC + tx];
          } else if (ty == 0 && tx == 0) {
            w = wc;
          } else {
            w = fw[G::h(ty, tx)];
          }
          const float q = v[R + ty][R + tx];
          num = __fadd_rn(num, __fmul_rn(w, q));
          den = __fadd_rn(den, w);
        }
      }
      out[static_cast<size_t>(b) * H * W + static_cast<size_t>(s - R) * W +
          x0 + j] = __fdiv_rn(num, den);
    }
    slot = ws;
  }
}

template <int K>
int launch(const float* x, float* out, int B, int H, int W,
           const Spatial& sp, float inv_two_sc2, int mode,
           cudaStream_t stream) {
  constexpr int smem = Geo<K>::kSmemBytes;
  static_assert(smem <= kSmemMax, "K3's rings exceed a block's memory");
  if (smem > 48 * 1024) {
    // the attribute holds per device: set it once on each (bit d: device d)
    static std::atomic<std::uint64_t> opted{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const std::uint64_t bit = dev < 64 ? std::uint64_t{1} << dev : 0;
    if (!(opted.load() & bit)) {
      err = cudaFuncSetAttribute(bilateral_strip<K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted.fetch_or(bit);
    }
  }
  const dim3 grid((W + kStripW - 1) / kStripW, (H + kRunRows - 1) / kRunRows,
                  B);
  bilateral_strip<K><<<grid, kStripW, smem, stream>>>(x, out, H, W, sp,
                                                       inv_two_sc2, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, H, W] f32. spatial: host pointer to the k*k f32 weights,
// row-major, symmetric (spatial[c + i] == spatial[c - i] about the centre
// c; the pair weights assume it). mode: 0 symmetric, 1 reflect, 2 edge.
extern "C" int mies_bilateral(const float* x, float* out, int B, int H, int W,
                              int k, const float* spatial, float inv_two_sc2,
                              int mode, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k % 2 == 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c = k * k / 2;
  Spatial sp{};
  sp.centre = spatial[c];
  for (int i = 1; i <= c; ++i) {
    if (!(spatial[c + i] == spatial[c - i])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sp.half[i - 1] = spatial[c + i];  // the half-offset Geo<k>::h = i - 1
  }
  switch (k) {
    case 1: return launch<1>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 3: return launch<3>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 5: return launch<5>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 7: return launch<7>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    default: return launch<9>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
  }
}
