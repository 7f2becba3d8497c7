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
// Design (the walk in csrc/bilateral.cuh, shared with K13): a block owns a
// strip of kStripW output columns, one thread each, and walks down kRunRows
// rows of one slice, staging one input row a step into a ring of r + 1 rows
// and the pair weights of the origins r rows up into a ring of r + 1 rows.
// The origins across the strip's sides (r columns each) and above its run
// (r rows) are the only ones computed by two blocks: 132 / 128 x 34 / 32 =
// 1.10 of the pixels at k 5 (a 32 x 16 tile would recompute 1.27). On an
// H100, runs of 32 rows ran faster than 64 (more blocks in flight), and one
// barrier a step (rings of r + 2 rows, each pixel summed a step later) ran
// no faster than two.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "bilateral.cuh"
#include "strip.cuh"

namespace {

using bilat::Spatial;
using strip::kSmemMax;

constexpr int kStripW = 128;      // output columns of a strip; threads
constexpr int kRunRows = 32;      // output rows a block walks

// Block (strip x, run of rows y, slice b); thread j: output column x0 + j.
template <int K>
__global__ void __launch_bounds__(kStripW)
bilateral_strip(const float* __restrict__ x, float* __restrict__ out, int H,
                int W, const __grid_constant__ Spatial sp, float inv_two_sc2,
                int mode) {
  constexpr int R = K / 2;
  extern __shared__ float sm[];
  const int j = threadIdx.x;
  const int b = blockIdx.z, x0 = blockIdx.x * kStripW;
  const int ys = blockIdx.y * kRunRows, ye = min(ys + kRunRows, H);
  bilat::Walk<K, kStripW, kStripW> walk(
      sm, x + static_cast<size_t>(b) * H * W, H, W, x0, mode, sp,
      inv_two_sc2, ys - 2 * R);
  // step s stages row s; its origin row is o = s - R, output row o once
  // o >= ys (the first 2R steps only fill the windows)
  for (int s = ys - 2 * R; s < ye + R; ++s) {
    walk.stage(s, s + 1 < ye + R);
    __syncthreads();
    walk.weigh(s >= ys, sp, inv_two_sc2);
    __syncthreads();
    if (s >= ys + R && x0 + j < W) {
      out[static_cast<size_t>(b) * H * W + static_cast<size_t>(s - R) * W +
          x0 + j] = walk.sum();
    }
    walk.next();
  }
}

template <int K>
int launch(const float* x, float* out, int B, int H, int W,
           const Spatial& sp, float inv_two_sc2, int mode,
           cudaStream_t stream) {
  constexpr int smem = bilat::Geo<K, kStripW>::kSmemBytes;
  static_assert(smem <= kSmemMax, "K3's rings exceed a block's memory");
  static std::atomic<std::uint64_t> opted{0};
  const int err = bilat::opt_in_smem(
      reinterpret_cast<const void*>(bilateral_strip<K>), smem, opted);
  if (err != 0) return err;
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
  if (k < 1 || k > bilat::kMaxK || k % 2 == 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spatial sp;
  if (!bilat::make_spatial(spatial, k, &sp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (k) {
    case 1: return launch<1>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 3: return launch<3>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 5: return launch<5>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    case 7: return launch<7>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
    default: return launch<9>(x, out, B, H, W, sp, inv_two_sc2, mode, stream);
  }
}
