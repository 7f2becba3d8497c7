// K13: bilateral filter (k odd, <= 9) -> unsharp mask ('nearest' border on
// the bilateral OUTPUT, clipped) -> optional uint8 quantize, on [B, H, W]
// float32, in one kernel.
//
// Replaces mies_tpu/kernels/fused.py:_fused_kernel (bilateral_unsharp_tpu,
// the opt-in tail of the flagship chain under MIES_TPU_FUSE_TAIL=1):
//   Bl = bilateral(x),  u = clip(Bl + a * (Bl - G*Bl), 0, 1),
//   out = clip(rint(u * 255), 0, 255) as uint8, or u as f32.
// The arithmetic is K3's (the pair-weight walk of csrc/bilateral.cuh,
// included, not copied) followed by K4's (csrc/strip.cuh: the vertical
// Gaussian pass from a column window, then the horizontal one, each in
// ascending tap order, then strip::unsharp and the quantize), so K13 is
// bit-equal to K3 -> K4 on the card wherever K4 takes the radius.
//
// Design: K3's strip walk feeding K4's column windows in one block. A block
// owns kStripW output columns (at the register radii rg 6 and 4; at any other
// rg a kWideW-column bilateral strip owns kWideW - 2 rg of them) and walks down
// a run of kRunRows rows of one slice, one thread per bilateral column of the
// strip and its rg halo on each side. Step s of K3's walk gives the bilateral
// row o = s - R at every column of the strip; the next step's threads push it
// into their Window<2 rg + 1> (registers at rg 6 and 4, a shared-memory ring at
// other radii) and stage the vertical sum of output row o - rg; after the
// step's second barrier the output threads sum the horizontal pass and blend,
// clip and store. Two barriers a step, K3's own: the bilateral row and the
// vertical sums are staged once each. Each phase issues its shared loads before
// its stores. The steps where every part runs (all but the run's first 3 R + 2
// rg + 1 and last few) are compiled apart, without the per-step conditions that
// a predicated step would still issue. On an H100, strips of 256 output columns
// (288 threads, two blocks an SM) ran faster than 128 and 64, and runs of 128
// rows (kRunRows) faster than 32, 64 and 256 (PERF.md section 6).
//
// The border is the hard part. The unfused unsharp pads the bilateral
// OUTPUT by edge replication (scipy 'nearest', per pass), not the input: a
// bilateral column outside the image does no tap sum and pushes the
// bilateral of the clamped column (read from the staged row), since the
// vertical pass of an edge-replicated column is the edge column's vertical
// result; a run at the top or bottom of the image pushes bilateral row 0 or
// H - 1 again, once per row of the halo above 0 or below H - 1. The
// bilateral reads its own border by index (numpy symmetric / reflect /
// edge), as K3.
//
// Bound: 4 B read + 1 B (or 4 B) written per pixel against K3's 136 and
// K4's 4 (2 rg + 1) + 8 operations a pixel (196 at k 5, rg 6), which the
// _rn arithmetic issues unfused: the operations bind. The walk computes the
// bilateral at (kRunRows + 2 rg) / kRunRows x (kStripW + 2 rg) / kStripW
// positions per output pixel (1.15 at rg 6; K3 alone 1.10), on
// 288 threads for 268 columns: the halo recomputation the fusion pays for
// skipping one write and one read of the bilateral image and a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "bilateral.cuh"
#include "strip.cuh"

namespace {

using bilat::Spatial;
using strip::clampi;
using strip::kSmemMax;
using strip::round32;
using strip::row_dot;
using strip::unsharp;
using strip::Window;

constexpr int kMaxRg = 63;    // kernels/fused.py MAX_RADIUS
// kernels/fused.py STRIP_W: output columns at rg 6 and 4
constexpr int kStripW = 256;
// kernels/fused.py WIDE_W: bilateral columns at other rg
constexpr int kWideW = 128;
constexpr int kRunRows = 128; // output rows a block walks

struct Taps {
  float t[2 * kMaxRg + 1];
};

// bilateral columns (threads that compute one) of a strip at radius RG
// (0: a runtime radius)
template <int RG>
__host__ __device__ constexpr int strip_cols() {
  return RG > 0 ? kStripW + 2 * RG : kWideW;
}

// shared memory floats of a block at kernel size K and radius rg
// (kernels/fused.py smem_bytes repeats the formula): K3's rings, the
// staged bilateral row and vertical sums, and at a runtime radius the taps
// and a ring of 2 rg + 1 bilateral rows
template <int K, int RG>
constexpr int smem_floats(int rg) {
  constexpr int BW = strip_cols<RG>();
  return bilat::Geo<K, BW>::kFloats + 2 * BW +
         (RG > 0 ? 0 : (2 * rg + 1) * (1 + BW));
}

// blocks an SM must hold at once: at k <= 5 two blocks of the register
// radii's 288 threads (a cap of 113 registers, the 96 they take at k 5);
// k 7 and 9 take more registers than two blocks leave, so no floor
template <int K>
__host__ __device__ constexpr int min_blocks() {
  return K <= 5 ? 2 : 1;
}

// Block (strip x, run of rows y, slice b); thread j: bilateral column
// x0 - rg + j. RG > 0: the radius at compile time; RG = 0: rr at runtime.
template <int K, int RG>
__global__ void __launch_bounds__(round32(strip_cols<RG>()), min_blocks<K>())
bilateral_unsharp_strip(const float* __restrict__ x, void* __restrict__ out,
                        int H, int W, int rr,
                        const __grid_constant__ Spatial sp,
                        float inv_two_sc2, int mode,
                        const __grid_constant__ Taps taps, float amount,
                        int quantize) {
  constexpr bool kStatic = RG > 0;
  constexpr int BW = strip_cols<RG>(), T = round32(BW);
  constexpr int N = kStatic ? 2 * RG + 1 : 0;
  constexpr int R = K / 2;
  const int rg = kStatic ? RG : rr, n = 2 * rg + 1;
  const int ow = BW - 2 * rg;  // output columns of the strip
  extern __shared__ float sm[];
  float* brow = sm + bilat::Geo<K, BW>::kFloats;  // [BW] bilateral row o
  float* g1 = brow + BW;  // [BW] the vertical pass of output row u
  const int j = threadIdx.x, b = blockIdx.z;
  const int x0 = blockIdx.x * ow, xb = x0 - rg;
  const int ys = blockIdx.y * kRunRows, ye = min(ys + kRunRows, H);
  // the bilateral rows the run needs, cut to the image
  const int bs = max(ys - rg, 0), be = min(ye + rg, H);
  const float* k = taps.t;
  Window<N> win;
  if constexpr (!kStatic) {
    float* ks = g1 + BW;  // [n] taps, then the ring [n][BW]
    for (int t = j; t < n; t += T) ks[t] = taps.t[t];
    k = ks;  // read after the loop's first barrier
    win = {ks + n + j, n, BW, 0};
  }
  bilat::Walk<K, BW, T> walk(sm, x + static_cast<size_t>(b) * H * W, H, W,
                             xb, mode, sp, inv_two_sc2, bs - 2 * R);
  const int c = xb + j;  // this thread's bilateral column
  const bool col_on = j < BW;
  const bool in_image = col_on && c >= 0 && c < W;
  const int jc = clampi(c, W) - xb;  // the staged column it pushes
  const bool out_on = j >= rg && j < rg + ow && c < W;
  const size_t slice = static_cast<size_t>(b) * H * W;

  // K3's step s computes bilateral row s - R (s < be + R); step s pushes
  // the row computed a step ago, v = s - 1 - R (past be - 1: row be - 1
  // again), and stages the vertical pass of output row u = v - rg. Each
  // phase reads shared memory before it writes any, so no load waits on a
  // store it cannot be told apart from. A hot step (kHot) is one where all
  // of that happens, decided at compile time.
  auto step = [&](int s, auto hot) {
    constexpr bool kHot = decltype(hot)::value;
    const bool bil = kHot || s < be + R;
    if (bil) walk.stage(s, kHot || s + 1 < be + R);
    __syncthreads();
    const int v = s - 1 - R, u = v - rg;
    const bool push = (kHot || v >= bs) && col_on;
    const float bv = push ? brow[jc] : 0.0f;
    if (bil) walk.weigh(kHot || s >= bs, sp, inv_two_sc2);
    if (push) {
      // row bs stands for the halo rows above it too (bs > ys - rg only
      // at row 0)
      const int again = kHot || v != bs ? 0 : bs - (ys - rg);
      for (int t = again; t >= 0; --t) win.push(bv);
      if (kHot || u >= ys) g1[j] = win.template dot<1>(k);
    }
    __syncthreads();
    const bool emit = (kHot || u >= ys) && out_on;
    const float g = emit ? row_dot<N>(k, g1 + j - rg, n) : 0.0f;
    const bool sum = bil && (kHot || s >= bs + R) && in_image;
    const float bl = sum ? walk.sum() : 0.0f;
    if (sum) brow[j] = bl;
    if (emit) {
      const float r = unsharp(win.template centre<1>(), g, amount);
      const size_t at = slice + static_cast<size_t>(u) * W + c;
      if (quantize) {
        const float q =
            fminf(fmaxf(rintf(__fmul_rn(r, 255.0f)), 0.0f), 255.0f);
        static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(q);
      } else {
        static_cast<float*>(out)[at] = r;
      }
    }
    if (bil) walk.next();
  };
  const int last = ye + rg + R;
  const int hot_lo = max(bs + R + 2, ys + rg + R + 1), hot_hi = be + R - 2;
  int s = bs - 2 * R;
  for (; s <= last && s < hot_lo; ++s) step(s, std::false_type{});
  for (; s <= hot_hi; ++s) step(s, std::true_type{});
  for (; s <= last; ++s) step(s, std::false_type{});
}

template <int K, int RG>
int launch(const float* x, void* out, int B, int H, int W, int rg,
           const Spatial& sp, float inv_two_sc2, int mode, const Taps& taps,
           float amount, int quantize, cudaStream_t stream) {
  constexpr int BW = strip_cols<RG>();
  const int ow = BW - 2 * rg;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<K, RG>(rg);
  if (ow < 1 || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // opt in once per device to the most this instantiation can take
  constexpr int most = static_cast<int>(sizeof(float)) *
                       smem_floats<K, RG>(RG > 0 ? RG : kMaxRg);
  static std::atomic<std::uint64_t> opted{0};
  const int err = bilat::opt_in_smem(
      reinterpret_cast<const void*>(bilateral_unsharp_strip<K, RG>),
      most < kSmemMax ? most : kSmemMax, opted);
  if (err != 0) return err;
  const dim3 grid((W + ow - 1) / ow, (H + kRunRows - 1) / kRunRows, B);
  bilateral_unsharp_strip<K, RG><<<grid, round32(BW), smem, stream>>>(
      x, out, H, W, rg, sp, inv_two_sc2, mode, taps, amount, quantize);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_k(const float* x, void* out, int B, int H, int W, int rg,
             const Spatial& sp, float inv_two_sc2, int mode, const Taps& taps,
             float amount, int quantize, cudaStream_t stream) {
  switch (rg) {
    case 6:  // radius 1.5 at truncate 4: the flagship's
      return launch<K, 6>(x, out, B, H, W, rg, sp, inv_two_sc2, mode,
                          taps, amount, quantize, stream);
    case 4:  // radius 1.0
      return launch<K, 4>(x, out, B, H, W, rg, sp, inv_two_sc2, mode,
                          taps, amount, quantize, stream);
    default:
      return launch<K, 0>(x, out, B, H, W, rg, sp, inv_two_sc2, mode,
                          taps, amount, quantize, stream);
  }
}

}  // namespace

// x: [B, H, W] f32; out: [B, H, W] uint8 if quantize else f32.
// spatial: host pointer to the k*k bilateral spatial weights, symmetric
// about the centre (as K3's); taps: host pointer to the nt = 2 rg + 1
// Gaussian taps (1 <= rg <= 63). mode: 0 symmetric, 1 reflect, 2 edge (the
// bilateral's border).
extern "C" int mies_bilateral_unsharp(const float* x, void* out, int B, int H,
                                      int W, int k, const float* spatial,
                                      float inv_two_sc2, int mode,
                                      const float* taps, int nt, float amount,
                                      int quantize,
                                      cudaStream_t stream) {
  if (k < 1 || k > bilat::kMaxK || k % 2 == 0 || mode < 0 || mode > 2 ||
      nt < 3 || nt > 2 * kMaxRg + 1 || nt % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spatial sp;
  if (!bilat::make_spatial(spatial, k, &sp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t{};
  for (int i = 0; i < nt; ++i) t.t[i] = taps[i];
  const int rg = nt / 2;
  switch (k) {
    case 1: return launch_k<1>(x, out, B, H, W, rg, sp, inv_two_sc2,
                               mode, t, amount, quantize, stream);
    case 3: return launch_k<3>(x, out, B, H, W, rg, sp, inv_two_sc2,
                               mode, t, amount, quantize, stream);
    case 5: return launch_k<5>(x, out, B, H, W, rg, sp, inv_two_sc2,
                               mode, t, amount, quantize, stream);
    case 7: return launch_k<7>(x, out, B, H, W, rg, sp, inv_two_sc2,
                               mode, t, amount, quantize, stream);
    default: return launch_k<9>(x, out, B, H, W, rg, sp, inv_two_sc2,
                                mode, t, amount, quantize, stream);
  }
}
