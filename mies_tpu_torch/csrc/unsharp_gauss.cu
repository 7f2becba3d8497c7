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
//     replication): x is read at clamped rows and columns;
//   * G2's row pad replicates U's edge rows: U is computed only at image
//     rows, and an edge row is pushed into G2's window once for itself and
//     once for each padded row it stands for;
//   * G1's column pad replicates the edge columns of its row pass, and G2's
//     those of V, the result of G2's row pass: both rows are staged over
//     clamped columns, and a U column past the image's edge is U at the
//     edge column (its first tap read from where the edge column's is).
// So every tap reads unguarded: no clamp, division or modulo in a tap loop.
//
// Design: a block owns a strip of kStripW output columns and walks down
// kStripRows output rows of one slice, one thread per column of the strip
// and its halo of r1 + r2 on each side. Per row of U, a thread pushes the
// next x row of its column into a window of 2 r1 + 1 values and sums G1's
// vertical pass from it; the block stages that row (and x's) in shared
// memory; a thread then sums G1's horizontal pass at its U column, blends,
// pushes U into a window of 2 r2 + 1 values of its column, sums G2's
// vertical pass from it, stages V, and sums G2's horizontal pass at its
// output column. The halo is recomputed only across the strip's sides and
// at the ends of its run of rows: per output pixel, 1.41 / 1.30 / 1.09 / 1
// of the four passes' taps at r1 = r2 = 6 (1.20 of 52 taps in all, against
// 1.67 for 32 x 32 tiles). For the shipped radii r1 = r2 = 6 (kStaticR, a
// template instance) the windows and taps sit in registers, and between
// the run's first and last rows a step takes two U rows: two independent
// sums per pass, and half the barriers and window shifts per row. Every
// other pair runs the same body at runtime radii, one U row a step, with its
// windows in shared-memory rings and its taps in shared memory. The
// windows, the x column's walk and the row sums are csrc/strip.cuh's, which
// K4 (csrc/unsharp.cu) runs as this kernel's first half.
//
// Bound: 4 B read + 4 B written per pixel; about 105 f32 operations per
// pixel, which the _rn arithmetic issues unfused. Each pass is one chain of
// dependent sums (ascending tap order), so the second row of a step is the
// only instruction-level parallelism it has: on an H100 it ran faster than
// one row a step. Strips of 256 columns or 128 rows ran within 2% of
// 128 x 64, which keeps 128 blocks for a single 1024^2 slice (PERF.md).

#include <cuda_runtime.h>

#include "strip.cuh"

namespace {

using strip::Column;
using strip::Window;
using strip::clampi;
using strip::kSmemMax;
using strip::round32;
using strip::row_dot;
using strip::unsharp;

// the radii whose windows and taps sit in registers: radius and sigma 1.5
// at truncate 4 (w3); kernels/unsharp_gauss.py UG_STATIC_R
constexpr int kStaticR = 6;
constexpr int kStripW = 128;        // output columns of a strip at kStaticR
constexpr int kStripRows = 64;      // output rows a block walks
constexpr int kStripWRuntime = 32;  // the runtime radii's strip
constexpr int kMaxR = 64;           // widest radius of each Gaussian

struct Taps {
  float k1[2 * kMaxR + 1];
  float k2[2 * kMaxR + 1];
};

// Block (strip x, run of rows y, slice b). R1, R2 >= 0: the radii at
// compile time (the strip kStripW wide, taps in registers, two U rows per
// step between the run's first and last); R1 = R2 = -1: the radii r1, r2 at
// runtime (a strip kStripWRuntime wide, taps and windows in shared memory,
// one U row per step).
template <int R1, int R2>
__global__ void __launch_bounds__(
    R1 >= 0 ? round32(kStripW + 2 * (R1 + R2))
            : round32(kStripWRuntime + 4 * kMaxR))
ug_strip(const float* __restrict__ x, float* __restrict__ out, int H, int W,
         int rr1, int rr2, const __grid_constant__ Taps taps,
         float amount) {
  constexpr bool kStatic = R1 >= 0;
  constexpr int N1 = kStatic ? 2 * R1 + 1 : 0, N2 = kStatic ? 2 * R2 + 1 : 0;
  const int r1 = kStatic ? R1 : rr1, r2 = kStatic ? R2 : rr2;
  const int n1 = 2 * r1 + 1, n2 = 2 * r2 + 1;
  const int sw = kStatic ? kStripW : kStripWRuntime;
  const int ng = sw + 2 * (r1 + r2);  // G1's vertical pass: strip + halo
  const int nu = sw + 2 * r2;         // U and V columns
  // staged rows: G1's vertical pass and x at two U rows, by the step's
  // parity ([2][2][ng] each), and V at two output rows ([2][nu])
  extern __shared__ float sm[];
  float* g1rows = sm;
  float* xrows = g1rows + 4 * ng;
  float* vrows = xrows + 4 * ng;
  // the taps: registers at compile-time radii, shared memory at runtime
  float k1r[kStatic ? N1 : 1], k2r[kStatic ? N2 : 1];
  const float* k1 = k1r;
  const float* k2 = k2r;
  const int j = threadIdx.x;
  const int b = blockIdx.z, x0 = blockIdx.x * sw;
  // this thread's x column (clamped), pushed into G1's vertical window
  Column<N1> xc{{}, x + static_cast<size_t>(b) * H * W, H, W,
                clampi(x0 - r1 - r2 + j, W)};
  Window<N2> uw;
  if constexpr (kStatic) {
#pragma unroll
    for (int t = 0; t < N1; ++t) k1r[t] = taps.k1[t];
#pragma unroll
    for (int t = 0; t < N2; ++t) k2r[t] = taps.k2[t];
  } else {
    float* k1s = vrows + 2 * nu;
    float* k2s = k1s + n1;
    for (int t = j; t < n1; t += blockDim.x) k1s[t] = taps.k1[t];
    for (int t = j; t < n2; t += blockDim.x) k2s[t] = taps.k2[t];
    k1 = k1s;
    k2 = k2s;
    xc.w = {k2s + n2 + j, n1, ng, 0};          // [n1][ng]
    uw = {k2s + n2 + n1 * ng + j, n2, nu, 0};  // [n2][nu]
    __syncthreads();
  }

  const int ys = blockIdx.y * kStripRows, ye = min(ys + kStripRows, H);
  float* dst = out + static_cast<size_t>(b) * H * W;
  // this thread's U column's first G1 tap in the staged rows (the U column
  // clamped: past the edge it is the edge's U); whether it has a G1, a U
  // and an output column
  const bool g1_on = j < ng, u_on = j < nu, o_on = j < sw && x0 + j < W;
  const int ub = clampi(x0 - r2 + j, W) - (x0 - r1 - r2) - r1;

  // U rows us .. ue - 1 feed G2's windows of the block's output rows; the
  // ones in the image, ua .. uz - 1, are computed, the others replicate the
  // edge rows
  const int us = ys - r2, ue = ye + r2;
  const int ua = max(us, 0), uz = min(ue, H);
  if (g1_on) xc.start(ua, r1);
  int pushed = 0, parity = 0;
  int u = ua;
  while (u < uz) {
    float* g1 = g1rows + parity * 2 * ng;
    float* xr = xrows + parity * 2 * ng;
    parity ^= 1;
    if (kStatic && u > ua && u + 1 < uz - 1) {
      // U rows u and u + 1, one output row each once G2's window is full
      if (g1_on) {
        xc.push2(u, r1);
        g1[j] = xc.w.template dot<0>(k1);
        g1[ng + j] = xc.w.template dot<1>(k1);
        xr[j] = xc.w.template centre<0>();
        xr[ng + j] = xc.w.template centre<1>();
      }
      __syncthreads();
      if (u_on) {
        const float u0 = unsharp(xr[ub + r1], row_dot<N1>(k1, g1 + ub, n1),
                                 amount);
        const float u1 = unsharp(xr[ng + ub + r1],
                                 row_dot<N1>(k1, g1 + ng + ub, n1), amount);
        uw.push(u0);
        uw.push(u1);
      }
      pushed += 2;
      const bool first = pushed - 1 >= n2, second = pushed >= n2;
      if (second) {
        if (u_on) {
          if (first) vrows[j] = uw.template dot<0>(k2);
          vrows[nu + j] = uw.template dot<1>(k2);
        }
        __syncthreads();
        if (o_on) {
          const int o = us + pushed - 1 - r2;
          if (first) {
            dst[static_cast<size_t>(o - 1) * W + x0 + j] =
                row_dot<N2>(k2, vrows + j, n2);
          }
          dst[static_cast<size_t>(o) * W + x0 + j] =
              row_dot<N2>(k2, vrows + nu + j, n2);
        }
      }
      u += 2;
      continue;
    }
    // U row u alone
    if (g1_on) {
      xc.push1(u, r1);
      g1[j] = xc.w.template dot<1>(k1);
      xr[j] = xc.w.template centre<1>();
    }
    __syncthreads();
    const float uv =
        u_on ? unsharp(xr[ub + r1], row_dot<N1>(k1, g1 + ub, n1), amount)
             : 0.0f;
    // U row u, and before the first / after the last image row the rows
    // that replicate it
    const int reps =
        1 + (u == ua ? ua - us : 0) + (u == uz - 1 ? ue - uz : 0);
    for (int k = 0; k < reps; ++k) {
      if (k > 0) __syncthreads();  // vrows: the last output row's readers
      if (u_on) uw.push(uv);
      if (++pushed >= n2) {
        if (u_on) vrows[j] = uw.template dot<1>(k2);
        __syncthreads();
        if (o_on) {
          const int o = us + pushed - 1 - r2;
          dst[static_cast<size_t>(o) * W + x0 + j] =
              row_dot<N2>(k2, vrows + j, n2);
        }
      }
    }
    ++u;
  }
}

// Shared memory bytes a block needs (kernels/unsharp_gauss.py
// unsharp_gauss_smem repeats the formula).
int smem_bytes(int r1, int r2, bool runtime) {
  const int sw = runtime ? kStripWRuntime : kStripW;
  const int ng = sw + 2 * (r1 + r2), nu = sw + 2 * r2;
  int floats = 8 * ng + 2 * nu;
  if (runtime) {
    const int n1 = 2 * r1 + 1, n2 = 2 * r2 + 1;
    floats += n1 + n2 + n1 * ng + n2 * nu;
  }
  return static_cast<int>(sizeof(float)) * floats;
}

template <int R1, int R2>
int launch(const float* x, float* out, int B, int H, int W, int r1, int r2,
           const Taps& t, float amount, cudaStream_t stream) {
  const bool runtime = R1 < 0;
  const int sw = runtime ? kStripWRuntime : kStripW;
  const int smem = smem_bytes(r1, r2, runtime);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ug_strip<R1, R2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + sw - 1) / sw, (H + kStripRows - 1) / kStripRows, B);
  ug_strip<R1, R2><<<grid, round32(sw + 2 * (r1 + r2)), smem, stream>>>(
      x, out, H, W, r1, r2, t, amount);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, H, W] f32. k1, k2: host pointers to the 2 r1 + 1 and 2 r2 + 1
// Gaussian taps (r1, r2 <= 64, and a block's shared memory within sm_90's).
extern "C" int mies_unsharp_gauss(const float* x, float* out, int B, int H,
                                  int W, const float* k1, int n1,
                                  const float* k2, int n2, float amount,
                                  cudaStream_t stream) {
  if (n1 < 1 || n1 > 2 * kMaxR + 1 || n1 % 2 == 0 || n2 < 1 ||
      n2 > 2 * kMaxR + 1 || n2 % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r1 = n1 / 2, r2 = n2 / 2;
  Taps t{};
  for (int i = 0; i < n1; ++i) t.k1[i] = k1[i];
  for (int i = 0; i < n2; ++i) t.k2[i] = k2[i];
  if (r1 == kStaticR && r2 == kStaticR) {
    return launch<kStaticR, kStaticR>(x, out, B, H, W, r1, r2, t, amount,
                                      stream);
  }
  return launch<-1, -1>(x, out, B, H, W, r1, r2, t, amount, stream);
}
