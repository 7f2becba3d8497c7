// K9 (Perona-Malik) and K10 (SRAD): explicit diffusion steps on [B, H, W]
// float32, several steps a launch on a tile and its halo, ping-ponged
// between two buffers by the caller.
//
// Replace mies_tpu/kernels/diffusion.py:_pm_kernel and :_srad_kernel,
// which kept a whole slice in VMEM across every iteration; a 512^2 f32
// slice (1 MB) does not fit an SM's 228 KB.
//
// K9: up to kPmSteps steps per launch on a tile of (32 - 2 kPmSteps)
// columns x (kPmRows - 2 kPmSteps) rows. One step: forward differences,
// conduction g (option 1: exp(-(d/k)^2), 2: 1/(1 + (d/k)^2)), flux
// ((gamma * 1) * g) * d, backward-difference divergence, zero flux across
// the image's border; out = v + ((f0 - f0[-W]) + (f1 - f1[-1])). A step
// reads one pixel each way (f0[i] reads v[i + W], the divergence f0[i - W],
// which reads v[i - W]), so a launch of kPmSteps steps loads its tile with
// a halo of kPmSteps on every side: the window, 32 columns x kPmRows rows,
// moved inside the image where it would cross an edge. The window's edges
// take the image border's rule (the flux past the last row / column is the
// flux of a zero difference, before the first it is 0): right where the
// window meets the image's edge, wrong elsewhere, and the wrong values
// reach one pixel inward per step, so the tile stays exact. One warp owns
// a window, held in registers, one column a lane: the vertical neighbours
// are the lane's own registers, the horizontal ones a shuffle away. No
// shared memory and no barrier; each position's two fluxes once per step
// (two expf a pixel and step for option 1, not four). Only the tile is
// written back. Bound: operations (18 f32 operations per pixel and step,
// counting the accurate expf as one); the bytes the function needs are the
// image in and out once. The window costs (32 kPmRows) / ((32 - 2
// kPmSteps) (kPmRows - 2 kPmSteps)) of the tile's work per step (1.51 at 3
// steps and 32 rows). At w8's 6 steps, 3 steps a launch and 32 rows ran
// faster on an H100 than 2 or 6 steps and the other row counts tried, and
// ahead of a 64 x 64 tile in shared memory walked down its columns
// (PERF.md).
//
// K10: up to kSrSteps steps per launch on a 64 x 64 tile held in shared
// memory. One step: the instantaneous coefficient of variation of Yu & Acton
// on the edge-replicated image gives the conduction c, clipped to [0, 1]
// (NaN passes); out = v + dt/4 (c_S dS + c dN + c_E dE + c dW), where past
// the last row / column c takes the virtual-ring values C(0, 0, dW, dE) /
// C(dN, dS, 0, 0) of the replicated ring; q0(t) = q0 exp(-rho t) in f32.
// A step reads one pixel up and left and two down and right (c_S and c_E
// read their own neighbours), so a launch of kSrSteps steps loads its tile
// with a halo of kSrSteps above and left and 2 kSrSteps below and right,
// clipped to the image: the window. Each step
//   1. computes c once per position of the window, and of its ring row and
//      column past the last (the virtual ring where the window ends at the
//      image's edge), into a shared field;
//   2. updates the window from the field and, where the window meets the
//      image's edge, copies the new edge rows and columns into a ring around
//      it: edge replication of this step's image. Elsewhere the ring keeps
//      the window's first values, wrong ones, which reach one pixel further
//      up / left and two further down / right each step: the tile stays
//      exact.
// Only the tile is written back. Each thread owns one column of the window
// and a run of kSrRows consecutive rows, and walks down them with the
// column's north, centre and south values in registers. q0(t), q0(t)^2 and
// the conduction's denominator q0^2 (1 + q0^2) + 1e-12 are the same for
// every pixel of a step and computed once per step.
// Every product, sum and quotient is rounded on its own (_rn intrinsics, no
// --use_fast_math: expf is the accurate one) in the plain version's order.
//
// Bound: operations (K9 18 f32 operations per pixel and step counting the
// accurate expf as one, K10 42 counting one conduction per pixel); the bytes
// the function needs are the image in and out once. K10 spends them on the
// window: ((64 + 3 kSrSteps) /
// 64)^2 of the tile's work per step (1.20 at 2 steps, 1.41 at 4), five IEEE
// divisions per conduction. 2 steps a launch and 8 runs of rows per column
// (560 threads, three blocks an SM) ran faster on an H100 than 4 or 8 steps
// and 4 runs (PERF.md).

#include <cuda_runtime.h>

namespace {

// K9's steps per launch (kernels/diffusion.py PM_STEPS, and PM_HALO, which
// the wrapper passes and the launch checks; tests/test_torch_restoration.py
// pins it)
constexpr int kPmSteps = 3;
constexpr int kPmRows = 32;                       // window rows a lane holds
constexpr int kPmTileH = kPmRows - 2 * kPmSteps;  // the rows a warp writes
constexpr int kPmTileW = 32 - 2 * kPmSteps;       // the columns it writes
constexpr int kPmWarps = 4;                       // warps per block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPmSteps >= 1 && kPmTileH >= 1 && kPmTileW >= 1, "K9 window");

template <int kOption>
__device__ __forceinline__ float pm_flux(float d, float inv_k2, float gamma) {
  const float d2 = __fmul_rn(d, d);
  const float g = kOption == 1
      ? expf(__fmul_rn(-d2, inv_k2))
      : __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(d2, inv_k2)));
  return __fmul_rn(__fmul_rn(gamma, g), d);
}

// `steps` steps of a lane's column of the window, v[i] its row i. The
// window's top and bottom rows take the image border's rule (f0[-1] = 0,
// and the flux past the last row is the flux of a zero difference); kShort
// (an image shorter than the window) puts the last rule at the image's
// last row, window row `bot`, and the rows below it never reach the image.
// The rows are unrolled (the window lives in registers), the steps are not
// (the code stays in the instruction cache).
template <int kOption, bool kShort>
__device__ __forceinline__ void pm_steps(float (&v)[kPmRows], int steps,
                                         int lane, bool col_edge, int bot,
                                         float zf, float inv_k2,
                                         float gamma) {
  for (int s = 0; s < steps; ++s) {
    float f0p = 0.0f;  // f0 of the row above
#pragma unroll
    for (int i = 0; i < kPmRows; ++i) {
      // the horizontal flux from the right neighbour's column (the last
      // lane's own: a zero difference), f1[-1] from the left one's
      const float vr = __shfl_down_sync(kFull, v[i], 1);
      const float f1 = col_edge
          ? zf : pm_flux<kOption>(__fsub_rn(vr, v[i]), inv_k2, gamma);
      const float f1u = __shfl_up_sync(kFull, f1, 1);
      const float f1m = lane == 0 ? 0.0f : f1u;
      float f0 = zf;
      if (i < kPmRows - 1 && (!kShort || i != bot)) {
        f0 = pm_flux<kOption>(__fsub_rn(v[i + 1], v[i]), inv_k2, gamma);
      }
      v[i] = __fadd_rn(v[i], __fadd_rn(__fsub_rn(f0, f0p),
                                       __fsub_rn(f1, f1m)));
      f0p = f0;
    }
  }
}

// Warp (blockIdx.x * kPmWarps + warp, blockIdx.y, slice b) of the grid of
// kPmTileW x kPmTileH tiles: `steps` steps of its tile on a window of 32
// columns x kPmRows rows in registers, one column a lane.
template <int kOption, bool kShort>
__global__ void __launch_bounds__(32 * kPmWarps)
pm_tile(const float* __restrict__ in, float* __restrict__ out, int H, int W,
        int steps, float inv_k2, float gamma) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx0 = (blockIdx.x * kPmWarps + warp) * kPmTileW;
  const int ty0 = blockIdx.y * kPmTileH;
  if (tx0 >= W) return;  // the whole warp
  // the window: the tile and kPmSteps on every side, moved inside the
  // image where it would cross an edge (the edge then is the image's)
  const int wx0 = max(min(tx0 - kPmSteps, W - 32), 0);
  const int wy0 = max(min(ty0 - kPmSteps, H - kPmRows), 0);
  const int c = wx0 + lane;
  const size_t slice = static_cast<size_t>(blockIdx.z) * H * W;
  float v[kPmRows];
#pragma unroll
  for (int i = 0; i < kPmRows; ++i) {
    const int r = wy0 + i;
    v[i] = c < W && (!kShort || r < H)
        ? in[slice + static_cast<size_t>(r) * W + c] : 0.0f;
  }
  const bool col_edge = c == W - 1;
  const float zf = pm_flux<kOption>(0.0f, inv_k2, gamma);
  pm_steps<kOption, kShort>(v, steps, lane, col_edge, H - 1 - wy0, zf,
                            inv_k2, gamma);
  if (c < tx0 || c >= min(tx0 + kPmTileW, W)) return;
  const int y_end = min(ty0 + kPmTileH, H);
#pragma unroll
  for (int i = 0; i < kPmRows; ++i) {
    const int r = wy0 + i;
    if (r >= ty0 && r < y_end) {
      out[slice + static_cast<size_t>(r) * W + c] = v[i];
    }
  }
}

template <int kOption>
void launch_pm(dim3 grid, bool short_, const float* in, float* out, int H,
               int W, int steps, float inv_k2, float gamma,
               cudaStream_t stream) {
  if (short_) {
    pm_tile<kOption, true><<<grid, 32 * kPmWarps, 0, stream>>>(
        in, out, H, W, steps, inv_k2, gamma);
  } else {
    pm_tile<kOption, false><<<grid, 32 * kPmWarps, 0, stream>>>(
        in, out, H, W, steps, inv_k2, gamma);
  }
}

// --- K10 ---------------------------------------------------------------------

constexpr int kSrTile = 64;
constexpr int kSrSteps = 2;  // kernels/diffusion.py STEPS
// the halo of the tile above / left and below / right: kernels/diffusion.py
// HALO, which the wrapper passes and the launch checks
// (tests/test_torch_restoration.py pins it)
constexpr int kSrLo = kSrSteps;
constexpr int kSrHi = 2 * kSrSteps;
constexpr int kSrSide = kSrTile + kSrLo + kSrHi;  // the window at most
constexpr int kSrGroups = 8;  // runs of rows per window column
constexpr int kSrRows = (kSrSide + kSrGroups - 1) / kSrGroups;
constexpr int kSrThreads = kSrSide * kSrGroups;
// a plane: the window with a ring of one before and two after, both ways
constexpr int kSrPitch = kSrSide + 3;
constexpr int kSrPlane = kSrPitch * kSrPitch;
constexpr int kSrSmem = 3 * kSrPlane * static_cast<int>(sizeof(float));
constexpr int kSrLoads = (kSrPlane + kSrThreads - 1) / kSrThreads;
constexpr int kSrBlocks = (227 * 1024) / (kSrSmem + 1024);  // per SM
static_assert(kSrSteps >= 1 && kSrBlocks >= 1, "K10 window");

// the SRAD conduction at one position, from its four differences; den =
// q02 (1 + q02) + 1e-12, the same for every position of a step
__device__ __forceinline__ float srad_c(float dn, float ds, float dw, float de,
                                        float v, float q02, float den,
                                        float eps) {
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
      1.0f, __fadd_rn(1.0f, __fdiv_rn(__fsub_rn(q2, q02), den)));
  return c != c ? c : fminf(fmaxf(c, 0.0f), 1.0f);  // clip, NaN passes
}

// Block (tile x, tile y, slice b): steps t0 .. t0 + steps - 1 of the tile.
__global__ void __launch_bounds__(kSrThreads, kSrBlocks)
srad_chunk(const float* __restrict__ in, float* __restrict__ out, int H,
           int W, int t0, int steps, float q0, float rho, float eps,
           float dt4) {
  constexpr int P = kSrPitch;
  extern __shared__ float sm[];
  float* cur = sm;               // this step's image, ring included
  float* nxt = cur + kSrPlane;   // the next step's
  float* cf = nxt + kSrPlane;    // the conduction field
  const int ty0 = blockIdx.y * kSrTile, tx0 = blockIdx.x * kSrTile;
  const int wy0 = max(ty0 - kSrLo, 0), wx0 = max(tx0 - kSrLo, 0);
  const int wh = min(ty0 + kSrTile + kSrHi, H) - wy0;
  const int ww = min(tx0 + kSrTile + kSrHi, W) - wx0;
  const size_t slice = static_cast<size_t>(blockIdx.z) * H * W;
  const float* src = in + slice;
  const int tid = threadIdx.x;

  // the window at clamped coordinates: both image planes' (i, j), i and j
  // from -1, hold window pixel (clamp(i, 0, wh - 1), clamp(j, 0, ww - 1));
  // the field starts at zero (its last row and column are read, never
  // written, by the tile of an inner block)
  {  // all of a thread's loads in flight before its first store
    float v[kSrLoads];
#pragma unroll
    for (int k = 0; k < kSrLoads; ++k) {
      const int p = tid + k * kSrThreads;
      const int i = min(max(p / P - 1, 0), wh - 1);
      const int j = min(max(p % P - 1, 0), ww - 1);
      v[k] = p < kSrPlane ? src[static_cast<size_t>(wy0 + i) * W + wx0 + j]
                          : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kSrLoads; ++k) {
      const int p = tid + k * kSrThreads;
      if (p < kSrPlane) {
        cur[p] = v[k];
        nxt[p] = v[k];
        cf[p] = 0.0f;
      }
    }
  }

  // this thread: column lx, rows ly0 .. ly0 + kSrRows - 1 of the window; the
  // field covers rows and columns up to wh and ww (the ring past the last),
  // the update rows and columns below wh and ww
  const int lx = tid % kSrSide, ly0 = (tid / kSrSide) * kSrRows;
  const int rows_c = lx <= ww
      ? min(max(min(wh + 1, kSrSide) - ly0, 0), kSrRows) : 0;
  const int rows_v = lx < ww ? min(max(wh - ly0, 0), kSrRows) : 0;
  // the ring this thread refreshes: its column's where it is the image's
  // first or last, its run's first / last row's where that is the image's
  // (-1: none)
  const bool left = wx0 == 0 && lx == 0;
  const bool right = wx0 + ww == W && lx == ww - 1;
  const int a_top = wy0 == 0 ? -ly0 : -1;
  const int a_bot = wy0 + wh == H ? wh - 1 - ly0 : -1;
  const int e0 = (ly0 + 1) * P + lx + 1;
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float q0t = __fmul_rn(
        q0, expf(__fmul_rn(-rho, static_cast<float>(t0 + s))));
    const float q02 = __fmul_rn(q0t, q0t);
    const float den =
        __fadd_rn(__fmul_rn(q02, __fadd_rn(1.0f, q02)), 1e-12f);
    {  // the conduction, once per position
      float vn = cur[e0 - P], vc = cur[e0];
#pragma unroll
      for (int a = 0; a < kSrRows; ++a) {
        if (a >= rows_c) break;
        const int e = e0 + a * P;
        const float vs = cur[e + P];
        cf[e] = srad_c(__fsub_rn(vn, vc), __fsub_rn(vs, vc),
                       __fsub_rn(cur[e - 1], vc), __fsub_rn(cur[e + 1], vc),
                       vc, q02, den, eps);
        vn = vc;
        vc = vs;
      }
    }
    __syncthreads();
    {  // the update, and the new image's ring
      float vn = cur[e0 - P], vc = cur[e0], cc = cf[e0];
#pragma unroll
      for (int a = 0; a < kSrRows; ++a) {
        if (a >= rows_v) break;
        const int e = e0 + a * P;
        const float vs = cur[e + P];
        const float dn = __fsub_rn(vn, vc), ds = __fsub_rn(vs, vc);
        const float dw = __fsub_rn(cur[e - 1], vc);
        const float de = __fsub_rn(cur[e + 1], vc);
        const float cs = cf[e + P], ce = cf[e + 1];
        const float div = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(cs, ds), __fmul_rn(cc, dn)),
                      __fmul_rn(ce, de)),
            __fmul_rn(cc, dw));
        const float nv = __fadd_rn(vc, __fmul_rn(dt4, div));
        nxt[e] = nv;
        if (left || right || a == a_top || a == a_bot) {
          if (left) nxt[e - 1] = nv;
          if (right) {
            nxt[e + 1] = nv;
            nxt[e + 2] = nv;
          }
          if (a == a_top) {
            nxt[e - P] = nv;
            if (right) nxt[e - P + 1] = nv;
          }
          if (a == a_bot) {
            nxt[e + P] = nv;
            nxt[e + 2 * P] = nv;
            if (left) nxt[e + P - 1] = nv;
            if (right) nxt[e + P + 1] = nv;
          }
        }
        vn = vc;
        vc = vs;
        cc = cs;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // the tile's own pixels
  float* dst = out + slice;
  const int gx = wx0 + lx;
  if (gx < tx0 || gx >= tx0 + kSrTile) return;
#pragma unroll
  for (int a = 0; a < kSrRows; ++a) {
    if (a >= rows_v) break;
    const int gy = wy0 + ly0 + a;
    if (gy >= ty0 && gy < ty0 + kSrTile) {
      dst[static_cast<size_t>(gy) * W + gx] = cur[e0 + a * P];
    }
  }
}

}  // namespace

// Perona-Malik steps 1 .. steps (1 <= steps <= kPmSteps): in, out [B, H, W]
// f32 (distinct buffers); halo: the wrapper's, which must be the one the
// kernel loads; inv_k2 = f32(1 / kappa^2), gamma = f32(gamma), option 1 or
// 2.
extern "C" int mies_perona_malik(const float* in, float* out, int B, int H,
                                 int W, int steps, int halo, float inv_k2,
                                 float gamma, int option,
                                 cudaStream_t stream) {
  if ((option != 1 && option != 2) || halo != kPmSteps || steps < 1 ||
      steps > kPmSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int strips = (W + kPmTileW - 1) / kPmTileW;
  const dim3 grid((strips + kPmWarps - 1) / kPmWarps,
                  (H + kPmTileH - 1) / kPmTileH, B);
  const bool short_ = H < kPmRows;
  if (option == 1) {
    launch_pm<1>(grid, short_, in, out, H, W, steps, inv_k2, gamma, stream);
  } else {
    launch_pm<2>(grid, short_, in, out, H, W, steps, inv_k2, gamma, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// SRAD steps t0 .. t0 + steps - 1 (1 <= steps <= kSrSteps): in, out [B, H,
// W] f32 (distinct buffers); halo_lo, halo_hi: the wrapper's halo above /
// left and below / right, which must be the one the kernel loads; q0, rho,
// eps and dt4 = f32(dt / 4) as f32 constants.
extern "C" int mies_srad(const float* in, float* out, int B, int H, int W,
                         int t0, int steps, int halo_lo, int halo_hi, float q0,
                         float rho, float eps, float dt4,
                         cudaStream_t stream) {
  if (halo_lo != kSrLo || halo_hi != kSrHi || steps < 1 ||
      steps > kSrSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      srad_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSrSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + kSrTile - 1) / kSrTile, (H + kSrTile - 1) / kSrTile,
                  B);
  srad_chunk<<<grid, kSrThreads, kSrSmem, stream>>>(in, out, H, W, t0, steps,
                                                     q0, rho, eps, dt4);
  return static_cast<int>(cudaGetLastError());
}
