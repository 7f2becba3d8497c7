// K12: TV-Chambolle denoising (skimage denoise_tv_chambolle) on [B, H, W]
// float32, each slice stopping on its own.
//
// Replaces mies_tpu/kernels/tv.py:_tv_kernel, which held a whole 512^2
// slice and its dual field in VMEM for the whole while loop. A 1 MB slice
// and its 2 MB dual field do not fit an SM's 228 KB, so here the loop runs
// in chunks of K steps, three launches per chunk:
//   tv_chunk, a block per 64 x 64 interior tile of a slice: loads p1, p2
//     and img of the tile and a halo of at least K (an update reaches one
//     pixel further each step; the divergence and the gradient of the last
//     step need one more, which the halo's first ring supplies), runs K
//     steps in shared memory with the image edges at global coordinates (the
//     divergence is 0 before the first row and column, the gradient 0 at
//     the last ones), writes each step's float64 sums of d^2 and |g| over
//     its interior by a fixed tree, the new p (into the other buffer: the
//     chunk's starting p is kept) and the last step's out. A stopped
//     slice's blocks return at once.
//   tv_energy, a block per slice: walks the chunk's steps in order with the
//     reference's loop test, E = (sum d^2 + weight sum |g|) / size, stop
//     when |E_prev - E| < eps E_init from the second iteration, and records
//     the step j at which the test turned true;
//   tv_chunk in rollback mode: a slice that stopped at step j < K - 1 of
//     this chunk re-runs j updates from the chunk's starting p and writes
//     out = img + div(p_j), the out of the step that stopped it; every other
//     slice returns at once.
// So a stopped slice keeps the out of the iteration in which its test
// turned true (vmap-of-while semantics); the launch count, 3 ceil(max_iter
// / K), is fixed by the config, nothing waits on the host, and no float
// atomics make reruns differ. Sums are float64 rounded to float32 once
// (near-exact, so the stop iteration is reproducible); per-pixel
// arithmetic is _rn throughout (the plain version's order, bit-equal).
//
// Bound: operations (about 22 f32 operations per pixel and step run); the
// bytes the function needs are img in and out once. A chunk reads and
// writes p once per K steps instead of every step, at the cost of the
// halo's overlap, ((64 + 2K) / 64)^2 of the tile's work, and of at most
// one rollback of fewer than K steps per slice. Each thread owns one
// column of the region and every 8th row of it, so its addresses are
// constant offsets and its edge tests bits set once: the step's own
// arithmetic (two IEEE divisions and a square root per pixel) is most of
// the SM's instructions. K = 4 steps a launch (72 x 72 regions, 576
// threads, two blocks an SM) ran faster on an H100 than K = 8 with a halo
// of 8 (2.21 against 2.39 ms at [32, 512, 512], 60 steps; PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSteps = 4;  // K, steps per chunk launch (kernels/tv.py STEPS)
// the halo of the tile: kernels/tv.py HALO, which the wrapper passes and
// the launch checks (tests/test_torch_restoration.py pins its width)
constexpr int kHalo = kSteps;
constexpr int kGroups = 8;  // a thread's rows are kGroups apart
constexpr int kEnergyThreads = 256;
static_assert(kHalo >= kSteps, "an update reaches one pixel further a step");

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The region of a chunk block: the tile and its halo, kSide x kSide;
// thread t owns column t % kSide and the kRows rows t / kSide + kGroups a,
// so every address is a constant offset from its own and no index is
// divided per element.
constexpr int kSide = kTile + 2 * kHalo;
constexpr int kThreads = kSide * kGroups;
constexpr int kRows = kSide / kGroups;
constexpr int kWarps = kThreads / 32;
static_assert(kSide % kGroups == 0 && kThreads % 32 == 0, "region");

// Block (tile x, tile y, slice b). Chunk mode (rollback == 0): `steps` <=
// kSteps steps from p_in, p_K to p_out, the last step's out, the steps'
// partial sums to partial[b][i][block][2]. Rollback mode: roll[b] = j >= 0
// runs j updates from p_in and writes the out of step j. p_in, p_out: [2,
// B, H, W] (p1 then p2).
__global__ void __launch_bounds__(kThreads, 2)
tv_chunk(const float* __restrict__ img, const float* __restrict__ p_in,
         float* __restrict__ p_out, float* __restrict__ out,
         double* __restrict__ partial, const int* __restrict__ stop,
         const int* __restrict__ roll, int B, int H, int W, int steps,
         float tau_w, int rollback) {
  constexpr int S = kSide;
  const int b = blockIdx.z;
  int n = steps;
  if (rollback) {
    n = roll[b] + 1;
    if (n <= 0) return;
  } else if (stop[b]) {
    return;  // the whole block belongs to slice b
  }
  extern __shared__ float sm[];
  float* p1 = sm;
  float* p2 = p1 + S * S;
  float* im = p2 + S * S;
  float* cand = im + S * S;
  __shared__ double s_red[kSteps][kWarps][2];

  const size_t plane = static_cast<size_t>(B) * H * W;
  const size_t slice = static_cast<size_t>(b) * H * W;
  const int gy0 = blockIdx.y * kTile - kHalo;
  const int gx0 = blockIdx.x * kTile - kHalo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lx = tid % S, rg = tid / S, gx = gx0 + lx, e0 = rg * S + lx;
  // this column's edges: the divergence reads p2 on the left unless this is
  // the image's (or the region's) first column, the gradient the candidate
  // on the right unless it is the last; per row a, bit a of up / down; the
  // counted bits: the tile's own pixels inside the image, whose d^2 and |g|
  // enter the block's sums
  const bool left = gx > 0 && lx > 0;
  const bool right = gx < W - 1 && lx < S - 1;
  const bool col_in = lx >= kHalo && lx < kHalo + kTile && gx < W;
  unsigned up = 0, down = 0, counted = 0;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int ly = rg + kGroups * a, gy = gy0 + ly, e = e0 + kGroups * S * a;
    up |= static_cast<unsigned>(gy > 0 && ly > 0) << a;
    down |= static_cast<unsigned>(gy < H - 1 && ly < S - 1) << a;
    counted |= static_cast<unsigned>(col_in && ly >= kHalo &&
                                     ly < kHalo + kTile && gy < H) << a;
    float u = 0.0f, v = 0.0f, w = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t i = slice + static_cast<size_t>(gy) * W + gx;
      u = p_in[i];
      v = p_in[plane + i];
      w = img[i];
    }
    p1[e] = u;
    p2[e] = v;
    im[e] = w;
  }
  __syncthreads();

  // Every step works on the whole region: a value within i of its edge is
  // wrong by step i (it read beyond the region), and the tile is kHalo >=
  // n away. Positions outside the image hold zeros and are never read by a
  // position inside it. Zeros skip the square root's and the divisions'
  // range checks, which send +-0 down their slow path (the flat air of a
  // CT slice): sqrt(+0) = +0 and +-0 / factor = +-0, as IEEE gives them.
  for (int i = 0; i < n; ++i) {
    double dd = 0.0;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int e = e0 + kGroups * S * a;
      // divergence of p and the candidate out
      float d = -__fadd_rn(p1[e], p2[e]);
      d = __fadd_rn(d, (up >> a) & 1u ? p1[e - S] : 0.0f);
      d = __fadd_rn(d, left ? p2[e - 1] : 0.0f);
      cand[e] = __fadd_rn(im[e], d);
      if ((counted >> a) & 1u) dd += static_cast<double>(__fmul_rn(d, d));
    }
    __syncthreads();
    if (rollback && i == n - 1) break;  // out of step j: cand
    double nrm = 0.0;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int e = e0 + kGroups * S * a;
      // forward gradient of the candidate, |g| and the new p (in place: a
      // position's new p reads only its own old p)
      const float o = cand[e];
      const float g1 = (down >> a) & 1u ? __fsub_rn(cand[e + S], o) : 0.0f;
      const float g2 = right ? __fsub_rn(cand[e + 1], o) : 0.0f;
      const float n2 = __fadd_rn(__fmul_rn(g1, g1), __fmul_rn(g2, g2));
      const float norm = n2 == 0.0f ? 0.0f : __fsqrt_rn(n2);
      const float factor = __fadd_rn(1.0f, __fmul_rn(tau_w, norm));
      const float q1 = __fsub_rn(p1[e], __fmul_rn(0.25f, g1));
      const float q2 = __fsub_rn(p2[e], __fmul_rn(0.25f, g2));
      p1[e] = q1 == 0.0f ? q1 : __fdiv_rn(q1, factor);
      p2[e] = q2 == 0.0f ? q2 : __fdiv_rn(q2, factor);
      if ((counted >> a) & 1u) nrm += static_cast<double>(norm);
    }
    dd = warp_sum(dd);
    nrm = warp_sum(nrm);
    if (lane == 0) {
      s_red[i][warp][0] = dd;
      s_red[i][warp][1] = nrm;
    }
    __syncthreads();
  }

  // the tile: out (the last candidate), and in chunk mode p_K and the
  // steps' sums, the warps added in order
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    if ((counted >> a) & 1u) {
      const int e = e0 + kGroups * S * a;
      const size_t i =
          slice + static_cast<size_t>(gy0 + rg + kGroups * a) * W + gx;
      out[i] = cand[e];
      if (!rollback) {
        p_out[i] = p1[e];
        p_out[plane + i] = p2[e];
      }
    }
  }
  if (!rollback && tid < 2 * n) {
    const int i = tid >> 1, k = tid & 1;
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += s_red[i][w][k];
    const size_t nb = static_cast<size_t>(gridDim.x) * gridDim.y;
    partial[((static_cast<size_t>(b) * kSteps + i) * nb +
             blockIdx.y * gridDim.x + blockIdx.x) * 2 + k] = v;
  }
}

__global__ void __launch_bounds__(kEnergyThreads)
tv_energy(const double* __restrict__ partial, int steps, int nb,
          int* __restrict__ iters, float* __restrict__ e_prev,
          float* __restrict__ e_init, int* __restrict__ stop,
          int* __restrict__ roll, float weight, float eps, float size) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (stop[b]) {
    if (tid == 0) roll[b] = -1;
    return;
  }
  __shared__ double s_dd[kEnergyThreads], s_nrm[kEnergyThreads];
  __shared__ int s_stop;
  int it = iters[b];
  float ep = e_prev[b], ei = e_init[b];
  int j = -1;
  for (int i = 0; i < steps; ++i) {
    double dd = 0.0, nrm = 0.0;
    const double* part =
        partial + (static_cast<size_t>(b) * kSteps + i) * nb * 2;
    for (int k = tid; k < nb; k += kEnergyThreads) {
      dd += part[2 * k];
      nrm += part[2 * k + 1];
    }
    s_dd[tid] = dd;
    s_nrm[tid] = nrm;
    __syncthreads();
    for (int s = kEnergyThreads / 2; s > 0; s >>= 1) {
      if (tid < s) {
        s_dd[tid] += s_dd[tid + s];
        s_nrm[tid] += s_nrm[tid + s];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const float e_dd = static_cast<float>(s_dd[0]);
      const float e_n = static_cast<float>(s_nrm[0]);
      const float e = __fdiv_rn(__fadd_rn(e_dd, __fmul_rn(weight, e_n)), size);
      ei = it == 0 ? e : ei;
      s_stop = it > 0 && fabsf(__fsub_rn(ep, e)) < __fmul_rn(eps, ei);
      ep = e;
      it += 1;
    }
    __syncthreads();
    if (s_stop) {
      j = i;
      break;
    }
  }
  if (tid == 0) {
    iters[b] = it;
    e_prev[b] = ep;
    e_init[b] = ei;
    stop[b] = j >= 0;
    roll[b] = j >= 0 && j < steps - 1 ? j : -1;
  }
}

}  // namespace

// One chunk launch. img, out: [B, H, W] f32; p_in, p_out: [2, B, H, W] f32;
// partial: [B, kSteps, ceil(H/64) ceil(W/64), 2] f64; stop, roll: [B]
// int32. steps <= kSteps; halo: the wrapper's, which must be the one the
// kernel loads; rollback 0 runs `steps` steps, 1 the rollback of the slices
// with roll >= 0.
extern "C" int mies_tv_chunk(const float* img, const float* p_in,
                             float* p_out, float* out, double* partial,
                             const int* stop, const int* roll, int B, int H,
                             int W, int steps, int halo, float tau_w,
                             int rollback, cudaStream_t stream) {
  if (halo != kHalo || steps < 1 || steps > kSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // p1, p2, img and the candidate over the region
  const int smem = 4 * kSide * kSide * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      tv_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  tv_chunk<<<grid, kThreads, smem, stream>>>(img, p_in, p_out, out, partial,
                                             stop, roll, B, H, W, steps,
                                             tau_w, rollback);
  return static_cast<int>(cudaGetLastError());
}

// The per-slice energy walk over a chunk's `steps` steps. iters, stop,
// roll: [B] int32 and e_prev, e_init: [B] f32, zero before the first
// chunk. weight, eps and size = f32(H * W) as the reference's constants.
extern "C" int mies_tv_energy(const double* partial, int* iters,
                              float* e_prev, float* e_init, int* stop,
                              int* roll, int B, int H, int W, int steps,
                              float weight, float eps, float size,
                              cudaStream_t stream) {
  const int nb = ((W + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  if (steps < 1 || steps > kSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tv_energy<<<B, kEnergyThreads, 0, stream>>>(partial, steps, nb, iters,
                                              e_prev, e_init, stop, roll,
                                              weight, eps, size);
  return static_cast<int>(cudaGetLastError());
}
