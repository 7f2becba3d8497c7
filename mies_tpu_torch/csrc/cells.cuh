// The OpenCV CLAHE blend's shared arithmetic, for K1 / K2 / K5
// (clahe.cu) and K8 (clahe3d.cu): the level quantize, the interpolation
// cell of a position along an axis by the blend's own f32 formula, and
// the first position of a cell. Every product and difference is an _rn
// intrinsic, as in the plain versions. Also the column units of a row
// segment and the host's row alignment test of the vector loads, which
// K6 and K8s (regions.cuh) use too.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// clip(rint(v * 255), 0, 255): the level quantize of ops.histogram._levels.
// rintf rounds half to even, like torch.round and jnp.round.
__device__ __forceinline__ int level_of(float v) {
  const float q = rintf(__fmul_rn(v, 255.0f));
  return static_cast<int>(fminf(fmaxf(q, 0.0f), 255.0f));
}

// OpenCV's f = p * (1/t) - 0.5 with the host's correctly rounded f32 1/t;
// its floor is the cell: the blend of tiles max(floor, 0) and
// min(floor + 1, g - 1) with weight f - floor.
__device__ __forceinline__ float cell_pos(int p, float inv) {
  return __fsub_rn(__fmul_rn(static_cast<float>(p), inv), 0.5f);
}
__device__ __forceinline__ int cell_of(int p, float inv) {
  return static_cast<int>(floorf(cell_pos(p, inv)));
}

// The first position in [lo, hi] whose cell is >= c (cells never decrease
// along an axis): from the exact-arithmetic estimate, corrected by the f32
// formula itself.
__device__ int cell_start(int c, int t, float inv, int lo, int hi) {
  int p = c * t + (t + 1) / 2;
  p = min(max(p, lo), hi);
  while (p > lo && cell_of(p - 1, inv) >= c) --p;
  while (p < hi && cell_of(p, inv) < c) ++p;
  return p;
}

// The columns [lo, hi) as units: a scalar head up to the first multiple
// of 4, float4 units of four columns, a scalar tail (every unit scalar
// unless vec). At most (hi - lo) / 4 + 6 units on aligned rows
// (kernels/clahe.py max_units).
struct Units {
  int lo, a, e, nh, nb, n;

  __device__ Units(int lo_, int hi, bool vec) : lo(lo_) {
    a = vec ? min((lo + 3) & ~3, hi) : hi;
    e = vec ? max(hi & ~3, a) : hi;
    nh = a - lo;
    nb = (e - a) >> 2;
    n = nh + nb + (hi - e);
  }
  __device__ bool is_vec(int u) const { return u >= nh && u < nh + nb; }
  // the first column of unit u
  __device__ int col(int u) const {
    return u < nh ? lo + u : is_vec(u) ? a + 4 * (u - nh) : e + (u - nh - nb);
  }
};

// Rows of W elements at p start 16-byte aligned: the vector loads' rule.
inline int rows_aligned(const void* p, int W) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (W & 3) == 0;
}

}  // namespace
