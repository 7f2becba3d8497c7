// The column-strip walk that K4 (csrc/unsharp.cu) and K7
// (csrc/unsharp_gauss.cu) share: a block owns a strip of output columns and
// walks down a run of rows, one thread per column of the strip and its halo.
// A thread pushes the rows of its x column into a window and sums the
// Gaussian's vertical pass from it; the block stages those sums (and x) one
// or two rows at a time in shared memory, where the horizontal pass reads
// them. Every product and sum is rounded on its own (_rn intrinsics, no FMA
// contraction) in ascending tap order, as scipy.ndimage.correlate1d sums
// and the plain versions repeat, so both kernels are bit-exact.

#pragma once

#include <cuda_runtime.h>

namespace strip {

constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

__device__ __forceinline__ int clampi(int i, int n) {
  return min(max(i, 0), n - 1);
}

// A column's window of the values pushed, oldest first, and sums of N taps
// over it. Registers when N is known at compile time (N > 0): the last
// N + 1 values, so that two consecutive windows of N are at hand (OFF 0:
// the one before the last push, 1: the last). Else a ring of the last n
// values in shared memory, `stride` floats apart (head: the oldest), where
// OFF is 1.
template <int N>
struct Window {
  float v[N + 1] = {};  // no undefined value for the shifts to carry
  __device__ __forceinline__ void push(float x) {
#pragma unroll
    for (int t = 0; t < N; ++t) v[t] = v[t + 1];
    v[N] = x;
  }
  template <int OFF>
  __device__ __forceinline__ float centre() const { return v[OFF + N / 2]; }
  // sum_t k[t] v[OFF + t] in ascending t, each product and sum rounded
  template <int OFF>
  __device__ __forceinline__ float dot(const float* k) const {
    float acc = __fmul_rn(k[0], v[OFF]);
#pragma unroll
    for (int t = 1; t < N; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k[t], v[OFF + t]));
    }
    return acc;
  }
};

template <>
struct Window<0> {
  float* ring;
  int n, stride, head;
  __device__ __forceinline__ void push(float x) {
    ring[head * stride] = x;
    head = head + 1 == n ? 0 : head + 1;
  }
  template <int OFF>
  __device__ __forceinline__ float centre() const {
    const int s = head + n / 2;
    return ring[(s < n ? s : s - n) * stride];
  }
  template <int OFF>
  __device__ __forceinline__ float dot(const float* k) const {
    float acc = __fmul_rn(k[0], ring[head * stride]);
    int t = 1;
    for (int s = head + 1; s < n; ++s, ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k[t], ring[s * stride]));
    }
    for (int s = 0; s < head; ++s, ++t) {
      acc = __fadd_rn(acc, __fmul_rn(k[t], ring[s * stride]));
    }
    return acc;
  }
};

// One x column read at clamped rows (scipy's 'nearest' row pad) into a
// Window<N> of n = 2 r + 1 rows, the next two rows loaded a step ahead.
template <int N>
struct Column {
  Window<N> w;
  const float* img;  // the slice; column gx (already clamped), H rows
  int H, W, gx;
  float n0 = 0.0f, n1 = 0.0f;  // rows to push next

  __device__ __forceinline__ float at(int row) const {
    return img[static_cast<size_t>(clampi(row, H)) * W + gx];
  }
  // the window holds rows u - r .. u + r - 1; rows u + r, u + r + 1 loaded
  __device__ __forceinline__ void start(int u, int r) {
    for (int t = 0; t < 2 * r; ++t) w.push(at(u - r + t));
    n0 = at(u + r);
    n1 = at(u + r + 1);
  }
  // push row u + r: the window (OFF 1) is row u's
  __device__ __forceinline__ void push1(int u, int r) {
    w.push(n0);
    n0 = n1;
    n1 = at(u + r + 2);
  }
  // push rows u + r and u + r + 1: OFF 0 is row u's window, OFF 1 row u + 1's
  __device__ __forceinline__ void push2(int u, int r) {
    w.push(n0);
    w.push(n1);
    n0 = at(u + r + 2);
    n1 = at(u + r + 3);
  }
};

// sum_t k[t] row[t] over n taps (N > 0: n = N at compile time)
template <int N>
__device__ __forceinline__ float row_dot(const float* k, const float* row,
                                         int n) {
  float acc = __fmul_rn(k[0], row[0]);
  if constexpr (N > 0) {
#pragma unroll
    for (int t = 1; t < N; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], row[t]));
  } else {
    for (int t = 1; t < n; ++t) acc = __fadd_rn(acc, __fmul_rn(k[t], row[t]));
  }
  return acc;
}

// clip(xc + amount * (xc - g), 0, 1)
__device__ __forceinline__ float unsharp(float xc, float g, float amount) {
  const float s = __fadd_rn(xc, __fmul_rn(amount, __fsub_rn(xc, g)));
  return fminf(fmaxf(s, 0.0f), 1.0f);
}

}  // namespace strip
