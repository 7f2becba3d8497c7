// The bilateral strip walk that K3 (csrc/bilateral.cu) and K13
// (csrc/fused.cu) share: a block owns a strip of BW bilateral columns, one
// thread each, and walks down a run of rows of one slice. A step stages one
// input row (the border resolved by index at load time, for any shape and
// distance) into a ring of R + 1 rows in shared memory; a thread shifts
// that row into its k x k window of registers, computes the pair weights of
// its origin, the pixel R rows up, into a ring of R + 1 rows of weights,
// and, after a barrier, sums that pixel's k^2 taps.
//
// The weight is symmetric: (I(q) - I(p))^2 == (I(p) - I(q))^2 exactly in
// f32 and the spatial weights of +d and -d are equal (make_spatial refuses
// weights that are not), so w(p, q) == w(q, p) bit for bit. Each unordered
// pair's weight is computed once, at its origin o for the half-offsets d
// (dy > 0, or dy == 0 < dx): (k^2 - 1) / 2 expf per pixel (12 at k 5). A
// pixel reads its forward taps' weights from its own registers and its
// reverse taps' at o = p - d from shared memory, and sums all k^2 taps in
// the row-major order of the per-pixel scan, every product and sum rounded
// on its own (_rn intrinsics), so a pixel's value does not depend on the
// strip or run that computed it; the centre tap's weight is
// spatial[0] * expf(-0 * inv_two_sc2). The origins across the strip's sides
// (R columns each) are spread over all T threads of the block as one flat
// list. k is a template parameter (1, 3, 5, 7, 9): every tap is unrolled,
// its window value and weight sit in registers or at a fixed offset, and no
// staged element pays a division.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace bilat {

constexpr int kMaxK = 9;

struct Spatial {
  float half[(kMaxK * kMaxK - 1) / 2];  // by half-offset index
  float centre;
};

// The k x k weights, row-major, as half-offset weights; false (nothing to
// launch) unless they are symmetric about the centre c: spatial[c + i] ==
// spatial[c - i], which the pair weights assume.
inline bool make_spatial(const float* spatial, int k, Spatial* sp) {
  const int c = k * k / 2;
  *sp = Spatial{};
  sp->centre = spatial[c];
  for (int i = 1; i <= c; ++i) {
    if (!(spatial[c + i] == spatial[c - i])) return false;
    sp->half[i - 1] = spatial[c + i];  // the half-offset Geo<k, .>::h = i - 1
  }
  return true;
}

// A strip of BW bilateral columns at kernel size K.
template <int K, int BW>
struct Geo {
  static constexpr int R = K / 2;
  static constexpr int NH = R * (K + 1);  // half-offsets: (K^2 - 1) / 2
  static constexpr int SC = BW + 4 * R;   // staged columns x0 - 2R ..
  static constexpr int WC = BW + 2 * R;   // origin columns x0 - R ..
  static constexpr int D = R + 1;         // rows in each ring
  static constexpr int kFloats = D * (SC + NH * WC);
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float)) * kFloats;
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

// One thread's share of the walk over a strip whose bilateral columns are
// x0 .. x0 + BW - 1 (thread j < BW: column x0 + j; threads BW .. T - 1 only
// stage and take side origins). A step s runs stage(), a barrier,
// weigh() (origin row o = s - R), a barrier, then sum() gives the
// bilateral at (o, x0 + j), and next() moves the rings.
template <int K, int BW, int T>
struct Walk {
  using G = Geo<K, BW>;
  static constexpr int R = G::R, NH = G::NH, SC = G::SC, WC = G::WC,
                       D = G::D;
  static_assert(T >= BW && T % 32 == 0, "a warp-multiple block of >= BW");

  float* rows;  // [D][SC]: input rows s - R .. s
  float* wts;   // [D][NH][WC]: weights of origin rows o - R .. o
  const float* img;
  int H, W, mode, j;
  int c0, c1;        // the staged columns this thread loads (border by index)
  bool one, two;     // whether it loads them
  float pa = 0.0f, pb = 0.0f;  // the next row's staged values
  float wc;          // the centre tap's weight
  float v[K][K] = {};              // rows s - 2R .. s, columns x - R .. x + R
  float fw[NH > 0 ? NH : 1] = {};  // this thread's origin's weights
  int slot = 0, ws = 0;            // ring slots of rows s and o

  // sm: G::kFloats floats of shared memory; the walk starts at step `first`
  __device__ __forceinline__ Walk(float* sm, const float* slice, int H_,
                                  int W_, int x0, int mode_,
                                  const Spatial& sp, float inv_two_sc2,
                                  int first)
      : rows(sm), wts(sm + D * SC), img(slice), H(H_), W(W_), mode(mode_),
        j(threadIdx.x) {
    one = T <= SC || j < SC;
    two = j + T < SC;
    c0 = one ? border_index(x0 - 2 * R + j, W, mode) : 0;
    c1 = two ? border_index(x0 - 2 * R + j + T, W, mode) : 0;
    wc = __fmul_rn(sp.centre,
                   expf(__fmul_rn(-__fmul_rn(0.0f, 0.0f), inv_two_sc2)));
    load(first);
  }

  __device__ __forceinline__ bool active() const { return T == BW || j < BW; }

  __device__ __forceinline__ void load(int row) {
    const float* src =
        img + static_cast<size_t>(border_index(row, H, mode)) * W;
    if (one) pa = src[c0];
    if (two) pb = src[c1];
  }

  // stage row s, loaded a step ahead; load row s + 1 if `more`
  __device__ __forceinline__ void stage(int s, bool more) {
    float* srow = rows + slot * SC;
    if (one) srow[j] = pa;
    if (two) srow[j + T] = pb;
    if (more) load(s + 1);
  }

  // after the barrier: shift row s into the window; with `origins`, the
  // weights of this thread's origin (s - R, x0 + j) and of the side origins
  __device__ __forceinline__ void weigh(bool origins, const Spatial& sp,
                                        float inv_two_sc2) {
    ws = slot + 1 == D ? 0 : slot + 1;  // ring slot of row o
    float* wrow = wts + ws * NH * WC;
    if (active()) {
      const float* srow = rows + slot * SC;
#pragma unroll
      for (int i = 0; i + 1 < K; ++i) {
#pragma unroll
        for (int c = 0; c < K; ++c) v[i][c] = v[i + 1][c];
      }
#pragma unroll
      for (int c = 0; c < K; ++c) v[K - 1][c] = srow[j + R + c];
      if (origins) {
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
      }
    }
    // the origins across the strip's sides: columns x0 - R .. x0 - 1 and
    // x0 + BW .. + R - 1, one (column, half-offset) item a thread
    if constexpr (R > 0) {
      if (origins) {
        for (int i = j; i < 2 * R * NH; i += T) {
          const int hc = i / NH, h = i - hc * NH;
          const int oc = hc < R ? hc : BW + hc;  // column - (x0 - R)
          const int dy = (h + 1 + R) / K, dx = h + 1 - dy * K;
          const int ps = ws + dy < D ? ws + dy : ws + dy - D;
          wrow[h * WC + oc] = pair_weight(rows[ws * SC + oc + R],
                                          rows[ps * SC + oc + R + dx],
                                          sp.half[h], inv_two_sc2);
        }
      }
    }
  }

  // after the barrier: the bilateral at (o, x0 + j), its k^2 taps in
  // row-major order; a reverse tap (ty, tx) < 0 reads the weight its origin
  // (o + ty, x + tx) computed
  __device__ __forceinline__ float sum() const {
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
    return __fdiv_rn(num, den);
  }

  __device__ __forceinline__ void next() { slot = ws; }
};

// Opt `kernel` in to `smem` bytes of dynamic shared memory past the default
// 48 KB, once per device (bit d of `opted`: device d).
inline int opt_in_smem(const void* kernel, int smem,
                       std::atomic<std::uint64_t>& opted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::uint64_t bit = dev < 64 ? std::uint64_t{1} << dev : 0;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  return 0;
}

}  // namespace bilat
