// K11: non-local means (skimage fast_mode semantics) on [B, H, W] float32.
//
// Replaces mies_tpu/kernels/nlmeans.py:_nlm_chunk_kernel (the TPU ran the
// 84-pair table of d = 6 as ceil(84/12) chunked kernels only to bound its
// compile time; here the whole table runs in one launch). Per output pixel
// p and per pair {t, -t} of the half shift table, in table order:
//   S_t(q) = sum_k (u(q+k) - u(q+t+k))^2      (one box field per pair)
//   w_t(q) = exp(-D) if D <= 5 else 0,        D = max(S_t - bias, 0) * inv_h2sn
//   num += w_t(p) u(p+t) + w_t(p-t) u(p-t),   den += w_t(p) + w_t(p-t)
//   out = (num + 2 u(p)) / (den + 2)
// over the numpy-'reflect' extension u of the slice (reads never leave the
// offset + d wide extension, so no edge ring is needed). The pair's reverse
// end reads the same field at p - t, as the plain version and the TPU
// kernel do (ops/restoration.py denoise_nl_means).
//
// Bound: operations, 14 + 2(s - 1) f32 operations per pair and pixel (the
// two s-wide sums of the box, the squared difference, the weight and the
// two ends' accumulations), and one accurate expf per pair and field pixel
// (no --use_fast_math), which may set the pace. Design: a block owns a
// TH x TW output tile and stages it with its halo R = s/2 + d once in
// shared memory, the reflect resolved by index. For each pair t = (ty, tx)
// it covers the tile and the tile shifted by -t (rows -ty .. TH-1, TW +
// |tx| columns), grown by s/2 for the box:
//   1. the column sums of the squared differences, s rows of a column in
//      order, into shared memory: a thread takes 8 rows of a column and
//      holds the 8 + s - 1 squared differences in registers;
//   2. their row sums, s columns in ascending order (the plain version's
//      shifted-add order, so the boxes are bit-equal), 8 columns of a row
//      per thread from registers, and the weight of each field pixel,
//      once, into shared memory;
//   3. each output pixel reads w_t(p) and w_t(p - t) and accumulates in
//      registers, in the plain version's order.
// About 22 operations per pair and pixel times the halo's overlap (about
// 1.2 at 32 x 32, d = 6), against 2 s^2 + 8 and two expf when both ends'
// boxes were summed from scratch per pixel, and about 14 shared-memory
// accesses per pair and pixel. Every product and sum is an _rn intrinsic,
// so nvcc contracts nothing into an FMA. The tile, 32 x 32 (256 threads, 4
// pixels each), was chosen by measurement on an H100 against 16 x 64 (2.31
// against 2.36 ms at [32, 512, 512], s 5, d 6; PERF.md). The patch sizes 3,
// 5 and 7 get the box loops unrolled over register windows; any other odd s
// reads shared memory in loops of a runtime s (the same sums in the same
// order).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 32, kTW = 32;  // the output tile, rows x columns
constexpr int kSeg = 8;  // column sums (rows) / row sums (columns) per thread
constexpr float kCutoff = 5.0f;

// numpy 'reflect' source index (d c b | a b c d | c b a) at any distance;
// the pixels a block writes read within one bounce, the tile's ragged
// overhang may read further and is never written
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
  const float w = expf(-dist);  // no branch: the cutoff selects
  return dist <= kCutoff ? w : 0.0f;
}

__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Shared memory of one block, in floats (kernels/nlmeans.py shared_bytes is
// the same sum): the staged tile and its halo, kSeg rows more that the
// column sums' register windows may read past the field; the column sums,
// (TH + d + kSeg) rows, and the weights, (TH + d) rows of a pitch kSeg
// wider than the widest field, so that the last window of a row or column
// reads and writes in bounds, without a guard.
inline int nlm_smem_floats(int s, int d) {
  const int R = s / 2 + d;
  return (kTH + 2 * R + kSeg) * (kTW + 2 * R) +
         (kTH + d + kSeg) * odd(kTW + d + s - 1) +
         (kTH + d) * odd(kTW + d + kSeg);
}

// (quotient, remainder) of e by n through the f32 reciprocal inv_n: exact
// for e < 2^16 ((e + 0.5) / n is at least 0.5 / n from an integer)
__device__ __forceinline__ int2 divmod(int e, int n, float inv_n) {
  const int q = __float2int_rz((static_cast<float>(e) + 0.5f) * inv_n);
  return make_int2(q, e - q * n);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
nlm_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W,
           int s_rt, int d, float bias, float inv_h2sn) {
  constexpr int TH = kTH, TW = kTW;
  constexpr int kPix = TH * TW / kThreads;  // output pixels per thread
  constexpr int kRowStep = kThreads / TW;   // rows between them
  static_assert(TH * TW % kThreads == 0, "tile must split over the block");
  const int s = S > 0 ? S : s_rt;
  const int off = s / 2, R = off + d;
  const int pe = TW + 2 * R;            // staged tile pitch
  const int pq = odd(TW + d + s - 1);   // column-sum pitch
  const int pw = odd(TW + d + kSeg);    // weight pitch
  extern __shared__ float smem[];
  float* ext = smem;
  float* cs = ext + (TH + 2 * R + kSeg) * pe;
  float* wt = cs + (TH + d + kSeg) * pq;

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const float* img = x + static_cast<size_t>(b) * H * W;
  for (int e = tid; e < (TH + 2 * R) * pe; e += kThreads) {
    const int r = e / pe, c = e - r * pe;
    ext[e] = img[static_cast<size_t>(reflect_index(y0 - R + r, H)) * W +
                 reflect_index(x0 - R + c, W)];
  }
  // ext at tile-relative (r, c)
  const float* e0 = ext + R * pe + R;
  // this thread's output pixels: rows y + k kRowStep of column c
  const int py = tid / TW, px = tid % TW;
  const float* ep = e0 + py * pe + px;
  const float* wp = wt + py * pw + px;

  float num[kPix], den[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) num[k] = den[k] = 0.0f;
  __syncthreads();

  // the half table in its order: t = (ty, tx), first nonzero component > 0
  for (int ty = 0; ty <= d; ++ty) {
    for (int tx = (ty == 0 ? 1 : -d); tx <= d; ++tx) {
      const int ax = tx > 0 ? tx : -tx;
      const int c0 = tx > 0 ? -tx : 0;       // first weight column
      const int nr = TH + ty, nc = TW + ax;  // weight field rows x columns
      const int qc = nc + s - 1;             // columns grown for the box
      // 1. column sums, kSeg rows of one column per thread: the squared
      // differences (u at tile-relative (r - ty - off, c + c0 - off) minus u
      // shifted by t) of s rows, added in order. Rows past the field read
      // and write the padding.
      {
        const float* a0 = e0 + (-ty - off) * pe + (c0 - off);
        const int segs = (nr + kSeg - 1) / kSeg;
        const float inv_qc = 1.0f / static_cast<float>(qc);
        for (int item = tid; item < qc * segs; item += kThreads) {
          const int2 sc = divmod(item, qc, inv_qc);
          const int r0 = sc.x * kSeg;
          const float* a = a0 + r0 * pe + sc.y;
          const float* bb = a + ty * pe + tx;
          float* o = cs + r0 * pq + sc.y;
          if constexpr (S > 0) {
            float win[kSeg + S - 1];
#pragma unroll
            for (int j = 0; j < kSeg + S - 1; ++j) {
              const float df = __fsub_rn(a[j * pe], bb[j * pe]);
              win[j] = __fmul_rn(df, df);
            }
#pragma unroll
            for (int g = 0; g < kSeg; ++g) {
              float acc = win[g];
#pragma unroll
              for (int j = 1; j < S; ++j) acc = __fadd_rn(acc, win[g + j]);
              o[g * pq] = acc;
            }
          } else {
            for (int g = 0; g < kSeg; ++g) {
              float acc = 0.0f;
              for (int j = 0; j < s; ++j) {
                const float df = __fsub_rn(a[(g + j) * pe], bb[(g + j) * pe]);
                acc = j == 0 ? __fmul_rn(df, df)
                             : __fadd_rn(acc, __fmul_rn(df, df));
              }
              o[g * pq] = acc;
            }
          }
        }
      }
      __syncthreads();
      // 2. row sums, kSeg columns of one row per thread: s column sums in
      // ascending order, then the weight. Columns past the field read the
      // next row and write the weight row's padding.
      {
        const int segs = (nc + kSeg - 1) / kSeg;
        const float inv_nr = 1.0f / static_cast<float>(nr);
        for (int item = tid; item < nr * segs; item += kThreads) {
          const int2 sr = divmod(item, nr, inv_nr);
          const int cc = sr.x * kSeg;
          const float* q = cs + sr.y * pq + cc;
          float* w = wt + sr.y * pw + cc;
          if constexpr (S > 0) {
            float win[kSeg + S - 1];
#pragma unroll
            for (int j = 0; j < kSeg + S - 1; ++j) win[j] = q[j];
#pragma unroll
            for (int g = 0; g < kSeg; ++g) {
              float acc = win[g];
#pragma unroll
              for (int j = 1; j < S; ++j) acc = __fadd_rn(acc, win[g + j]);
              w[g] = nlm_weight(acc, bias, inv_h2sn);
            }
          } else {
            for (int g = 0; g < kSeg; ++g) {
              float acc = q[g];
              for (int j = 1; j < s; ++j) acc = __fadd_rn(acc, q[g + j]);
              w[g] = nlm_weight(acc, bias, inv_h2sn);
            }
          }
        }
      }
      __syncthreads();
      // 3. both ends of the pair at each output pixel p: w_t(p) at weight
      // row y + ty, column x - c0; w_t(p - t) at row y, column x - tx - c0;
      // u(p + t) and u(p - t)
      {
        const int of = ty * pw - c0, orr = -tx - c0;
        const int vf = ty * pe + tx;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float* wk = wp + k * kRowStep * pw;
          const float* ek = ep + k * kRowStep * pe;
          const float wf = wk[of], wr = wk[orr];
          num[k] = __fadd_rn(num[k], __fadd_rn(__fmul_rn(wf, ek[vf]),
                                               __fmul_rn(wr, ek[-vf])));
          den[k] = __fadd_rn(den[k], __fadd_rn(wf, wr));
        }
      }
      // no barrier: the next pair's step 1 writes cs, which step 3 does not
      // read; its step 2 writes wt after the next barrier
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int y = y0 + py + k * kRowStep, c = x0 + px;
    if (y < H && c < W) {
      const float u = ep[k * kRowStep * pe];
      out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + c] =
          __fdiv_rn(__fadd_rn(num[k], __fmul_rn(2.0f, u)),
                    __fadd_rn(den[k], 2.0f));
    }
  }
}

template <int S>
int launch(const float* x, float* out, int B, int H, int W, int s, int d,
           float bias, float inv_h2sn, cudaStream_t stream) {
  const size_t smem = sizeof(float) * nlm_smem_floats(s, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlm_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  nlm_kernel<S><<<grid, kThreads, smem, stream>>>(x, out, H, W, s, d, bias,
                                                  inv_h2sn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, H, W] f32. s: odd patch size; d: patch distance; bias and
// inv_h2sn: the f32 constants. The caller checks s/2 + d <= min(H, W) - 1
// and the shared memory.
extern "C" int mies_nl_means(const float* x, float* out, int B, int H, int W,
                             int s, int d, float bias, float inv_h2sn,
                             cudaStream_t stream) {
  if (s < 1 || s % 2 == 0 || d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (s) {
    case 3: return launch<3>(x, out, B, H, W, s, d, bias, inv_h2sn, stream);
    case 5: return launch<5>(x, out, B, H, W, s, d, bias, inv_h2sn, stream);
    case 7: return launch<7>(x, out, B, H, W, s, d, bias, inv_h2sn, stream);
    default: return launch<0>(x, out, B, H, W, s, d, bias, inv_h2sn, stream);
  }
}
