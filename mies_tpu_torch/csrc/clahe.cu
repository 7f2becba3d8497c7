// K1 + K2 + K5: OpenCV-convention CLAHE on [B, H, W] float32 slices in
// [0, 1], and on the row bands of a row-sharded slice (K5).
//
// K1 (mies_tile_hists) replaces mies_tpu/kernels/clahe.py:_hist_rows_kernel
// (and answers _hist_kernel): per-tile 256-bin counts with the uint8 level
// quantize done in the kernel. Its bins mode (mies_tile_hists_bins) counts
// int32 bin indices that are already computed into nbins bins per region,
// over a window of a larger array at a row and column offset: the skimage
// convention's regions (_hist_rows_kernel with quantize_input=False, and
// _hist_kernel for odd region columns or kc % 64 != 0) without a copy of
// the crop. The TPU built its histograms from nibble
// onehot matmuls because it has no scatter; Hopper has shared-memory
// atomics, so a block counts a strip of one tile's rows (the whole tile
// up to kPixelsPerBlock pixels, as K2) into a 256-bin shared histogram and
// stores it, or adds it to the zeroed output with integer atomics when the
// tile takes several blocks (exact in any order). Bound: one read of the
// image (4 B/pixel) plus shared-memory atomic throughput on hot bins. Design: no int32 levels go to device
// memory, and the OpenCV bottom/right reflect-101 pad of a ragged image is
// resolved at load time, so any tile shape runs without a padded copy.
//
// K2 (mies_apply_lut) replaces mies_tpu/kernels/clahe.py:_apply33_kernel
// (and answers _apply_kernel_slab, _apply_kernel and the clahe_variants
// kernels): the OpenCV bilinear blend of the four neighbouring tiles' LUTs
// at each pixel's level, then the u8norm epilogue clip(rint(v),0,255)/255
// (opencv: integer LUTs) or the clip01 epilogue clip(v, 0, 1) (fraction:
// fractional LUTs cdf / tile_area).
// The TPU selected LUT entries by onehot matmul because it has no gather;
// here a block owns a strip of one tile's rows (the whole tile when it has
// at most kPixelsPerBlock pixels: an 8x8 grid of a 4096^2 slice has only
// 64 tiles, too few blocks for 132 SMs), stages the tile's 3x3 neighbour
// LUTs (9 x 256 f32) in shared memory and gathers from them. Bound: 4 B
// read + 4 B written per pixel; the shared-memory gathers are
// bank-conflicted by level but cheap next to that. Every multiply/add of the blend is an explicit _rn
// intrinsic: nvcc contracts a*b+c to FMA by default, which would break the
// bit-exactness against the plain version (and against cv2).
//
// K5 (mies_apply_lut_band) replaces mies_tpu/kernels/clahe.py:
// _blocks4_fracs_kernel (blocks4_fracs_apply, the apply of one row band of a
// row-sharded slice, parallel/clahe_shard.py clahe_band): the same blend of
// a tile-aligned [hb, W] band against the FULL [gy, gx, 256] LUT grid, at
// the band's global rows. The TPU kernel received the fractions as input
// blocks only because Mosaic could not derive them from a row offset traced
// inside shard_map; here the offset is a launch argument and the fractions
// are derived in the kernel with K2's arithmetic at global row y + y_off, so
// no fraction arrays exist. K2 and K5 share the kernel (K2 passes 0).

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = 8192;  // K2/K5: a tile's rows per block

// clip(rint(v * 255), 0, 255): the level quantize of ops.histogram._levels.
// rintf rounds half to even, like torch.round and jnp.round.
__device__ __forceinline__ int level_of(float v) {
  const float q = rintf(__fmul_rn(v, 255.0f));
  return static_cast<int>(fminf(fmaxf(q, 0.0f), 255.0f));
}

// Source index of a position in OpenCV's bottom/right BORDER_REFLECT_101
// pad, at any number of bounces (cv2's rule pads a full tile on an axis
// that divides evenly, which can be longer than a small image); periodic
// with period 2n - 2, as borderInterpolate and numpy 'reflect'.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < n) return i;
  if (n == 1) return 0;
  const int m = i % (2 * n - 2);
  return m < n ? m : 2 * n - 2 - m;
}

// A block's share of a tile's counts: stored when it counted the whole
// tile, else added to the zeroed output.
__device__ __forceinline__ void put_counts(int* out, const int* counts,
                                           int nbins, int splits) {
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) {
    if (splits == 1) {
      out[k] = counts[k];
    } else if (counts[k] != 0) {
      atomicAdd(&out[k], counts[k]);
    }
  }
}

// Block (j, i * splits + sub, b) counts rows [sub * rpb, (sub + 1) * rpb)
// of tile (i, j) of slice b.
__global__ void __launch_bounds__(kThreads)
tile_hists_kernel(const float* __restrict__ x, int* __restrict__ hist,
                  int H, int W, int gy, int gx, int th, int tw, int rpb) {
  __shared__ int counts[kBins];
  const int splits = (th + rpb - 1) / rpb;
  const int j = blockIdx.x, i = blockIdx.y / splits, b = blockIdx.z;
  const int r0 = i * th + (blockIdx.y % splits) * rpb;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) counts[k] = 0;
  __syncthreads();

  const float* img = x + static_cast<size_t>(b) * H * W;
  const int npx = min(rpb, (i + 1) * th - r0) * tw;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int y = reflect101(r0 + p / tw, H);
    const int c = reflect101(j * tw + p % tw, W);
    atomicAdd(&counts[level_of(img[static_cast<size_t>(y) * W + c])], 1);
  }
  __syncthreads();

  put_counts(hist + ((static_cast<size_t>(b) * gy + i) * gx + j) * kBins,
             counts, kBins, splits);
}

// Block (j, i * splits + sub, b) counts rows [sub * rpb, (sub + 1) * rpb)
// of region (i, j) of the window whose top-left corner is (y0, x0) in each
// [H, W] slice; nbins int counters in dynamic shared memory. A bin outside
// [0, nbins) is not counted (the wrapper's binning never makes one).
__global__ void __launch_bounds__(kThreads)
tile_hists_bins_kernel(const int* __restrict__ bins, int* __restrict__ hist,
                       int H, int W, int y0, int x0, int gy, int gx, int th,
                       int tw, int nbins, int rpb) {
  extern __shared__ int counts_dyn[];
  const int splits = (th + rpb - 1) / rpb;
  const int j = blockIdx.x, i = blockIdx.y / splits, b = blockIdx.z;
  const int r0 = (blockIdx.y % splits) * rpb;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) counts_dyn[k] = 0;
  __syncthreads();

  const int* tile = bins + static_cast<size_t>(b) * H * W +
                    static_cast<size_t>(y0 + i * th + r0) * W + x0 + j * tw;
  const int npx = min(rpb, th - r0) * tw;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int v = tile[static_cast<size_t>(p / tw) * W + p % tw];
    if (static_cast<unsigned>(v) < static_cast<unsigned>(nbins))
      atomicAdd(&counts_dyn[v], 1);
  }
  __syncthreads();

  put_counts(hist + ((static_cast<size_t>(b) * gy + i) * gx + j) * nbins,
             counts_dyn, nbins, splits);
}

__global__ void __launch_bounds__(kThreads)
apply_lut_kernel(const float* __restrict__ x, const float* __restrict__ luts,
                 float* __restrict__ out, int H, int W, int gy, int gx,
                 int th, int tw, float inv_th, float inv_tw, int y_off,
                 int rpb, int clip01) {
  // x and out hold H rows starting at global row y_off (a multiple of th;
  // 0 for a whole slice): block (j, il * splits + sub, b) owns rows
  // [sub * rpb, (sub + 1) * rpb) of local tile row il, global tile row i.
  // stack[(s * 3 + c) * 256 + bin]: LUT of tile (i - 1 + s, j - 1 + c),
  // clamped to the grid like the TPU kernel's edge-padded LUT stack
  __shared__ float stack[9 * kBins];
  const int splits = (th + rpb - 1) / rpb;
  const int j = blockIdx.x, il = blockIdx.y / splits, b = blockIdx.z;
  const int sub = blockIdx.y % splits;
  const int i = il + y_off / th;
  const float* lb = luts + static_cast<size_t>(b) * gy * gx * kBins;
  for (int k = threadIdx.x; k < 9 * kBins; k += blockDim.x) {
    const int s = k / kBins, bin = k % kBins;
    const int ty = min(max(i - 1 + s / 3, 0), gy - 1);
    const int tx = min(max(j - 1 + s % 3, 0), gx - 1);
    stack[k] = lb[(static_cast<size_t>(ty) * gx + tx) * kBins + bin];
  }
  __syncthreads();

  // only the part of this tile inside the image is written (the tile
  // geometry is that of the padded image; the pad itself is cropped)
  const int y0 = il * th + sub * rpb, x0 = j * tw;
  const int rows = min(min(rpb, th - sub * rpb), H - y0);
  const int cols = min(tw, W - x0);
  if (rows <= 0 || cols <= 0) return;
  const float* img = x + static_cast<size_t>(b) * H * W;
  float* dst = out + static_cast<size_t>(b) * H * W;
  for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
    const int y = y0 + p / cols, c = x0 + p % cols;
    const size_t at = static_cast<size_t>(y) * W + c;
    const int v = level_of(img[at]);

    // OpenCV: txf = x * (1/tw) - 0.5; tx1 = max(floor, 0);
    // tx2 = min(UNCLIPPED floor + 1, gx - 1); xa = txf - floor
    const float tyf =
        __fsub_rn(__fmul_rn(static_cast<float>(y + y_off), inv_th), 0.5f);
    const float txf = __fsub_rn(__fmul_rn(static_cast<float>(c), inv_tw), 0.5f);
    const float fy = floorf(tyf), fx = floorf(txf);
    const float ya = __fsub_rn(tyf, fy), xa = __fsub_rn(txf, fx);
    const int ty1 = max(static_cast<int>(fy), 0);
    const int ty2 = min(static_cast<int>(fy) + 1, gy - 1);
    const int tx1 = max(static_cast<int>(fx), 0);
    const int tx2 = min(static_cast<int>(fx) + 1, gx - 1);

    const float* row1 = stack + (ty1 - i + 1) * 3 * kBins + v;
    const float* row2 = stack + (ty2 - i + 1) * 3 * kBins + v;
    const int c1 = (tx1 - j + 1) * kBins, c2 = (tx2 - j + 1) * kBins;
    const float omx = __fsub_rn(1.0f, xa), omy = __fsub_rn(1.0f, ya);
    const float top = __fadd_rn(__fmul_rn(row1[c1], omx), __fmul_rn(row1[c2], xa));
    const float bot = __fadd_rn(__fmul_rn(row2[c1], omx), __fmul_rn(row2[c2], xa));
    const float res = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, ya));
    dst[at] = clip01 ? fminf(fmaxf(res, 0.0f), 1.0f)
                     : __fdiv_rn(fminf(fmaxf(rintf(res), 0.0f), 255.0f), 255.0f);
  }
}

// K1/K2/K5's rows of one tile per block: the whole tile up to
// kPixelsPerBlock pixels, else strips of about that many.
int rows_per_block(int th, int tw) {
  return min(th, max(1, (kPixelsPerBlock + tw - 1) / tw));
}

// Zero a histogram that several blocks per tile add into.
cudaError_t zero_if_split(int* hist, size_t count, int th, int rpb,
                          cudaStream_t stream) {
  if (rpb >= th) return cudaSuccess;
  return cudaMemsetAsync(hist, 0, count * sizeof(int), stream);
}

}  // namespace

// x: [B, H, W] f32; hist: [B, gy, gx, 256] int32. (th, tw) is the tile of
// the image padded up to a multiple of the grid.
extern "C" int mies_tile_hists(const float* x, int* hist, int B, int H, int W,
                               int gy, int gx, int th, int tw,
                               cudaStream_t stream) {
  const int rpb = rows_per_block(th, tw);
  const cudaError_t err = zero_if_split(
      hist, static_cast<size_t>(B) * gy * gx * kBins, th, rpb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_hists_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads, 0,
                      stream>>>(x, hist, H, W, gy, gx, th, tw, rpb);
  return static_cast<int>(cudaGetLastError());
}

// bins: [B, H, W] int32; hist: [B, gy, gx, nbins] int32, counted over the
// window rows [y0, y0 + gy*th) and columns [x0, x0 + gx*tw).
extern "C" int mies_tile_hists_bins(const int* bins, int* hist, int B, int H,
                                    int W, int y0, int x0, int gy, int gx,
                                    int th, int tw, int nbins,
                                    cudaStream_t stream) {
  const int rpb = rows_per_block(th, tw);
  const cudaError_t err = zero_if_split(
      hist, static_cast<size_t>(B) * gy * gx * nbins, th, rpb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_hists_bins_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads,
                           nbins * sizeof(int), stream>>>(
      bins, hist, H, W, y0, x0, gy, gx, th, tw, nbins, rpb);
  return static_cast<int>(cudaGetLastError());
}

// x, out: [B, H, W] f32; luts: [B, gy, gx, 256] f32 (integer-valued for
// the u8norm epilogue, fractional for clip01). inv_th / inv_tw are the
// host's correctly rounded f32 reciprocals; clip01 selects the epilogue.
extern "C" int mies_apply_lut(const float* x, const float* luts, float* out,
                              int B, int H, int W, int gy, int gx, int th,
                              int tw, float inv_th, float inv_tw, int clip01,
                              cudaStream_t stream) {
  const int rpb = rows_per_block(th, tw);
  apply_lut_kernel<<<dim3(gx, gy * ((th + rpb - 1) / rpb), B), kThreads, 0,
                     stream>>>(x, luts, out, H, W, gy, gx, th, tw, inv_th,
                               inv_tw, 0, rpb, clip01);
  return static_cast<int>(cudaGetLastError());
}

// K5. x, out: [B, H, W] f32, a band of H = (rows of tiles) * th rows whose
// first row is global row y_off (a multiple of th) of a slice W = gx * tw
// wide; luts: [B, gy, gx, 256] f32, the whole slice's grid.
extern "C" int mies_apply_lut_band(const float* x, const float* luts,
                                   float* out, int B, int H, int W, int gy,
                                   int gx, int th, int tw, float inv_th,
                                   float inv_tw, int y_off, int clip01,
                                   cudaStream_t stream) {
  if (th < 1 || H % th != 0 || y_off % th != 0 || y_off < 0 ||
      y_off + H > gy * th || W != gx * tw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rpb = rows_per_block(th, tw);
  apply_lut_kernel<<<dim3(gx, (H / th) * ((th + rpb - 1) / rpb), B),
                     kThreads, 0, stream>>>(x, luts, out, H, W, gy, gx, th,
                                            tw, inv_th, inv_tw, y_off, rpb,
                                            clip01);
  return static_cast<int>(cudaGetLastError());
}
