// K8 + K8s: 3-D CLAHE on a [Z, H, W] float32 volume.
//
// K8 (mies_clahe3d_apply) replaces mies_tpu/kernels/clahe.py:_apply33z_kernel
// (the opencv fast path of mies_tpu/ops/volume3d.py:clahe3d) and answers the
// opencv mode of :_blocks8_kernel (the same global-cell fractions): the
// trilinear blend of the 8 neighbouring volumetric tiles' LUTs at each
// voxel's uint8 level clip(rint(x * 255), 0, 255), computed in the kernel.
// Per axis the OpenCV weights of ops.volume3d._axis_weights: f = i * (1/t)
// - 0.5 with the host's correctly rounded f32 reciprocal, lo = max(floor, 0),
// hi = min(floor + 1, g - 1), a = f - floor; blend x, then y, then z. Then
// the u8norm epilogue clip(rint(v), 0, 255) / 255 (opencv, integer LUTs) or
// clip01 (fraction LUTs, K8c), as K2. The TPU selected LUT entries by onehot
// matmul against a z-lo / z-hi pair of 3x3 LUT stacks because it has no
// gather. Here, as K2 does in 2-D (clahe.cu), a block owns (a strip of) one
// interpolation cell (cz, cy, cx): the region between eight tile centres,
// whose voxels all blend the same 8 LUTs. It stages just those, as two
// float4 per level (the z-lo quad and the z-hi quad, 8 KB), so a voxel takes
// two 16-byte shared loads instead of 8 gathers from the 256 KB LUT array.
// The cell's slices, rows and columns are found on the device with the
// blend's own f32 formula (cells.cuh cell_start): the f32 weights can move
// a cell edge by one, and no rounding edge may send a voxel to a LUT the
// block did not stage. A cell's (slice, row) pairs are cut into strips of
// about kPixelsPerBlock voxels, one block each (grid: x cell, column chunk
// and strip on x; y cell on y; z cell on z). Each thread keeps its column
// unit (four columns on 16-byte aligned rows: float4 loads and stores,
// scalar head and tail) while it walks the strip's rows: the x weights are
// computed once per column, the y weight once per row, the z weight once
// per slice. u8norm divides by 255 through a table of the correctly
// rounded quotients. Bound: 4 B read + 4 B written per voxel.
//
// K8z (mies_clahe3d_apply_band) is K8 at a z offset, as K5 is K2 at a row
// offset: the apply of one tile-aligned z band [zb, H, W] of a z-sharded
// volume (parallel/volume_shard.py clahe3d_band) against the FULL
// all-gathered [gz, gy, gx, 256] LUT grid. It replaces the band apply of
// mies_tpu/parallel/volume_shard.py (_trilinear_zband_selection, the TPU's
// selection-by-matmul form of _trilinear_zband_gather). The band's first
// slice is global slice z0; the z weights are taken at the global slice,
// f = (z0 + z) * (1/tz) - 0.5, the unsharded K8's own expression, and the
// cell edges are cell_start at global z cut to [z0, z0 + zb), so the bands
// concatenate to K8's output bit for bit. Only the z cells that meet the
// band launch (cz0 .. cz0 + ncz - 1, from the same f32 formula on the host).
// K8 and K8z share the kernel (K8 passes z0 = 0 and every cell).
//
// K8s (mies_clahe3d_skimage_apply) replaces the skimage mode of
// mies_tpu/kernels/clahe.py:_blocks8_kernel: skimage's blend of the 8
// neighbouring region maps of the edge-padded map array at each voxel's
// bin, coefficients (cz * cy) * cx from arange(k) / k by true division,
// the 8 sel * coeff terms summed in corner order (z, y, x lexicographic)
// and floored. K8's design on skimage's regions (regions.cuh): a block owns
// (a strip of) one region block (bz, by, bx) of the padded volume, cut to
// the crop, whose voxels all blend map_array[bz + ez, by + ey, bx + ex].
// Its edges are multiples of k, so no edge search. The 8 maps are staged
// as two float4 per bin (the z-lo and the z-hi quad; 8 KB at 256 bins,
// 32 KB at 1024), so a voxel takes two 16-byte shared loads instead of 8
// gathers from the map array in device memory. A block's (slice, row)
// pairs are cut into strips of about kernels/clahe.py SK_PIXELS_PER_BLOCK
// voxels (grid: x block, column chunk and strip on x; y block on y; z
// block on z: Z is no grid dimension). Each thread keeps its column unit
// (four columns, an int4 load of bins and a float4 store, where the bins
// rows, the crop's x origin and the output rows are 16-byte aligned;
// scalar head and tail) while it walks the pairs: wx once per column, wy
// once per row, wz once per slice, the four cz * cy once per row; per
// voxel the 8 coefficients (cz * cy) * cx, the 8 terms in corner order,
// floorf: the plain version's order, so bit-equal. Bound: 4 B of bins in +
// 4 B out per voxel.
//
// Every multiply, add and divide is an explicit _rn intrinsic: nvcc would
// contract a*b+c into FMA, which breaks the bit-exactness against the
// plain versions.

#include <cuda_runtime.h>

#include "cells.cuh"
#include "regions.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;  // kernels/clahe3d.py THREADS
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxBins = 1024;  // kernels/clahe.py MAX_BINS

// lo * (1 - a) + hi * a, with 1 - a given
__device__ __forceinline__ float lerp_rn(float lo, float hi, float a,
                                         float oma) {
  return __fadd_rn(__fmul_rn(lo, oma), __fmul_rn(hi, a));
}

// OpenCV's weight of position p along an axis, and its complement
struct Weight {
  float a, oma;
};

__device__ __forceinline__ Weight weight_of(int p, float inv) {
  const float f = cell_pos(p, inv);
  const float a = __fsub_rn(f, floorf(f));
  return {a, __fsub_rn(1.0f, a)};
}

// K8's blend at one voxel: x first (c00, c01, c10, c11), then y, then z,
// the plain gather form's order; lo / hi are the z-lo and z-hi quads
// (y-lo x-lo, y-lo x-hi, y-hi x-lo, y-hi x-hi).
template <bool kClip01>
__device__ __forceinline__ float blend8(const float4& lo, const float4& hi,
                                        Weight wx, Weight wy, Weight wz,
                                        const float* div255) {
  const float c00 = lerp_rn(lo.x, lo.y, wx.a, wx.oma);
  const float c01 = lerp_rn(lo.z, lo.w, wx.a, wx.oma);
  const float c10 = lerp_rn(hi.x, hi.y, wx.a, wx.oma);
  const float c11 = lerp_rn(hi.z, hi.w, wx.a, wx.oma);
  const float c0 = lerp_rn(c00, c01, wy.a, wy.oma);
  const float c1 = lerp_rn(c10, c11, wy.a, wy.oma);
  const float res = lerp_rn(c0, c1, wz.a, wz.oma);
  if (kClip01) return fminf(fmaxf(res, 0.0f), 1.0f);
  return div255[static_cast<int>(fminf(fmaxf(rintf(res), 0.0f), 255.0f))];
}

// Block (((strip * (gx + 1)) + cx + 1) * col_splits + csub, cy + 1,
// cz - cz0) owns the (slice, row) pairs [strip * rpb, (strip + 1) * rpb) of
// cell (cz, cy, cx), in slice-major order, and column units [csub *
// kThreads, ...) of it. x and out hold the global slices [z0, z0 + Z). A
// cell spans at most t + 1 positions of an axis (the f32 weights may move
// an edge by one): rpb, strips and col_splits come from kernels/clahe3d.py
// apply_launch, which sizes them for that.
template <bool kClip01>
__global__ void __launch_bounds__(kThreads)
clahe3d_apply_kernel(const float* __restrict__ x,
                     const float* __restrict__ luts, float* __restrict__ out,
                     int Z, int H, int W, int gz, int gy, int gx, int tz,
                     int th, int tw, float inv_tz, float inv_th, float inv_tw,
                     int z0, int cz0, int rpb, int col_splits, int vec_ok) {
  __shared__ float4 quad[2][kBins];
  __shared__ float div255[kBins];
  const int csub = blockIdx.x % col_splits;
  const int rest = blockIdx.x / col_splits;
  const int cx = rest % (gx + 1) - 1, strip = rest / (gx + 1);
  const int cy = static_cast<int>(blockIdx.y) - 1;
  const int cz = cz0 + static_cast<int>(blockIdx.z);

  // this block's global slices, rows and columns, by the blend's formula
  const int z_lo = cell_start(cz, tz, inv_tz, z0, z0 + Z);
  const int z_hi = cell_start(cz + 1, tz, inv_tz, z0, z0 + Z);
  const int y_lo = cell_start(cy, th, inv_th, 0, H);
  const int y_hi = cell_start(cy + 1, th, inv_th, 0, H);
  const int x_lo = cell_start(cx, tw, inv_tw, 0, W);
  const int x_hi = cell_start(cx + 1, tw, inv_tw, 0, W);
  const int ny = y_hi - y_lo;
  const int r_lo = strip * rpb;
  const int r_hi = min(r_lo + rpb, (z_hi - z_lo) * ny);
  if (r_lo >= r_hi || x_lo >= x_hi) return;
  // column units: scalar head, float4 body (rows 16-byte aligned), scalar
  // tail
  const Units units(x_lo, x_hi, vec_ok);
  const int u_lo = csub * kThreads;
  if (u_lo >= units.n) return;
  const int nu = min(units.n - u_lo, kThreads);

  // the cell's 8 LUTs: the z-lo and the z-hi quad, one float4 each a level
  {
    const int z1 = max(cz, 0), z2 = min(cz + 1, gz - 1);
    const int y1 = max(cy, 0), y2 = min(cy + 1, gy - 1);
    const int x1 = max(cx, 0), x2 = min(cx + 1, gx - 1);
    const int v = threadIdx.x;
    auto lut = [&](int zi, int yi, int xi) {
      return luts[((static_cast<size_t>(zi) * gy + yi) * gx + xi) * kBins + v];
    };
    quad[0][v] = make_float4(lut(z1, y1, x1), lut(z1, y1, x2),
                             lut(z1, y2, x1), lut(z1, y2, x2));
    quad[1][v] = make_float4(lut(z2, y1, x1), lut(z2, y1, x2),
                             lut(z2, y2, x1), lut(z2, y2, x2));
    if (!kClip01) div255[v] = __fdiv_rn(static_cast<float>(v), 255.0f);
  }
  __syncthreads();

  // this thread's unit and first (slice, row) pair; it keeps the unit
  // while it walks the pairs
  const int rows_per_pass = kThreads / nu;
  const int rrow = threadIdx.x / nu;
  int r = r_lo + rrow;
  if (rrow >= rows_per_pass || r >= r_hi) return;
  const int u = u_lo + threadIdx.x - rrow * nu;
  const bool vec = units.is_vec(u);
  const int c = units.col(u);
  Weight wx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wx[k] = weight_of(c + k, inv_tw);
  int z = z_lo + r / ny, y = y_lo + r % ny;
  Weight wz = weight_of(z, inv_tz);
  for (;;) {
    const Weight wy = weight_of(y, inv_th);
    const size_t at = (static_cast<size_t>(z - z0) * H + y) * W + c;
    if (vec) {
      const float4 p = *reinterpret_cast<const float4*>(x + at);
      const int l0 = level_of(p.x), l1 = level_of(p.y);
      const int l2 = level_of(p.z), l3 = level_of(p.w);
      float4 o;
      o.x = blend8<kClip01>(quad[0][l0], quad[1][l0], wx[0], wy, wz, div255);
      o.y = blend8<kClip01>(quad[0][l1], quad[1][l1], wx[1], wy, wz, div255);
      o.z = blend8<kClip01>(quad[0][l2], quad[1][l2], wx[2], wy, wz, div255);
      o.w = blend8<kClip01>(quad[0][l3], quad[1][l3], wx[3], wy, wz, div255);
      *reinterpret_cast<float4*>(out + at) = o;
    } else {
      const int l = level_of(x[at]);
      out[at] = blend8<kClip01>(quad[0][l], quad[1][l], wx[0], wy, wz, div255);
    }
    r += rows_per_pass;
    if (r >= r_hi) break;
    y += rows_per_pass;
    if (y >= y_hi) {  // the next slice (or several, for short rows)
      const int q = (y - y_lo) / ny;
      z += q;
      y -= q * ny;
      wz = weight_of(z, inv_tz);
    }
  }
}

// skimage's 8-map blend at bin v: lo / hi are the z-lo and z-hi quads
// (y-lo x-lo, y-lo x-hi, y-hi x-lo, y-hi x-hi), czy the four cz * cy in
// (z, y) order, cx the column's weights.
__device__ __forceinline__ float blend8s(const float4& lo, const float4& hi,
                                         const float* czy, Weights cx) {
  float acc = __fmul_rn(lo.x, __fmul_rn(czy[0], cx.lo));
  acc = __fadd_rn(acc, __fmul_rn(lo.y, __fmul_rn(czy[0], cx.hi)));
  acc = __fadd_rn(acc, __fmul_rn(lo.z, __fmul_rn(czy[1], cx.lo)));
  acc = __fadd_rn(acc, __fmul_rn(lo.w, __fmul_rn(czy[1], cx.hi)));
  acc = __fadd_rn(acc, __fmul_rn(hi.x, __fmul_rn(czy[2], cx.lo)));
  acc = __fadd_rn(acc, __fmul_rn(hi.y, __fmul_rn(czy[2], cx.hi)));
  acc = __fadd_rn(acc, __fmul_rn(hi.z, __fmul_rn(czy[3], cx.lo)));
  acc = __fadd_rn(acc, __fmul_rn(hi.w, __fmul_rn(czy[3], cx.hi)));
  return floorf(acc);
}

// Block ((strip * nbx + bxi) * col_splits + csub, byi, bzi) owns the
// (slice, row) pairs [strip * rpb, (strip + 1) * rpb) of region block
// (bz, by, bx) = (z0 / kz + bzi, y0 / ky + byi, x0 / kx + bxi), cut to the
// crop, in slice-major order, and its column units [csub * kThreads, ...).
// rpb, strips and col_splits: kernels/clahe3d.py skimage_launch.
__global__ void __launch_bounds__(kThreads)
clahe3d_skimage_apply_kernel(const int* __restrict__ bins,
                             const float* __restrict__ maps,
                             float* __restrict__ out, int Hp, int Wp,
                             int ny1, int nx1, int kz, int ky, int kx,
                             int nbins, int z0, int y0, int x0, int Z0,
                             int H0, int W0, int nbx, int rpb, int col_splits,
                             int vec_ok) {
  extern __shared__ float4 quads[];  // [2][nbins]: the z-lo, z-hi quads
  const int csub = blockIdx.x % col_splits;
  const int rest = blockIdx.x / col_splits;
  const int bx = x0 / kx + rest % nbx, strip = rest / nbx;
  const int by = y0 / ky + static_cast<int>(blockIdx.y);
  const int bz = z0 / kz + static_cast<int>(blockIdx.z);
  const Span sz = region_span(bz, kz, z0, Z0);
  const Span sy = region_span(by, ky, y0, H0);
  const Span sx = region_span(bx, kx, x0, W0);
  const int ny = sy.hi - sy.lo;
  const int r_lo = strip * rpb;
  const int r_hi = min(r_lo + rpb, (sz.hi - sz.lo) * ny);
  if (r_lo >= r_hi) return;  // block-uniform, before the barrier
  const Units units(sx.lo, sx.hi, vec_ok);
  const int u_lo = csub * kThreads;
  if (u_lo >= units.n) return;
  const int nu = min(units.n - u_lo, kThreads);

  // the block's 8 maps: the z-lo and the z-hi quad, one float4 each a bin
  {
    auto map = [&](int ez, int ey, int ex) {
      return maps + ((static_cast<size_t>(bz + ez) * ny1 + by + ey) * nx1 +
                     bx + ex) * nbins;
    };
    const float *m000 = map(0, 0, 0), *m001 = map(0, 0, 1),
                *m010 = map(0, 1, 0), *m011 = map(0, 1, 1),
                *m100 = map(1, 0, 0), *m101 = map(1, 0, 1),
                *m110 = map(1, 1, 0), *m111 = map(1, 1, 1);
    for (int v = threadIdx.x; v < nbins; v += kThreads) {
      quads[v] = make_float4(m000[v], m001[v], m010[v], m011[v]);
      quads[nbins + v] = make_float4(m100[v], m101[v], m110[v], m111[v]);
    }
  }
  __syncthreads();

  // this thread's unit and first (slice, row) pair; it keeps the unit
  // while it walks the pairs
  const int rows_per_pass = kThreads / nu;
  const int rrow = threadIdx.x / nu;
  int r = r_lo + rrow;
  if (rrow >= rows_per_pass || r >= r_hi) return;
  const int u = u_lo + threadIdx.x - rrow * nu;
  const bool vec = units.is_vec(u);
  const int c = units.col(u);
  Weights wx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wx[k] = region_weights(c + k, bx, kx);
  // the wrapper's binning keeps bins in [0, nbins); the clamp keeps the
  // shared loads inside the quads whatever the input
  auto blend = [&](int v, const float* czy, Weights cx) {
    v = min(max(v, 0), nbins - 1);
    return blend8s(quads[v], quads[nbins + v], czy, cx);
  };
  int z = sz.lo + r / ny, y = sy.lo + r % ny;
  Weights wz = region_weights(z, bz, kz);
  for (;;) {
    const Weights wy = region_weights(y, by, ky);
    const float czy[4] = {__fmul_rn(wz.lo, wy.lo), __fmul_rn(wz.lo, wy.hi),
                          __fmul_rn(wz.hi, wy.lo), __fmul_rn(wz.hi, wy.hi)};
    const int* s = bins + (static_cast<size_t>(z) * Hp + y) * Wp + c;
    float* d = out + (static_cast<size_t>(z - z0) * H0 + (y - y0)) * W0 +
               (c - x0);
    if (vec) {
      const int4 v = *reinterpret_cast<const int4*>(s);
      float4 o;
      o.x = blend(v.x, czy, wx[0]);
      o.y = blend(v.y, czy, wx[1]);
      o.z = blend(v.z, czy, wx[2]);
      o.w = blend(v.w, czy, wx[3]);
      *reinterpret_cast<float4*>(d) = o;
    } else {
      *d = blend(*s, czy, wx[0]);
    }
    r += rows_per_pass;
    if (r >= r_hi) break;
    y += rows_per_pass;
    if (y >= sy.hi) {  // the next slice (or several, for short rows)
      const int q = (y - sy.lo) / ny;
      z += q;
      y -= q * ny;
      wz = region_weights(z, bz, kz);
    }
  }
}

}  // namespace

namespace {

cudaError_t launch_apply3d(const float* x, const float* luts, float* out,
                           int Z, int H, int W, int gz, int gy, int gx,
                           int tz, int th, int tw, float inv_tz, float inv_th,
                           float inv_tw, int z0, int cz0, int ncz, int rpb,
                           int strips, int col_splits, int vec_ok, int clip01,
                           cudaStream_t stream) {
  const long long blocks_x = static_cast<long long>(gx + 1) * col_splits *
                             strips;
  if (rpb < 1 || strips < 1 || col_splits < 1 || gy + 1 > kMaxGridYZ ||
      ncz < 1 || ncz > kMaxGridYZ || blocks_x > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), gy + 1, ncz);
  if (clip01) {
    clahe3d_apply_kernel<true><<<grid, kThreads, 0, stream>>>(
        x, luts, out, Z, H, W, gz, gy, gx, tz, th, tw, inv_tz, inv_th, inv_tw,
        z0, cz0, rpb, col_splits, vec_ok);
  } else {
    clahe3d_apply_kernel<false><<<grid, kThreads, 0, stream>>>(
        x, luts, out, Z, H, W, gz, gy, gx, tz, th, tw, inv_tz, inv_th, inv_tw,
        z0, cz0, rpb, col_splits, vec_ok);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: [Z, H, W] f32; luts: [gz, gy, gx, 256] f32 (integer-valued for
// the u8norm epilogue, fractional for clip01). (tz, th, tw) is the tile;
// inv_* are the host's correctly rounded f32 reciprocals of it. rpb,
// strips and col_splits: kernels/clahe3d.py apply_launch; vec_ok: x and
// out rows are 16-byte aligned.
extern "C" int mies_clahe3d_apply(const float* x, const float* luts,
                                  float* out, int Z, int H, int W, int gz,
                                  int gy, int gx, int tz, int th, int tw,
                                  float inv_tz, float inv_th, float inv_tw,
                                  int rpb, int strips, int col_splits,
                                  int vec_ok, int clip01,
                                  cudaStream_t stream) {
  return static_cast<int>(launch_apply3d(
      x, luts, out, Z, H, W, gz, gy, gx, tz, th, tw, inv_tz, inv_th, inv_tw,
      0, -1, gz + 1, rpb, strips, col_splits, vec_ok, clip01, stream));
}

// K8z. x, out: [Zb, H, W] f32, the tile-aligned band whose first slice is
// global slice z0 (a multiple of tz) of a volume of gz * tz slices; luts:
// the whole volume's [gz, gy, gx, 256] grid. The z cells cz0 .. cz0 + ncz -
// 1 launch (kernels/clahe3d.py band_launch: those that meet the band).
extern "C" int mies_clahe3d_apply_band(
    const float* x, const float* luts, float* out, int Zb, int H, int W,
    int gz, int gy, int gx, int tz, int th, int tw, float inv_tz,
    float inv_th, float inv_tw, int z0, int cz0, int ncz, int rpb, int strips,
    int col_splits, int vec_ok, int clip01, cudaStream_t stream) {
  if (tz < 1 || Zb < tz || Zb % tz != 0 || z0 < 0 || z0 % tz != 0 ||
      z0 + Zb > gz * tz || cz0 < -1 || cz0 + ncz > gz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_apply3d(
      x, luts, out, Zb, H, W, gz, gy, gx, tz, th, tw, inv_tz, inv_th, inv_tw,
      z0, cz0, ncz, rpb, strips, col_splits, vec_ok, clip01, stream));
}

// bins: [Zp, Hp, Wp] int32 bins of the padded volume; maps: [nz1, ny1, nx1,
// nbins] f32, the edge-padded region maps; out: [Z0, H0, W0] f32, the crop
// whose first voxel is (z0, y0, x0) of the padded volume. nbx, nby, nbz,
// rpb, strips, col_splits: kernels/clahe3d.py skimage_launch; vec_ok: bins
// and out rows 16-byte aligned and x0 % 4 == 0 (refused if the pointers
// say otherwise).
extern "C" int mies_clahe3d_skimage_apply(
    const int* bins, const float* maps, float* out, int Hp, int Wp, int ny1,
    int nx1, int kz, int ky, int kx, int nbins, int z0, int y0, int x0,
    int Z0, int H0, int W0, int nbx, int nby, int nbz, int rpb, int strips,
    int col_splits, int vec_ok, cudaStream_t stream) {
  const long long blocks_x =
      static_cast<long long>(nbx) * strips * col_splits;
  if (rpb < 1 || strips < 1 || col_splits < 1 || nbins < 1 ||
      nbins > kMaxBins || nby > kMaxGridYZ || nbz > kMaxGridYZ ||
      blocks_x > 0x7fffffffLL ||
      (vec_ok && !(rows_aligned(bins, Wp) && rows_aligned(out, W0) &&
                   x0 % 4 == 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), nby, nbz);
  clahe3d_skimage_apply_kernel<<<grid, kThreads, 2 * nbins * sizeof(float4),
                                 stream>>>(
      bins, maps, out, Hp, Wp, ny1, nx1, kz, ky, kx, nbins, z0, y0, x0, Z0,
      H0, W0, nbx, rpb, col_splits, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
