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
// clip01 (fraction LUTs), as K2. The TPU selected LUT entries by onehot
// matmul against a z-lo / z-hi pair of 3x3 LUT stacks; Hopper gathers: one
// thread per voxel reads its 8 corner entries by index from the LUT array
// (at most 4 x 8 x 8 x 256 x 4 B = 256 KB, which L2 and the block's L1
// hold). Bound: 4 B read + 4 B written per voxel; about 50 f32 operations
// per voxel.
//
// K8s (mies_clahe3d_skimage_apply) replaces the skimage mode of
// mies_tpu/kernels/clahe.py:_blocks8_kernel: skimage's blend of the 8
// neighbouring region maps of the edge-padded map array at each voxel's
// bin, coefficients (cz * cy) * cx from arange(k) / k by true division,
// the 8 sel * coeff terms summed in corner order (z, y, x lexicographic)
// and floored. One thread per voxel of the output crop, reading the padded
// binned volume in place at the crop's origin. Bound: 4 B of bins in + 4 B
// out per voxel.
//
// Every multiply, add and divide is an explicit _rn intrinsic: nvcc would
// contract a*b+c into FMA, which breaks the bit-exactness against the
// plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ int level_of(float v) {
  const float q = rintf(__fmul_rn(v, 255.0f));
  return static_cast<int>(fminf(fmaxf(q, 0.0f), 255.0f));
}

// OpenCV's per-axis weights of index i: lo / hi tile and the fraction.
struct Axis {
  int lo, hi;
  float a;
};

__device__ __forceinline__ Axis axis_of(int i, float inv, int g) {
  const float f = __fsub_rn(__fmul_rn(static_cast<float>(i), inv), 0.5f);
  const float fl = floorf(f);
  return {max(static_cast<int>(fl), 0), min(static_cast<int>(fl) + 1, g - 1),
          __fsub_rn(f, fl)};
}

__device__ __forceinline__ float lerp_rn(float lo, float hi, float a) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.0f, a)), __fmul_rn(hi, a));
}

__global__ void __launch_bounds__(kThreads)
clahe3d_apply_kernel(const float* __restrict__ x, const float* __restrict__ luts,
                     float* __restrict__ out, int H, int W, int gz, int gy,
                     int gx, float inv_tz, float inv_th, float inv_tw,
                     int clip01) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, z = blockIdx.z;
  if (c >= W) return;
  const size_t at = (static_cast<size_t>(z) * H + y) * W + c;
  const int v = level_of(x[at]);
  const Axis az = axis_of(z, inv_tz, gz);
  const Axis ay = axis_of(y, inv_th, gy);
  const Axis ax = axis_of(c, inv_tw, gx);

  auto lut = [&](int zi, int yi, int xi) {
    return __ldg(luts + ((static_cast<size_t>(zi) * gy + yi) * gx + xi) * kBins + v);
  };
  const float c00 = lerp_rn(lut(az.lo, ay.lo, ax.lo), lut(az.lo, ay.lo, ax.hi), ax.a);
  const float c01 = lerp_rn(lut(az.lo, ay.hi, ax.lo), lut(az.lo, ay.hi, ax.hi), ax.a);
  const float c10 = lerp_rn(lut(az.hi, ay.lo, ax.lo), lut(az.hi, ay.lo, ax.hi), ax.a);
  const float c11 = lerp_rn(lut(az.hi, ay.hi, ax.lo), lut(az.hi, ay.hi, ax.hi), ax.a);
  const float c0 = lerp_rn(c00, c01, ay.a);
  const float c1 = lerp_rn(c10, c11, ay.a);
  const float res = lerp_rn(c0, c1, az.a);
  out[at] = clip01 ? fminf(fmaxf(res, 0.0f), 1.0f)
                   : __fdiv_rn(fminf(fmaxf(rintf(res), 0.0f), 255.0f), 255.0f);
}

// Block index and skimage weight w = (p % k) / k of padded coordinate p.
struct Cell {
  int b;
  float w;
};

__device__ __forceinline__ Cell cell_of(int p, int k) {
  return {p / k, __fdiv_rn(static_cast<float>(p % k), static_cast<float>(k))};
}

__global__ void __launch_bounds__(kThreads)
clahe3d_skimage_apply_kernel(const int* __restrict__ bins,
                             const float* __restrict__ maps,
                             float* __restrict__ out, int Hp, int Wp,
                             int ny1, int nx1, int kz, int ky, int kx,
                             int nbins, int z0, int y0, int x0, int H0,
                             int W0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, z = blockIdx.z;
  if (c >= W0) return;
  const int pz = z0 + z, py = y0 + y, px = x0 + c;
  const int v = bins[(static_cast<size_t>(pz) * Hp + py) * Wp + px];
  const Cell cz = cell_of(pz, kz), cy = cell_of(py, ky), cx = cell_of(px, kx);
  const float wz[2] = {__fsub_rn(1.0f, cz.w), cz.w};
  const float wy[2] = {__fsub_rn(1.0f, cy.w), cy.w};
  const float wx[2] = {__fsub_rn(1.0f, cx.w), cx.w};

  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ez = e >> 2, ey = (e >> 1) & 1, ex = e & 1;
    const size_t cell =
        (static_cast<size_t>(cz.b + ez) * ny1 + cy.b + ey) * nx1 + cx.b + ex;
    const float term = __fmul_rn(__ldg(maps + cell * nbins + v),
                                 __fmul_rn(__fmul_rn(wz[ez], wy[ey]), wx[ex]));
    acc = e == 0 ? term : __fadd_rn(acc, term);
  }
  out[(static_cast<size_t>(z) * H0 + y) * W0 + c] = floorf(acc);
}

}  // namespace

// x, out: [Z, H, W] f32; luts: [gz, gy, gx, 256] f32 (integer-valued for
// the u8norm epilogue, fractional for clip01). inv_* are the host's
// correctly rounded f32 reciprocals of the tile extents tz, th, tw.
extern "C" int mies_clahe3d_apply(const float* x, const float* luts,
                                  float* out, int Z, int H, int W, int gz,
                                  int gy, int gx, float inv_tz, float inv_th,
                                  float inv_tw, int clip01,
                                  cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, Z);
  clahe3d_apply_kernel<<<grid, kThreads, 0, stream>>>(
      x, luts, out, H, W, gz, gy, gx, inv_tz, inv_th, inv_tw, clip01);
  return static_cast<int>(cudaGetLastError());
}

// bins: [Zp, Hp, Wp] int32 bins of the padded volume; maps: [nz1, ny1, nx1,
// nbins] f32, the edge-padded region maps; out: [Z0, H0, W0] f32, the crop
// whose first voxel is (z0, y0, x0) of the padded volume.
extern "C" int mies_clahe3d_skimage_apply(const int* bins, const float* maps,
                                          float* out, int Hp, int Wp, int ny1,
                                          int nx1, int kz, int ky, int kx,
                                          int nbins, int z0, int y0, int x0,
                                          int Z0, int H0, int W0,
                                          cudaStream_t stream) {
  const dim3 grid((W0 + kThreads - 1) / kThreads, H0, Z0);
  clahe3d_skimage_apply_kernel<<<grid, kThreads, 0, stream>>>(
      bins, maps, out, Hp, Wp, ny1, nx1, kz, ky, kx, nbins, z0, y0, x0, H0,
      W0);
  return static_cast<int>(cudaGetLastError());
}
