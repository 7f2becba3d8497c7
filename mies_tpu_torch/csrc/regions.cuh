// skimage's interpolation blocks (equalize_adapthist), for K6
// (clahe_skimage.cu) and K8s (clahe3d.cu), as cells.cuh holds OpenCV's
// cells for K2 and K8: padded coordinate p of an axis lies in block p / k
// at weight (p % k) / k by true division (skimage's arange(k) / k). Block
// b holds the positions [b k, (b + 1) k): its edges are exact integers, so
// no f32 edge search is needed. A block's pixels all blend the same region
// maps, so a CUDA block owns (a strip of) one interpolation block and
// stages just those maps.

#pragma once

#include <cuda_runtime.h>

namespace {

// The weights (1 - w, w) of padded position p in block b of k positions:
// w = (p - b k) / k, which is (p % k) / k there.
struct Weights {
  float lo, hi;
};

__device__ __forceinline__ Weights region_weights(int p, int b, int k) {
  const float w =
      __fdiv_rn(static_cast<float>(p - b * k), static_cast<float>(k));
  return {__fsub_rn(1.0f, w), w};
}

// The positions [lo, hi) of block b that lie in the crop [o, o + n).
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span region_span(int b, int k, int o, int n) {
  return {max(b * k, o), min((b + 1) * k, o + n)};
}

}  // namespace
