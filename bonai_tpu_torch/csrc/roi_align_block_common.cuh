// Shared by the block RoIAlign forward (roi_align_block_fwd.cu) and backward
// (roi_align_block_bwd.cu): the level table, the two-channel loads and
// stores, and the per-RoI sample geometry.  Both kernels take every corner
// and weight from here, so the backward spreads each output gradient over
// exactly the corners, with exactly the weights, that the forward read.
//
// The geometry follows ops/roi_align.py (the plain version) step by step,
// with plain multiplies and adds (no FMA contraction) in the coordinate
// math so that the sample points equal the plain version's to the bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align_block {

constexpr int kMaxLevels = 4;
constexpr int kMaxThreads = 128;

// One entry per pyramid level; `ptr` is the level (forward) or its float32
// gradient buffer (backward).
struct Levels {
  void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float inv_stride[kMaxLevels];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Border rule of one axis (ops/roi_align.py::_bilinear_params): true when
// the point lies outside [-1, size] (it then counts zero); otherwise the
// clamped low corner and the fraction towards the next one.
__device__ __forceinline__ bool axis_params(float v, float size, int* i0,
                                            float* frac) {
  const bool outside = (v < -1.0f) || (v > size);
  const float c = fminf(fmaxf(v, 0.0f), size - 1.0f);
  const float f0 = fminf(floorf(c), fmaxf(size - 2.0f, 0.0f));
  *i0 = static_cast<int>(f0);
  *frac = c - f0;
  return outside;
}

// Sample grid of one RoI at its level (aligned=True: half-pixel shift).
struct RoiGrid {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGrid roi_grid(const float* roi, float inv,
                                            int out_h, int out_w) {
  RoiGrid g;
  g.x1 = __fsub_rn(__fmul_rn(roi[1], inv), 0.5f);
  g.y1 = __fsub_rn(__fmul_rn(roi[2], inv), 0.5f);
  const float x2 = __fsub_rn(__fmul_rn(roi[3], inv), 0.5f);
  const float y2 = __fsub_rn(__fmul_rn(roi[4], inv), 0.5f);
  g.bin_w = __fdiv_rn(__fsub_rn(x2, g.x1), static_cast<float>(out_w));
  g.bin_h = __fdiv_rn(__fsub_rn(y2, g.y1), static_cast<float>(out_h));
  return g;
}

// Coordinate of sub-sample `i` of output cell `p` along one axis.
__device__ __forceinline__ float sample_coord(float start, float bin, int p,
                                              int i, int sr) {
  const float gp = __fadd_rn(static_cast<float>(p),
                             __fdiv_rn(i + 0.5f, static_cast<float>(sr)));
  return __fadd_rn(start, __fmul_rn(bin, gp));
}

// Fills the level table from the host arrays (num_levels entries; the rest
// repeat the last level).  Returns false on arguments no kernel takes.
inline bool fill_levels(Levels* lv, void* const* ptrs, const int* heights,
                        const int* widths, const float* inv_strides,
                        int num_levels, int channels, int sampling_ratio,
                        int batch) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels < 2 ||
      channels % 2 != 0 || sampling_ratio < 1 || batch < 1) {
    return false;
  }
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : num_levels - 1;
    lv->ptr[i] = ptrs[j];
    lv->height[i] = heights[j];
    lv->width[i] = widths[j];
    lv->inv_stride[i] = inv_strides[j];
  }
  return true;
}

}  // namespace roi_align_block
