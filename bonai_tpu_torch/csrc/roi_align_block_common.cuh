// Shared by the RoIAlign kernels of the port: the forward
// (roi_align_block_fwd.cu, under the block, the strip and the window-64 rule)
// and the backward (roi_align_block_bwd.cu).  It holds the level table, the
// sample geometry of one RoI, the per-RoI sample tables, the level rules and
// the channel vector loads and stores.  Every kernel takes its corners and
// weights from here, so the backward spreads each output gradient over
// exactly the corners, with exactly the weights, that the forward read.
//
// The geometry follows ops/roi_align.py (the plain version) step by step,
// with plain multiplies and adds (no FMA contraction) in the coordinate math
// so that the sample points equal the plain version's to the bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align_block {

constexpr int kMaxLevels = 4;

// One entry per pyramid level; `ptr` is the level (forward) or its gradient
// (backward).
struct Levels {
  void* ptr[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float inv_stride[kMaxLevels];
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// V adjacent channels of type T moved as one aligned access of V * sizeof(T)
// bytes (4, 8 or 16), converted to or from float32.  The access is split
// into 32-bit words member by member, so the vector stays in registers.
__device__ __forceinline__ void to_words(unsigned int r, unsigned int (&w)[1]) {
  w[0] = r;
}
__device__ __forceinline__ void to_words(uint2 r, unsigned int (&w)[2]) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void to_words(uint4 r, unsigned int (&w)[4]) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ unsigned int from_words(const unsigned int (&w)[1]) {
  return w[0];
}
__device__ __forceinline__ uint2 from_words(const unsigned int (&w)[2]) {
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint4 from_words(const unsigned int (&w)[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int Words>
struct Raw;
template <>
struct Raw<1> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint4;
};

template <typename T, int V>
struct ChannelVec {
  static constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;
  using R = typename Raw<kWords>::type;

  static __device__ __forceinline__ void load(const T* p, float (&v)[V]) {
    unsigned int w[kWords];
    to_words(__ldg(reinterpret_cast<const R*>(p)), w);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        v[k] = __uint_as_float(w[k]);
      } else {  // bfloat16: the upper half of a float32
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }

  static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
    unsigned int w[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        w[k] = __float_as_uint(v[k]);
      } else {  // round to nearest even, as torch's cast
        w[k] = static_cast<unsigned int>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
               (static_cast<unsigned int>(
                    __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
                << 16);
      }
    }
    *reinterpret_cast<R*>(p) = from_words(w);
  }
};

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

// One sample coordinate of an RoI along one axis: its two corner cells and
// their weights (1 - frac, frac).  A sample outside [-1, size] keeps valid
// clamped corners and gets zero weights: it reads cells and adds nothing,
// as in the plain version.  The weight of a corner of a 2-D sample is the
// product of its two axis weights, as the plain version's hy * hx.
struct AxisSample {
  int lo, hi;
  float w_lo, w_hi;
};

// Sample `s` (of n_cells * sr along the axis) of an RoI: cell s / sr,
// sub-sample s % sr.  KeepOutside: the window-64 rule's y axis, where a
// sample outside [-1, size] keeps weight 1 on its clamped low cell (ly = 0).
template <bool KeepOutside = false>
__device__ __forceinline__ AxisSample axis_sample(float start, float bin,
                                                  int s, int sr, int size) {
  int i0;
  float frac;
  const bool outside = axis_params(sample_coord(start, bin, s / sr, s % sr, sr),
                                   static_cast<float>(size), &i0, &frac);
  AxisSample a;
  a.lo = i0;
  a.hi = min(i0 + 1, size - 1);
  a.w_lo = outside ? (KeepOutside ? 1.f : 0.f) : 1.f - frac;
  a.w_hi = outside ? 0.f : frac;
  return a;
}

// The cells [lo, hi] of one axis that any sample of the RoI can touch: the
// sample coordinates are monotone in the sample index, so they lie between
// the first and the last one, and the corners of a coordinate are monotone
// in it (ops/roi_align_block.py::block_footprint is the plain version).
__device__ __forceinline__ int2 axis_footprint(float start, float bin,
                                               int n_cells, int sr, int size) {
  const float a = sample_coord(start, bin, 0, 0, sr);
  const float b = sample_coord(start, bin, n_cells - 1, sr - 1, sr);
  int lo, hi;
  float frac;
  axis_params(fminf(a, b), static_cast<float>(size), &lo, &frac);
  axis_params(fmaxf(a, b), static_cast<float>(size), &hi, &frac);
  return make_int2(lo, min(hi + 1, size - 1));
}

// The level rule of the wrappers (ops/roi_align_block.py::block_levels,
// ops/roi_align_fused.py::strip_levels, ops/roi_align.py::map_roi_levels),
// in the float operations torch performs for them on the card: the gather
// rule floor(log2(sqrt(clamp(w*h, 0)) / finest + 1e-6)), where torch
// multiplies by the host-rounded reciprocal of the Python scalar `finest`,
// then (Push) a push to ceil(log2(max(need, 1e-9))) with need = max(w, h)
// times the reciprocal of stride0 * (window - 4) (block rule, a Python
// scalar) or w divided by it (strip rule, a device tensor); clamped to the
// pyramid.  Without the push it is the gather rule of the window-64 route.
struct LevelRule {
  float inv_finest;  // 1 / finest_scale, rounded on the host
  float push;        // block: 1 / (stride0 * (window - 4)); strip: its inverse
  int strip;         // 0: block rule, 1: strip rule
  int num_levels;
};

template <bool Push>
__device__ __forceinline__ int roi_level(const float* roi,
                                         const LevelRule& rule) {
  const float w = __fsub_rn(roi[3], roi[1]);
  const float h = __fsub_rn(roi[4], roi[2]);
  const float top = static_cast<float>(rule.num_levels - 1);
  const float scale = sqrtf(fmaxf(__fmul_rn(w, h), 0.f));
  const float gather = fminf(fmaxf(floorf(log2f(__fadd_rn(
      __fmul_rn(scale, rule.inv_finest), static_cast<float>(1e-6)))), 0.f), top);
  if (!Push) return static_cast<int>(gather);
  const float need = rule.strip ? __fdiv_rn(w, rule.push)
                                : __fmul_rn(fmaxf(w, h), rule.push);
  // clamping the push to [-1, top] first leaves max(gather, push) clamped to
  // [0, top] as it is and keeps the conversion to int defined
  const float pushed = fminf(fmaxf(ceilf(log2f(fmaxf(
      need, static_cast<float>(1e-9)))), -1.f), top);
  return max(static_cast<int>(gather), static_cast<int>(pushed));
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

// The widest channel vector (elements) that `channels` and every pointer's
// alignment allow: 16 bytes where possible, down to two channels.
template <typename T>
inline int vector_width(int channels, const void* const* ptrs, int n) {
  for (int bytes = 16; bytes > 2 * static_cast<int>(sizeof(T)); bytes /= 2) {
    const int v = bytes / static_cast<int>(sizeof(T));
    bool ok = channels % v == 0;
    for (int i = 0; i < n && ok; ++i) {
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % bytes == 0;
    }
    if (ok) return v;
  }
  return 2;
}

}  // namespace roi_align_block
