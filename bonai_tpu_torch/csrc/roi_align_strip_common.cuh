// The strip kernel of the forward-only window-64 strip route
// (roi_align_strip_fwd.cu).  The level table and the sample geometry come
// from roi_align_block_common.cuh, so its corners and weights are the block
// kernels' to the bit.
//
// Block layout: one block per (RoI, tile of kTileChannels channels) with
// kThreads threads.  Thread t owns channel pair t % kPairs of the tile (a
// warp spans the tile's 64 channels: 128 contiguous bytes of a bf16 cell) and
// the output columns pw = t / kPairs, t / kPairs + kGroups, ...  A loop over
// the output rows takes the place of the TPU kernels' sequential RoI grid:
// for each row the block stages the x-window of its 2*sr sample rows (the
// cells its samples read, at most Rule::kWindow of them) in shared memory,
// one strip per sample row, and interpolates the row's bins from there.

#pragma once

#include <climits>
#include <type_traits>

#include "roi_align_block_common.cuh"

namespace roi_align_strip {

using namespace roi_align_block;

constexpr int kTileChannels = 64;
constexpr int kPairs = kTileChannels / 2;    // one warp across a tile
constexpr int kThreads = 128;
constexpr int kGroups = kThreads / kPairs;   // output-column groups
constexpr int kMaxSr = 4;                    // strips: 2 * sr per output row

// Two adjacent channels as stored in the level: float2 or __nv_bfloat162.
template <typename T>
using pair_t = typename std::conditional<std::is_same<T, float>::value,
                                         float2, __nv_bfloat162>::type;

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// The level cells [start, start + width) of every strip of one RoI.
struct XWindow {
  int start;
  int width;
};

// The cells from `start` to the last one that the RoI's in-range x samples
// read (high corner min(x0 + 1, W - 1)), capped at max_width cells.
__device__ __forceinline__ XWindow sample_window(const RoiGrid& g, float Wf,
                                                 int W, int out_w, int sr,
                                                 int start, int max_width) {
  int hi = -1;
  for (int pw = 0; pw < out_w; ++pw) {
    for (int ix = 0; ix < sr; ++ix) {
      int x0;
      float lx;
      if (axis_params(sample_coord(g.x1, g.bin_w, pw, ix, sr), Wf, &x0, &lx)) continue;
      hi = max(hi, min(x0 + 1, W - 1));
    }
  }
  if (hi < 0) return XWindow{0, 0};
  return XWindow{start, min(hi - start + 1, max_width)};
}

// The strip forward; `Rule` gives kWindow, the cells staged per strip, and
// window(), the RoI's staged cells.  A sample outside [-1, H] in y keeps full
// weight on its clamped row (ly = 0), a sample outside [-1, W] in x counts
// zero, and a corner past the staged window counts zero.  Rows with
// valid[r] == 0 are written as zeros.  Sums in float32, output in the levels'
// dtype.
template <typename T, class Rule>
__global__ void __launch_bounds__(kThreads)
strip_fwd_kernel(Levels lv, int batch, int channels,
                 const float* __restrict__ rois, const int* __restrict__ lvl,
                 const uint8_t* __restrict__ valid, int out_h, int out_w,
                 int sr, T* __restrict__ out) {
  using P = pair_t<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  P* strips = reinterpret_cast<P*>(smem);    // [2 * sr][kWindow][kPairs]
  const int r = blockIdx.x;
  const int pair = threadIdx.x % kPairs;
  const int group = threadIdx.x / kPairs;
  const int c = blockIdx.y * kTileChannels + 2 * pair;
  const bool active = c < channels;
  T* dst = out + static_cast<size_t>(r) * out_h * out_w * channels + c;
  if (!valid[r]) {
    if (active) {
      for (int k = group; k < out_h * out_w; k += kGroups) {
        store2(dst + static_cast<size_t>(k) * channels, 0.f, 0.f);
      }
    }
    return;
  }
  const int l = lvl[r];
  const float* roi = rois + 5 * r;
  const int b = min(max(static_cast<int>(roi[0]), 0), batch - 1);
  const int H = lv.height[l];
  const int W = lv.width[l];
  const float Hf = static_cast<float>(H);
  const float Wf = static_cast<float>(W);
  const T* base = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(b) * H * W * channels + c;
  const RoiGrid g = roi_grid(roi, lv.inv_stride[l], out_h, out_w);
  const XWindow win = Rule::window(g, Wf, W, out_w, sr);
  const float count = static_cast<float>(sr * sr);
  const size_t row = static_cast<size_t>(W) * channels;
  constexpr int kStrip = Rule::kWindow * kPairs;

  for (int ph = 0; ph < out_h; ++ph) {
    __syncthreads();    // every thread is done with the previous row's strips
    for (int iy = 0; iy < sr; ++iy) {
      int y0;
      float ly;
      axis_params(sample_coord(g.y1, g.bin_h, ph, iy, sr), Hf, &y0, &ly);
      for (int t = 0; t < 2; ++t) {
        const int y = t == 0 ? y0 : min(y0 + 1, H - 1);
        const T* src = base + y * row + static_cast<size_t>(win.start) * channels;
        P* strip = strips + (2 * iy + t) * kStrip + pair;
        for (int cell = group; active && cell < win.width; cell += kGroups) {
          strip[cell * kPairs] =
              __ldg(reinterpret_cast<const P*>(src + static_cast<size_t>(cell) * channels));
        }
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int pw = group; pw < out_w; pw += kGroups) {
      float a0 = 0.f, a1 = 0.f;
      for (int iy = 0; iy < sr; ++iy) {
        int y0;
        float ly;
        if (axis_params(sample_coord(g.y1, g.bin_h, ph, iy, sr), Hf, &y0, &ly)) {
          ly = 0.f;
        }
        const int y1i = min(y0 + 1, H - 1);
        const P* s0 = strips + 2 * iy * kStrip + pair;
        const P* s1 = s0 + kStrip;
        for (int ix = 0; ix < sr; ++ix) {
          int x0;
          float lx;
          if (axis_params(sample_coord(g.x1, g.bin_w, pw, ix, sr), Wf, &x0, &lx)) continue;
          const int x1i = min(x0 + 1, W - 1);
          const int e0 = x0 - win.start, e1 = x1i - win.start;
          float2 v00, v01, v10, v11;
          if (e1 < win.width) {          // both corners staged
            v00 = to_float2(s0[e0 * kPairs]);
            v01 = to_float2(s0[e1 * kPairs]);
            v10 = to_float2(s1[e0 * kPairs]);
            v11 = to_float2(s1[e1 * kPairs]);
          } else {                       // past the window: zero
            const float2 zero = make_float2(0.f, 0.f);
            v00 = e0 < win.width ? to_float2(s0[e0 * kPairs]) : zero;
            v10 = e0 < win.width ? to_float2(s1[e0 * kPairs]) : zero;
            v01 = v11 = zero;
          }
          const float hy = 1.f - ly, hx = 1.f - lx;
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
          a0 += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          a1 += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        }
      }
      store2(dst + static_cast<size_t>(ph * out_w + pw) * channels, a0 / count, a1 / count);
    }
  }
}

// Shared memory of strip_fwd_kernel<T, Rule> at sampling ratio sr.
template <typename T, class Rule>
constexpr size_t strip_fwd_smem(int sr) {
  return static_cast<size_t>(2 * sr) * Rule::kWindow * kPairs * sizeof(pair_t<T>);
}

// Launches `kernel` on a (num_rois, channel tiles) grid of kThreads-thread
// blocks with `smem` bytes of dynamic shared memory (above the 48 KB default
// after raising the kernel's limit).  Returns the cudaError_t code.
template <typename... KernelArgs, typename... Args>
inline int launch_tiles(void (*kernel)(KernelArgs...), int num_rois,
                        int channels, size_t smem, void* stream,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_rois, (channels + kTileChannels - 1) / kTileChannels);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace roi_align_strip
