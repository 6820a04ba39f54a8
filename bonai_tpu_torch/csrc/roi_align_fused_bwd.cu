// Multi-level RoIAlign backward with the strip level rule, for Hopper (sm_90a).
//
// Replaces the TPU kernel bonai_tpu/ops/pallas_roi_align_fused.py::_bwd_kernel
// (launched by _pallas_bwd, the backward='rmw' VJP of
// pallas_multilevel_roi_align).  Same function, not the same layout: the TPU
// kernel walks its RoI grid in order and read-modify-writes each RoI's strips
// of K-chain partial buffers in the feature dtype, with fences between RoIs
// of one chain, an equality-matrix contraction that merges rows repeated
// inside an RoI, and partner matmuls for strips that overlap on levels
// narrower than the window.  Blocks on Hopper run in parallel in no order, so
// none of that carries over: each block sums one output row's strip
// gradients in shared memory, then adds the touched cells to one fp32 buffer
// per level with float2 atomics.  Narrow levels need no partner logic: the
// atomics land on exact cell addresses.
//
// What it computes: the gradient of roi_align_fused_fwd with respect to every
// pyramid level.  For RoI r at its level lvl[r] (the same strip_levels value
// the forward read), each output-gradient element g[r, ph, pw, c] is divided
// by sr*sr and added, times each bilinear weight, to the four corners of each
// of its sr x sr sample points, with the forward's border rule, clamping and
// roi_valid gate (roi_align_block_common.cuh).  The sums go into one float32
// buffer per level, zeroed by the caller, which rounds them to the level's
// dtype once afterwards (the TPU kernel sums in the feature dtype).
//
// Bound: at the detector's training shapes (C=256, bf16) the bytes the
// function must move (the output gradient read once, the level gradients
// written once) bound it far above its multiply-adds.  The kernel moves more:
// a float2 atomic in L2 per touched cell of each distinct strip row of each
// output row, against roi_align_block_bwd.cu's 16 per bin.
//
// Design: one block per (RoI, 64-channel tile), a loop over output rows
// (roi_align_strip_common.cuh).  Per row: zero 2*sr x 48 cells x 64 channels
// of fp32 shared memory (48 KB at sr = 2); spread the row's bins into it with
// shared-memory atomics, where a strip whose level row an earlier strip of the
// row holds adds into that one (the in-RoI merge of repeated rows); then add
// every nonzero staged cell to the level buffer.  A corner past the 48-cell
// window (an RoI still wider than 36 cells at the coarsest level) goes to the
// level buffer directly.  Atomics make the summation order, and so the last
// bits of a float32 sum, vary from run to run.

#include "roi_align_strip_common.cuh"

namespace {

using namespace roi_align_strip;

constexpr int kWindow = 48;

__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fused_bwd_kernel(Levels lv, int batch, int channels,
                           const float* __restrict__ rois,
                           const int* __restrict__ lvl,
                           const uint8_t* __restrict__ valid,
                           int out_h, int out_w, int sr,
                           const T* __restrict__ grad) {
  // acc[strip][cell][k][pair] holds channel 2 * pair + k of the tile: a
  // warp's 32 lanes hit 32 consecutive words
  extern __shared__ __align__(16) float acc[];
  const int r = blockIdx.x;
  const int pair = threadIdx.x % kPairs;
  const int group = threadIdx.x / kPairs;
  const int c = blockIdx.y * kTileChannels + 2 * pair;
  const bool active = c < channels;
  if (!valid[r]) return;
  const int l = lvl[r];
  const float* roi = rois + 5 * r;
  const int b = min(max(static_cast<int>(roi[0]), 0), batch - 1);
  const int H = lv.height[l];
  const int W = lv.width[l];
  const float Hf = static_cast<float>(H);
  const float Wf = static_cast<float>(W);
  float* base = static_cast<float*>(lv.ptr[l]) +
                static_cast<size_t>(b) * H * W * channels + c;
  const T* src = grad + static_cast<size_t>(r) * out_h * out_w * channels + c;
  const RoiGrid g = roi_grid(roi, lv.inv_stride[l], out_h, out_w);
  const XWindow win = sample_window(g, Wf, W, out_w, sr, -1, kWindow);
  if (win.width == 0) return;     // no sample in range in x: no gradient
  const float count = static_cast<float>(sr * sr);
  const size_t row = static_cast<size_t>(W) * channels;
  const int strips = 2 * sr;
  constexpr int kCell = 2 * kPairs;
  constexpr int kStrip = kWindow * kCell;

  for (int ph = 0; ph < out_h; ++ph) {
    // strip s = 2 * iy + t holds level row y0 (t = 0) or y0 + 1 (t = 1) of
    // sample row iy, or none (-1) when the sample is outside in y; into[s] is
    // the first strip that holds the same row
    int rows[2 * kMaxSr], into[2 * kMaxSr];
    for (int s = 0; s < strips; ++s) {
      int y0;
      float ly;
      const bool outside =
          axis_params(sample_coord(g.y1, g.bin_h, ph, s / 2, sr), Hf, &y0, &ly);
      rows[s] = outside ? -1 : (s % 2 == 0 ? y0 : min(y0 + 1, H - 1));
      into[s] = s;
      for (int k = 0; k < s; ++k) {
        if (rows[k] == rows[s]) {
          into[s] = k;
          break;
        }
      }
    }
    __syncthreads();    // the previous row's flush has read acc
    for (int s = 0; s < strips; ++s) {
      if (rows[s] < 0 || into[s] != s) continue;
      for (int cell = group; cell < win.width; cell += kGroups) {
        acc[s * kStrip + cell * kCell + pair] = 0.f;
        acc[s * kStrip + cell * kCell + kPairs + pair] = 0.f;
      }
    }
    __syncthreads();
    for (int pw = group; active && pw < out_w; pw += kGroups) {
      const float2 gv = load2(src + static_cast<size_t>(ph * out_w + pw) * channels);
      // the forward's average: d(out) / d(sample sum) = 1 / count
      const float g0 = __fdiv_rn(gv.x, count);
      const float g1 = __fdiv_rn(gv.y, count);
      if (g0 == 0.f && g1 == 0.f) continue;
      for (int iy = 0; iy < sr; ++iy) {
        if (rows[2 * iy] < 0) continue;
        int y0;
        float ly;
        axis_params(sample_coord(g.y1, g.bin_h, ph, iy, sr), Hf, &y0, &ly);
        const int y1i = min(y0 + 1, H - 1);
        float* s0 = acc + into[2 * iy] * kStrip + pair;
        float* s1 = acc + into[2 * iy + 1] * kStrip + pair;
        for (int ix = 0; ix < sr; ++ix) {
          int x0;
          float lx;
          if (axis_params(sample_coord(g.x1, g.bin_w, pw, ix, sr), Wf, &x0, &lx)) continue;
          const int x1i = min(x0 + 1, W - 1);
          const float hy = 1.f - ly, hx = 1.f - lx;
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
          const int e0 = x0 - win.start, e1 = x1i - win.start;
          if (e1 < win.width) {
            atomicAdd(s0 + e0 * kCell, __fmul_rn(w00, g0));
            atomicAdd(s0 + e0 * kCell + kPairs, __fmul_rn(w00, g1));
            atomicAdd(s0 + e1 * kCell, __fmul_rn(w01, g0));
            atomicAdd(s0 + e1 * kCell + kPairs, __fmul_rn(w01, g1));
            atomicAdd(s1 + e0 * kCell, __fmul_rn(w10, g0));
            atomicAdd(s1 + e0 * kCell + kPairs, __fmul_rn(w10, g1));
            atomicAdd(s1 + e1 * kCell, __fmul_rn(w11, g0));
            atomicAdd(s1 + e1 * kCell + kPairs, __fmul_rn(w11, g1));
          } else {                       // past the window: the level buffer
            float* r0 = base + y0 * row;
            float* r1 = base + y1i * row;
            atomic_add2(r0 + static_cast<size_t>(x0) * channels, __fmul_rn(w00, g0), __fmul_rn(w00, g1));
            atomic_add2(r0 + static_cast<size_t>(x1i) * channels, __fmul_rn(w01, g0), __fmul_rn(w01, g1));
            atomic_add2(r1 + static_cast<size_t>(x0) * channels, __fmul_rn(w10, g0), __fmul_rn(w10, g1));
            atomic_add2(r1 + static_cast<size_t>(x1i) * channels, __fmul_rn(w11, g0), __fmul_rn(w11, g1));
          }
        }
      }
    }
    __syncthreads();
    for (int s = 0; active && s < strips; ++s) {
      if (rows[s] < 0 || into[s] != s) continue;
      float* dst = base + rows[s] * row + static_cast<size_t>(win.start) * channels;
      for (int cell = group; cell < win.width; cell += kGroups) {
        const float v0 = acc[s * kStrip + cell * kCell + pair];
        const float v1 = acc[s * kStrip + cell * kCell + kPairs + pair];
        if (v0 != 0.f || v1 != 0.f) atomic_add2(dst + static_cast<size_t>(cell) * channels, v0, v1);
      }
    }
  }
}

}  // namespace

// dtype (of grad_out): 0 = float32, 1 = bfloat16.  grad_level_ptrs are the
// zeroed float32 (B, H, W, C) gradient buffers, one per level; host arrays
// hold num_levels entries; sampling_ratio is at most kMaxSr.  lvl and valid
// are the forward's.  Returns the cudaGetLastError() code after the launch
// (0 on success); launches on `stream`, does not sync.
extern "C" int roi_align_fused_bwd(void* const* grad_level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   const int* lvl, const uint8_t* valid,
                                   int num_rois, int out_h, int out_w,
                                   int sampling_ratio, int dtype,
                                   const void* grad_out, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, grad_level_ptrs, heights, widths, inv_strides,
                   num_levels, channels, sampling_ratio, batch) ||
      sampling_ratio > kMaxSr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  const size_t smem = static_cast<size_t>(2 * sampling_ratio) * kWindow *
                      kTileChannels * sizeof(float);
  if (dtype == 0) {
    return launch_tiles(roi_align_fused_bwd_kernel<float>, num_rois, channels,
                        smem, stream, lv, batch, channels, rois, lvl, valid,
                        out_h, out_w, sampling_ratio,
                        static_cast<const float*>(grad_out));
  }
  if (dtype == 1) {
    return launch_tiles(roi_align_fused_bwd_kernel<__nv_bfloat16>, num_rois,
                        channels, smem, stream, lv, batch, channels, rois, lvl,
                        valid, out_h, out_w, sampling_ratio,
                        static_cast<const __nv_bfloat16*>(grad_out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
