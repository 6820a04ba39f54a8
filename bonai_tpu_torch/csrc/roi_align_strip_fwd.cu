// Multi-level RoIAlign forward of the window-64 strip route, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bonai_tpu/ops/pallas_roi_align.py::kernel_wrapper
// (the pallas_call of pallas_roi_align, the 'pallas' impl of
// tools/bench_roi_align.py).  Same function, not the same layout: the TPU
// kernel DMAs each RoI's 2*oh*sr sample rows as 64-cell strips into VMEM, one
// after the other, and resolves x with a one-hot matmul; here a block stages
// one output row's 2*sr strips at a time in shared memory.
//
// What it computes, per RoI r at the level lvl[r] of the gather rule
// (floor(log2(sqrt(wh)/56)), no push), with an aligned (out_h*sr) x
// (out_w*sr) sample grid, fp32 sums, each sr x sr bin averaged, output in the
// feature dtype, rows with valid[r] == 0 written as zeros; and, as the TPU
// kernel does:
//   - a sample outside [-1, W] in x counts zero;
//   - a sample outside [-1, H] in y keeps full weight on its clamped row
//     (ly = 0), where RoIAlign would count it zero;
//   - the window starts at min(min over all x samples of x0, max(W - 64, 0))
//     and each x corner 64 or more cells past that start counts zero, so an
//     RoI wider than 64 cells at its level (a wide, flat one kept at level 0
//     by sqrt(wh) < 56) loses its right-hand samples.
// The sample geometry is B1's (roi_align_block_common.cuh).
//
// Bound: bytes, as roi_align_fused_fwd.cu: the output written once and at
// most (out_h*sr + 1) x (out_w*sr + 1) level cells per RoI read once.
//
// Design: roi_align_fused_fwd.cu's kernel (roi_align_strip_common.cuh) with
// 64-cell strips: 2*sr x 64 cells x 64 channels of shared memory, 32 KB bf16
// and 64 KB fp32 at sr = 2.  The channel count must be even and the level and
// output pointers 8-byte aligned (the wrapper checks both).

#include "roi_align_strip_common.cuh"

namespace {

using namespace roi_align_strip;

struct StripRule {
  static constexpr int kWindow = 64;
  static constexpr bool kZeroOutsideY = false;
  static constexpr bool kCutWindow = true;
  static __device__ __forceinline__ XWindow window(const RoiGrid& g, float Wf,
                                                   int W, int out_w, int sr) {
    int first = INT_MAX;             // over every sample, in range or not
    for (int pw = 0; pw < out_w; ++pw) {
      for (int ix = 0; ix < sr; ++ix) {
        int x0;
        float lx;
        axis_params(sample_coord(g.x1, g.bin_w, pw, ix, sr), Wf, &x0, &lx);
        first = min(first, x0);
      }
    }
    first = min(first, max(W - kWindow, 0));
    return sample_window(g, Wf, W, out_w, sr, first, kWindow);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Host arrays level_ptrs/heights/widths/
// inv_strides hold num_levels entries; sampling_ratio is at most kMaxSr.
// Returns the cudaGetLastError() code after the launch (0 on success);
// launches on `stream`, does not sync.
extern "C" int roi_align_strip_fwd(const void* const* level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   const int* lvl, const uint8_t* valid,
                                   int num_rois, int out_h, int out_w,
                                   int sampling_ratio, int dtype, void* out,
                                   void* stream) {
  Levels lv;
  if (!fill_levels(&lv, const_cast<void* const*>(level_ptrs), heights, widths,
                   inv_strides, num_levels, channels, sampling_ratio, batch) ||
      sampling_ratio > kMaxSr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  if (dtype == 0) {
    return launch_tiles(strip_fwd_kernel<float, StripRule>, num_rois, channels,
                        strip_fwd_smem<float, StripRule>(sampling_ratio), stream,
                        lv, batch, channels, rois, lvl, valid, out_h, out_w,
                        sampling_ratio, static_cast<float*>(out));
  }
  if (dtype == 1) {
    return launch_tiles(strip_fwd_kernel<__nv_bfloat16, StripRule>, num_rois,
                        channels,
                        strip_fwd_smem<__nv_bfloat16, StripRule>(sampling_ratio),
                        stream, lv, batch, channels, rois, lvl, valid, out_h,
                        out_w, sampling_ratio, static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
