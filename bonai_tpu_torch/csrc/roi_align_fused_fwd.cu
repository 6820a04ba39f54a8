// Multi-level RoIAlign forward with the strip level rule, for Hopper (sm_90a).
//
// Replaces the TPU kernel bonai_tpu/ops/pallas_roi_align_fused.py::_fwd_kernel
// (launched by _pallas_fwd, entry pallas_multilevel_roi_align, the detector's
// roi_align_impl='pallas').  Same function, not the same layout: the TPU kernel
// DMAs each RoI's 2*oh*sr sample rows as 48-cell strips into VMEM (double
// buffered across its sequential RoI grid) and resolves x with one-hot
// matmuls; here a block stages one output row's 2*sr strips at a time in
// shared memory and interpolates its bins from there.
//
// What it computes, per RoI r at the level lvl[r] chosen in torch by
// strip_levels() (the gather rule pushed coarser until the x-extent spans at
// most 36 cells): the RoIAlign of roi_align_block_fwd.cu, i.e. an aligned
// (out_h*sr) x (out_w*sr) sample grid with the RoIAlign border rule on the
// true level size, fp32 sums, each sr x sr bin averaged, output in the
// feature dtype, rows with valid[r] == 0 written as zeros.  Corners and
// weights are B1's (roi_align_block_common.cuh).  The TPU kernel zeroes the
// corners past its 48-cell strip, which only an RoI still wider than 36
// cells at the coarsest level has; this kernel reads those corners from
// device memory instead, as the plain version does.
//
// Bound: bytes.  Per RoI it writes out_h*out_w*C outputs and reads at most
// (out_h*sr + 1) x (out_w*sr + 1) distinct level cells; its ~4 multiply-adds
// per corner are far below the card's operation rate.
//
// Design: one block per (RoI, 64-channel tile), a loop over output rows;
// strips staged in shared memory in the feature dtype (2*sr x 48 cells x 64
// channels: 24 KB bf16, 48 KB fp32 at sr = 2), read by the bins from there
// (roi_align_strip_common.cuh).  Where B1 loads the four corners of every
// sample from the level (the L1/L2 caches serve the repeats), this kernel
// loads each cell of a strip once per output row.  The channel count must be
// even and the level and output pointers 8-byte aligned (the wrapper checks
// both).

#include "roi_align_strip_common.cuh"

namespace {

using namespace roi_align_strip;

struct FusedRule {
  static constexpr int kWindow = 48;
  static constexpr bool kZeroOutsideY = true;
  static constexpr bool kCutWindow = false;
  static __device__ __forceinline__ XWindow window(const RoiGrid& g, float Wf,
                                                   int W, int out_w, int sr) {
    return sample_window(g, Wf, W, out_w, sr, -1, kWindow);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Host arrays level_ptrs/heights/widths/
// inv_strides hold num_levels entries; sampling_ratio is at most kMaxSr.
// Returns the cudaGetLastError() code after the launch (0 on success);
// launches on `stream`, does not sync.
extern "C" int roi_align_fused_fwd(const void* const* level_ptrs,
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
    return launch_tiles(strip_fwd_kernel<float, FusedRule>, num_rois, channels,
                        strip_fwd_smem<float, FusedRule>(sampling_ratio), stream,
                        lv, batch, channels, rois, lvl, valid, out_h, out_w,
                        sampling_ratio, static_cast<float*>(out));
  }
  if (dtype == 1) {
    return launch_tiles(strip_fwd_kernel<__nv_bfloat16, FusedRule>, num_rois,
                        channels,
                        strip_fwd_smem<__nv_bfloat16, FusedRule>(sampling_ratio),
                        stream, lv, batch, channels, rois, lvl, valid, out_h,
                        out_w, sampling_ratio, static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
