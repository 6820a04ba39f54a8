// Multi-level RoIAlign forward with the block level rule, for Hopper (sm_90a).
//
// Replaces the TPU kernel bonai_tpu/ops/pallas_roi_align_block.py::_fwd_kernel
// (launched by _pallas_block_fwd, entry pallas_block_roi_align).  Same
// function, not the same layout: the TPU kernel DMAs a 40x40xC block per RoI
// into VMEM and resolves the bilinear samples with one-hot matmuls; here each
// sample's four corners are read straight from the NHWC level.
//
// What it computes, per RoI r (rois[r] = [batch, x1, y1, x2, y2], image
// coordinates) at the level lvl[r] chosen in torch by block_levels() (the
// gather rule pushed coarser until max(w, h) spans at most 28 cells):
//   aligned=True sample grid of (out_h*sr) x (out_w*sr) points, the RoIAlign
//   border rule on the TRUE level size (points outside [-1, size] count zero,
//   coordinates clamped into the map), fp32 sums, each sr x sr bin averaged,
//   output in the feature dtype; rows with valid[r] == 0 are written as zeros.
// The arithmetic follows ops/roi_align.py (the plain version) step by step.
//
// Bound: bytes.  Per RoI it writes out_h*out_w*C outputs and reads at most
// (out_h*sr+1) x (out_w*sr+1) distinct level cells; it does ~4 multiply-adds
// per corner read, far below the card's operation rate.  At the detector's
// shapes (C=256, bf16) the floor is set by the output writes.
//
// Design: one block per (RoI, channel tile); each thread owns two adjacent
// channels, so a warp reads 32 x 4 B (bf16) or 32 x 8 B (fp32) contiguous
// bytes per corner and writes the same per bin.  The per-sample index math
// is uniform across the block.  Neighbouring samples share corners, which
// the L1/L2 caches serve; no shared memory is used.  The channel count must
// be even and the level and output pointers 8-byte aligned (the wrapper
// checks both).

#include "roi_align_block_common.cuh"

namespace {

using namespace roi_align_block;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_block_fwd_kernel(Levels lv, int batch, int channels,
                           const float* __restrict__ rois,
                           const int* __restrict__ lvl,
                           const uint8_t* __restrict__ valid,
                           int out_h, int out_w, int sr,
                           T* __restrict__ out) {
  const int r = blockIdx.x;
  const int c = 2 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (c >= channels) return;
  T* dst = out + static_cast<size_t>(r) * out_h * out_w * channels + c;
  const int bins = out_h * out_w;
  if (!valid[r]) {
    for (int k = 0; k < bins; ++k) store2(dst + static_cast<size_t>(k) * channels, 0.f, 0.f);
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
  const float count = static_cast<float>(sr * sr);
  const size_t row = static_cast<size_t>(W) * channels;

  for (int ph = 0; ph < out_h; ++ph) {
    for (int pw = 0; pw < out_w; ++pw) {
      float a0 = 0.f, a1 = 0.f;
      for (int iy = 0; iy < sr; ++iy) {
        int y0;
        float ly;
        if (axis_params(sample_coord(g.y1, g.bin_h, ph, iy, sr), Hf, &y0, &ly)) continue;
        const int y1i = min(y0 + 1, H - 1);
        for (int ix = 0; ix < sr; ++ix) {
          int x0;
          float lx;
          if (axis_params(sample_coord(g.x1, g.bin_w, pw, ix, sr), Wf, &x0, &lx)) continue;
          const int x1i = min(x0 + 1, W - 1);
          const float hy = 1.f - ly, hx = 1.f - lx;
          const float2 v00 = load2(base + y0 * row + static_cast<size_t>(x0) * channels);
          const float2 v01 = load2(base + y0 * row + static_cast<size_t>(x1i) * channels);
          const float2 v10 = load2(base + y1i * row + static_cast<size_t>(x0) * channels);
          const float2 v11 = load2(base + y1i * row + static_cast<size_t>(x1i) * channels);
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
          a0 += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          a1 += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        }
      }
      store2(dst + static_cast<size_t>(ph * out_w + pw) * channels, a0 / count, a1 / count);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Host arrays level_ptrs/heights/widths/
// inv_strides hold num_levels entries.  Returns the cudaGetLastError() code
// after the launch (0 on success); launches on `stream`, does not sync.
extern "C" int roi_align_block_fwd(const void* const* level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   const int* lvl, const uint8_t* valid,
                                   int num_rois, int out_h, int out_w,
                                   int sampling_ratio, int dtype, void* out,
                                   void* stream) {
  Levels lv;
  if (!fill_levels(&lv, const_cast<void* const*>(level_ptrs), heights, widths,
                   inv_strides, num_levels, channels, sampling_ratio, batch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  const int pairs = channels / 2;
  const int threads = pairs < kMaxThreads ? pairs : kMaxThreads;
  const dim3 grid(num_rois, (pairs + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_block_fwd_kernel<float><<<grid, threads, 0, s>>>(
        lv, batch, channels, rois, lvl, valid, out_h, out_w, sampling_ratio,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_block_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        lv, batch, channels, rois, lvl, valid, out_h, out_w, sampling_ratio,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
