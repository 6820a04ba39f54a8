// Multi-level RoIAlign backward with the block level rule, for Hopper (sm_90a).
//
// Replaces the TPU kernel bonai_tpu/ops/pallas_roi_align_block.py::_bwd_kernel
// (launched by _pallas_block_bwd, the backward of pallas_block_roi_align).
// Same function, not the same layout: the TPU kernel reads a 40x40 block of
// the output gradient's footprint and scatters it with transposed one-hot
// matmuls into K-chain partial buffers (summed in bfloat16 afterwards); here
// each output-gradient element is spread straight onto its corners with
// float32 atomics.
//
// What it computes: the gradient of roi_align_block_fwd with respect to
// every pyramid level.  For RoI r at its level lvl[r] (the same block_levels
// value the forward read), each output-gradient element g[r, ph, pw, c] is
// divided by sr*sr and added, times each bilinear weight, to the four corners
// of each of its sr x sr sample points, with the forward's border rule,
// clamping and roi_valid gate (roi_align_block_common.cuh holds the shared
// geometry).  The sums go into one float32 buffer per level, zeroed by the
// caller, which casts them to the level's dtype afterwards.
//
// Bound: at the detector's training shapes (C=256, bf16) the bytes the
// function must move (output gradient read once, level gradients written
// once) bound it far above its multiply-adds.  The kernel itself moves more:
// each of the sr^2 * 4 = 16 corner updates of a bin is a float2 atomic in the
// L2 cache, so the atomics' throughput, not device memory, sets its time.
//
// Design: one block per (RoI, channel tile), each thread owning two adjacent
// channels (mirrors the forward), so a warp's atomics cover 32 x 8 B
// contiguous bytes of one corner row.  Atomics make the summation order, and
// so the last bits of a float32 sum, vary from run to run; the result is
// rounded to the level's dtype once, like the plain version's.

#include "roi_align_block_common.cuh"

namespace {

using namespace roi_align_block;

// Adds (a, b) to two adjacent float32 gradient entries (8-byte aligned).
__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_block_bwd_kernel(Levels lv, int batch, int channels,
                           const float* __restrict__ rois,
                           const int* __restrict__ lvl,
                           const uint8_t* __restrict__ valid,
                           int out_h, int out_w, int sr,
                           const T* __restrict__ grad) {
  const int r = blockIdx.x;
  const int c = 2 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (c >= channels || !valid[r]) return;
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
  const float count = static_cast<float>(sr * sr);
  const size_t row = static_cast<size_t>(W) * channels;

  for (int ph = 0; ph < out_h; ++ph) {
    for (int pw = 0; pw < out_w; ++pw) {
      const float2 gv = load2(src + static_cast<size_t>(ph * out_w + pw) * channels);
      // the forward's average: d(out) / d(sample sum) = 1 / count
      const float g0 = __fdiv_rn(gv.x, count);
      const float g1 = __fdiv_rn(gv.y, count);
      if (g0 == 0.f && g1 == 0.f) continue;
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
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
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
}

}  // namespace

// dtype (of grad_out): 0 = float32, 1 = bfloat16.  grad_level_ptrs are the
// zeroed float32 (B, H, W, C) gradient buffers, one per level; host arrays
// hold num_levels entries.  lvl and valid are the forward's.  Returns the
// cudaGetLastError() code after the launch (0 on success); launches on
// `stream`, does not sync.
extern "C" int roi_align_block_bwd(void* const* grad_level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   const int* lvl, const uint8_t* valid,
                                   int num_rois, int out_h, int out_w,
                                   int sampling_ratio, int dtype,
                                   const void* grad_out, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, grad_level_ptrs, heights, widths, inv_strides,
                   num_levels, channels, sampling_ratio, batch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  const int pairs = channels / 2;
  const int threads = pairs < kMaxThreads ? pairs : kMaxThreads;
  const dim3 grid(num_rois, (pairs + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_block_bwd_kernel<float><<<grid, threads, 0, s>>>(
        lv, batch, channels, rois, lvl, valid, out_h, out_w, sampling_ratio,
        static_cast<const float*>(grad_out));
  } else if (dtype == 1) {
    roi_align_block_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        lv, batch, channels, rois, lvl, valid, out_h, out_w, sampling_ratio,
        static_cast<const __nv_bfloat16*>(grad_out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
