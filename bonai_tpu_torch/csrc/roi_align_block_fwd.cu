// Multi-level RoIAlign forward for Hopper (sm_90a), under the block, the
// strip or the window-64 rule.
//
// Replaces the TPU kernels bonai_tpu/ops/pallas_roi_align_block.py::_fwd_kernel
// (launched by _pallas_block_fwd, entry pallas_block_roi_align, the
// detector's roi_align_impl='block'), with the strip level rule
// bonai_tpu/ops/pallas_roi_align_fused.py::_fwd_kernel (entry
// pallas_multilevel_roi_align, roi_align_impl='pallas') and, in the
// window-64 mode, bonai_tpu/ops/pallas_roi_align.py::kernel_wrapper (entry
// pallas_roi_align, forward only, the 'pallas' impl of the RoIAlign
// micro-benchmark).  Same functions, not the same layout: the TPU kernels DMA
// a block or strips of each RoI's level into VMEM and resolve the bilinear
// samples with one-hot matmuls; here each sample's corners are read straight
// from the NHWC level.
//
// What it computes, per RoI r (rois[r] = [batch, x1, y1, x2, y2], image
// coordinates), at the level of the wrappers' rule, which it computes
// (LevelRule: the gather rule pushed coarser until max(w, h) spans at most
// window - 4 cells, block, or until w does, strip; the gather rule alone in
// the window-64 mode) and writes to lvl_out unless that is null; an aligned
// (out_h*sr) x (out_w*sr) sample grid, fp32 sums, each sr x sr bin averaged,
// output in the feature dtype; rows with valid[r] == 0 are written as zeros.
// Border rule, block and strip: RoIAlign's on the TRUE level size (points
// outside [-1, size] count zero, coordinates clamped into the map), every
// corner read wherever it lies (the TPU kernels' windows do not cut RoIs
// still too wide at the coarsest level, ROADMAP queue C).  Window-64 mode, as
// the TPU kernel (ops/roi_align.py::window_corner_plan is the plain version):
//   - a sample outside [-1, H] in y keeps weight 1 on its clamped low row
//     (ly = 0), where RoIAlign counts it zero;
//   - a sample outside [-1, W] in x counts zero;
//   - the x window starts at min(min over all x samples of x0, max(W - 64,
//     0)), and an x corner 64 or more cells past that start counts zero (the
//     low corner at x0, the high one at x0 + 1), so an RoI wider than 64
//     cells at its level loses its right-hand samples.
//
// Bound: bytes.  Per RoI it writes out_h*out_w*C outputs and reads at most
// (out_h*sr+1) x (out_w*sr+1) distinct level cells; its multiply-adds are far
// below the card's rate.  What keeps a kernel from it here is instructions
// and latency: per-sample index math repeated for every channel, narrow
// loads, few warps in flight.  The design below computes each RoI's sample
// geometry once, moves 16-byte vectors and keeps a block's warps on
// separate bins.
//
// Design: one block per RoI.  Its sample grid is separable, and a corner's
// weight is the product of its two axis weights (the three rules differ per
// axis only), so a bin's value is the sum, over the distinct rows y and
// columns x that its samples have a corner of nonzero weight on, of Wy(y) *
// Wx(x) * v(y, x), with Wy(y) the sum of the y weights of the bin's sample
// rows on row y (the same for x), divided by sr*sr.  The block first lists,
// per bin of each axis, those cells and summed weights (at most 2*sr; from the
// shared geometry, in sample order) in shared memory, once, then one barrier.
// The window-64 mode's window start is O(1) per RoI: x0 is monotone in the
// sample index, so its least value is that of the first or the last sample
// (axis_footprint).  Each work item is then one (bin, channel vector): a
// vector is 16 bytes where the channel count and the pointers allow (8 bf16 or
// 4 fp32 channels), so a warp covers one bin's 256 bf16 channels with 512
// contiguous bytes, and the block's warps split the bins.  A bin costs one
// vector load per (row, column) pair, 4 to 16 at sr = 2 (9 where its samples'
// corners share rows and columns, 4 for a bin inside one cell) against 16
// corner reads, and the multiply-adds.  Sum order: those cells in order, then
// times 1 / (sr*sr) (the plain version's division, exactly, for sr = 2 and 4);
// the plain version adds the per-corner products hy*hx*v one by one and
// reduces the samples in torch's order.  Both sum in fp32, so they differ by a
// few fp32 ulps of the sum, within 1e-4 (fp32) and one bf16 ulp (bf16).  The
// mode is a template parameter: the block and strip instantiations carry none
// of its code.

#include "roi_align_block_common.cuh"

namespace {

using namespace roi_align_block;

constexpr int kThreads = 256;
constexpr int kWindow64 = 64;   // the window-64 mode's x window, in cells

// Border rules of a bin's list along one axis: RoIAlign's (block and strip
// rules), and the window-64 mode's y and x.
enum Border { kRoiAlign, kWindowY, kWindowX };

// One bin of an RoI along one axis: the distinct cells its sr samples have
// a corner of nonzero weight on (rows as cell offsets y * W), with the sum
// of those corners' axis weights, in sample order.  Returns the count.
// `win`: the window-64 mode's x window start (kWindowX only).
template <Border B>
__device__ __forceinline__ int bin_cells(float start, float bin, int p, int sr,
                                         int size, int scale, int win,
                                         int* cell, float* weight) {
  int n = 0;
  for (int i = 0; i < sr; ++i) {
    AxisSample a = axis_sample<B == kWindowY>(start, bin, p * sr + i, sr, size);
    if constexpr (B == kWindowX) {
      if (a.lo - win >= kWindow64) a.w_lo = 0.f;
      if (a.lo + 1 - win >= kWindow64) a.w_hi = 0.f;
    }
    const int ends[2] = {a.lo * scale, a.hi * scale};
    const float ws[2] = {a.w_lo, a.w_hi};
    for (int e = 0; e < 2; ++e) {
      if (ws[e] == 0.f) continue;
      int k = 0;
      while (k < n && cell[k] != ends[e]) ++k;
      if (k == n) {
        cell[n] = ends[e];
        weight[n++] = ws[e];
      } else {
        weight[k] += ws[e];
      }
    }
  }
  return n;
}

template <typename T, int V, int SR, bool Window64>
__global__ void __launch_bounds__(kThreads)
roi_align_block_fwd_kernel(Levels lv, int batch, int channels,
                           const float* __restrict__ rois,
                           const uint8_t* __restrict__ valid,
                           int* __restrict__ lvl_out, LevelRule rule,
                           int out_h, int out_w, int sr_arg,
                           T* __restrict__ out) {
  // per bin of each axis (out_h y bins, then out_w x bins): its count of
  // cells, then up to 2 * sr cells and their weights
  extern __shared__ int tables[];
  const int sr = SR > 0 ? SR : sr_arg;
  const int m = 2 * sr;
  const int stride = 1 + 2 * m;
  const int r = blockIdx.x;
  const float* roi = rois + 5 * r;
  const int l = roi_level<!Window64>(roi, rule);
  if (lvl_out != nullptr && threadIdx.x == 0) lvl_out[r] = l;

  const int vecs = channels / V;  // channel vectors per bin
  const int bins = out_h * out_w;
  T* dst = out + static_cast<size_t>(r) * bins * channels;
  if (valid != nullptr && !valid[r]) {
    float zero[V] = {};
    for (int it = threadIdx.x; it < bins * vecs; it += kThreads) {
      ChannelVec<T, V>::store(dst + static_cast<size_t>(it) * V, zero);
    }
    return;
  }
  const int b = min(max(static_cast<int>(roi[0]), 0), batch - 1);
  const int H = lv.height[l];
  const int W = lv.width[l];
  const RoiGrid g = roi_grid(roi, lv.inv_stride[l], out_h, out_w);
  const int win = Window64 ? min(axis_footprint(g.x1, g.bin_w, out_w, sr, W).x,
                                 max(W - kWindow64, 0))
                           : 0;
  for (int t = threadIdx.x; t < out_h + out_w; t += kThreads) {
    int* e = tables + t * stride;
    e[0] = t < out_h
               ? bin_cells<Window64 ? kWindowY : kRoiAlign>(
                     g.y1, g.bin_h, t, sr, H, W, 0, e + 1,
                     reinterpret_cast<float*>(e + 1 + m))
               : bin_cells<Window64 ? kWindowX : kRoiAlign>(
                     g.x1, g.bin_w, t - out_h, sr, W, 1, win, e + 1,
                     reinterpret_cast<float*>(e + 1 + m));
  }
  __syncthreads();

  const T* base = static_cast<const T*>(lv.ptr[l]) +
                  static_cast<size_t>(b) * H * W * channels;
  const float scale = 1.f / static_cast<float>(sr * sr);
  constexpr int kM = SR > 0 ? 2 * SR : 1;  // unrolled cells per axis
  for (int it = threadIdx.x; it < bins * vecs; it += kThreads) {
    const int bin = it / vecs;
    const int c = (it - bin * vecs) * V;
    const int ph = bin / out_w;
    const int pw = bin - ph * out_w;
    const int* ey = tables + ph * stride;
    const int* ex = tables + (out_h + pw) * stride;
    const int ny = ey[0], nx = ex[0];
    float acc[V] = {};
    for (int i0 = 0; i0 < ny; i0 += kM) {
      for (int j0 = 0; j0 < nx; j0 += kM) {
#pragma unroll
        for (int di = 0; di < kM; ++di) {
#pragma unroll
          for (int dj = 0; dj < kM; ++dj) {
            const int i = i0 + di, j = j0 + dj;
            if (i < ny && j < nx) {
              float v[V];
              ChannelVec<T, V>::load(base + static_cast<size_t>(ey[1 + i] + ex[1 + j]) * channels + c, v);
              const float w = __int_as_float(ey[1 + m + i]) * __int_as_float(ex[1 + m + j]);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[k] += w * v[k];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] *= scale;
    ChannelVec<T, V>::store(dst + static_cast<size_t>(bin) * channels + c, acc);
  }
}

template <typename T, int V, bool Window64>
int launch(const Levels& lv, int batch, int channels, const float* rois,
           int num_rois, const uint8_t* valid, int* lvl_out,
           const LevelRule& rule, int out_h, int out_w, int sr,
           void* out, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (out_h + out_w) * (1 + 4 * sr);
  auto kernel = sr == 2 ? roi_align_block_fwd_kernel<T, V, 2, Window64>
                        : roi_align_block_fwd_kernel<T, V, 0, Window64>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<num_rois, kThreads, smem, stream>>>(
      lv, batch, channels, rois, valid, lvl_out, rule, out_h, out_w,
      sr, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Host arrays level_ptrs/heights/widths/
// inv_strides hold num_levels entries.  valid (uint8 per RoI) may be null:
// every row is valid.  level_rule: 0 block, 1 strip (the kernel computes the
// rule from finest_scale and push_extent = stride0 * (window - 4) in image
// pixels), 2 the window-64 mode (the gather rule; push_extent unused).  The
// kernel writes each RoI's level (int32) to lvl_out unless that is null.
// Returns the cudaGetLastError() code after the launch (0 on success);
// launches on `stream`, does not sync.
extern "C" int roi_align_block_fwd(const void* const* level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   int num_rois, const uint8_t* valid,
                                   int* lvl_out, int level_rule,
                                   int finest_scale,
                                   float push_extent, int out_h, int out_w,
                                   int sampling_ratio, int dtype, void* out,
                                   void* stream) {
  Levels lv;
  if (!fill_levels(&lv, const_cast<void* const*>(level_ptrs), heights, widths,
                   inv_strides, num_levels, channels, sampling_ratio, batch) ||
      out_h < 1 || out_w < 1 || finest_scale <= 0 || !(push_extent > 0.f) ||
      level_rule < 0 || level_rule > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rois == 0) return 0;
  LevelRule rule;
  // torch computes both reciprocals of host scalars on the host, in float
  rule.inv_finest = 1.0f / static_cast<float>(finest_scale);
  rule.strip = level_rule == 1;
  rule.push = rule.strip ? push_extent : 1.0f / push_extent;
  rule.num_levels = num_levels;
  const bool window64 = level_rule == 2;
  const void* ptrs[kMaxLevels + 1];
  for (int i = 0; i < num_levels; ++i) ptrs[i] = level_ptrs[i];
  ptrs[num_levels] = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sr = sampling_ratio;
#define ROI_ALIGN_LAUNCH(T, V)                                                \
  (window64 ? launch<T, V, true>(lv, batch, channels, rois, num_rois, valid,  \
                                 lvl_out, rule, out_h, out_w, sr, out, s)     \
            : launch<T, V, false>(lv, batch, channels, rois, num_rois, valid, \
                                  lvl_out, rule, out_h, out_w, sr, out, s))
  if (dtype == 0) {
    switch (vector_width<float>(channels, ptrs, num_levels + 1)) {
      case 4: return ROI_ALIGN_LAUNCH(float, 4);
      default: return ROI_ALIGN_LAUNCH(float, 2);
    }
  }
  if (dtype == 1) {
    switch (vector_width<__nv_bfloat16>(channels, ptrs, num_levels + 1)) {
      case 8: return ROI_ALIGN_LAUNCH(__nv_bfloat16, 8);
      case 4: return ROI_ALIGN_LAUNCH(__nv_bfloat16, 4);
      default: return ROI_ALIGN_LAUNCH(__nv_bfloat16, 2);
    }
  }
#undef ROI_ALIGN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
