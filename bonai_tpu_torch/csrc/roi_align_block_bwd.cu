// Multi-level RoIAlign backward for Hopper (sm_90a), under the block or the
// strip level rule.
//
// Replaces the TPU kernels bonai_tpu/ops/pallas_roi_align_block.py::_bwd_kernel
// (launched by _pallas_block_bwd, the backward of pallas_block_roi_align) and,
// at the strip rule's levels, bonai_tpu/ops/pallas_roi_align_fused.py::
// _bwd_kernel (the 'rmw' backward of pallas_multilevel_roi_align).  Same
// function, not the same layout: the TPU kernels scatter each RoI's output
// gradient with transposed one-hot matmuls into partial buffers, RoI after
// RoI, and sum those afterwards; here each block owns a tile of level cells
// and gathers into it every contribution that lands there.
//
// What it computes: the gradient of roi_align_block_fwd with respect to
// every pyramid level.  For RoI r at its level lvl[r] (the forward's), each
// output-gradient element g[r, ph, pw, c] is divided by sr*sr and added,
// times each bilinear weight, to the four corners of each of its sr x sr
// sample points, with the forward's border rule, clamping and roi_valid gate
// (the geometry of roi_align_block_common.cuh).  Every cell of every level
// gradient is written once, in the output gradient's dtype: cells no RoI
// touches are written as zeros.
//
// Bound: bytes.  The function reads the output gradient once and writes each
// level gradient once; its multiply-adds are far below the card's rate.  A
// scatter into the level gradient needs atomics, an fp32 copy of the pyramid
// zeroed first and a cast after (~1.3 GB of traffic a training step at the
// detector's shapes that the function does not need); the design below
// writes every cell once, from registers, instead.
//
// Design: one block per tile of kRows x tile_w cells of one (image, level)
// and one slice of up to 32 channel vectors (16-byte vectors where the
// channel count and the pointers allow: 8 bf16 or 4 fp32 channels).  Each
// thread owns one column of the tile for one channel vector and sums its
// kRows cells in fp32 registers; a warp's lanes cover one column's 256 bf16
// channels (8 x 8 tiles at C = 256), or up to four columns of a narrower
// slice.  The block scans the RoI headers kThreads at a time and keeps, in
// index order, the valid RoIs of its image and level whose footprint (the
// cells their samples' corners can touch, axis_footprint) meets the tile.
// The bilinear weights are separable, so a bin adds to cell (y, x) its
// gradient times Wy(y) * Wx(x), where Wy(y) sums the y weights of the bin's
// sample rows with a corner on row y (the same for x).  For each RoI, one
// thread per bin and axis computes those sums for the tile's rows and
// columns from the forward's geometry, in sample order; one warp per row
// and column lists its bins of nonzero weight (a ballot); then every thread
// adds to each of its cells the products of its row's list and its
// column's, each reading a bin's gradient as one vector (from L1), 2 x 2
// entries at a time so that four loads are in flight.  A small RoI, whose
// samples all land on a few cells, costs a cell one load per pair of bins
// instead of one per pair of sample corners.  The coarsest level's tiles,
// whose RoIs each cover many tiles and so form the longest chains, are
// scheduled first.  No atomics, no zeroing pass,
// no fp32 copy, no cast.  The order of every sum is fixed (RoIs in index
// order, bins in order), so the result is deterministic; it differs from
// the plain version's (per-corner products hy * hx * g / sr^2, summed by
// index_add) by fp32 rounding only, and the scaling by 1 / (sr*sr) comes
// after the sum (exact for sr = 2 and 4).  RoIs spanning several tiles, RoIs
// wider than 28 cells at the coarsest level and tall strip-level RoIs are
// gathered like any other: a tile reads only its own rows' and columns'
// weights.

#include "roi_align_block_common.cuh"

namespace {

using namespace roi_align_block;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;   // tile rows: a thread owns one column's kRows cells
constexpr int kBatch = 4;  // RoIs whose weights are listed between two barriers

// Tiles of every (image, level), level after level, each level's images in
// order and each image's tiles in row-major order.
struct Tiles {
  int start[kMaxLevels + 1];  // first tile of each level
  int per_image[kMaxLevels];
  int cols[kMaxLevels];       // tiles across a row of the level
};

// The weight of one bin of an RoI on one tile row (or column): the sum of
// the axis weights of the bin's samples with a corner there.  `bin` is the
// bin's offset in the output gradient (ph * out_w for a row, pw for a
// column).
struct Entry {
  int bin;
  float w;
};

template <typename T, int V, int SR>
__global__ void __launch_bounds__(kThreads, 2)
roi_align_block_bwd_kernel(Levels lv, Tiles tiles, int num_levels, int batch,
                           int channels, const float* __restrict__ rois,
                           int num_rois, const uint8_t* __restrict__ valid,
                           const int* __restrict__ lvl, int out_h, int out_w,
                           int sr_arg, int tile_w, int lanes_per_col,
                           const T* __restrict__ grad) {
  const int sr = SR > 0 ? SR : sr_arg;
  const int jobs = kRows + tile_w;  // the tile's rows, then its columns
  const int cap = max(out_h, out_w);  // bins a row or column can hold
  extern __shared__ int smem[];
  int* hits = smem;                                           // [kThreads]
  int* warp_hits = hits + kThreads;                           // [kWarps]
  int* counts = warp_hits + kWarps;                           // [kBatch][jobs]
  float* dense = reinterpret_cast<float*>(counts + kBatch * jobs);  // [kBatch][jobs][cap]
  Entry* lists = reinterpret_cast<Entry*>(dense + kBatch * jobs * cap);  // [kBatch][jobs][cap]

  // the coarsest level's tiles first: their RoIs cover many tiles each, so
  // they carry the longest chains of RoIs
  const int t_id = gridDim.x - 1 - blockIdx.x;
  int l = 0;
  while (l + 1 < num_levels && t_id >= tiles.start[l + 1]) ++l;
  const int in_level = t_id - tiles.start[l];
  const int b = in_level / tiles.per_image[l];
  const int tile = in_level - b * tiles.per_image[l];
  const int ty0 = tile / tiles.cols[l] * kRows;
  const int tx0 = tile % tiles.cols[l] * tile_w;
  const int H = lv.height[l];
  const int W = lv.width[l];
  const float inv = lv.inv_stride[l];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols_per_warp = 32 / lanes_per_col;
  const int sub = lane / lanes_per_col;
  const int tx = warp * cols_per_warp + sub;  // this thread's column
  const int c = (blockIdx.y * lanes_per_col + lane - sub * lanes_per_col) * V;
  const bool active = sub < cols_per_warp && c < channels;
  const int bins = out_h * out_w;
  float acc[kRows][V] = {};

  for (int first = 0; first < num_rois; first += kThreads) {
    // the RoIs of this chunk that touch the tile, in index order
    const int r = first + threadIdx.x;
    bool hit = false;
    if (r < num_rois && (valid == nullptr || valid[r]) &&
        min(max(lvl[r], 0), num_levels - 1) == l) {
      const float* roi = rois + 5 * r;
      if (min(max(static_cast<int>(roi[0]), 0), batch - 1) == b) {
        const RoiGrid g = roi_grid(roi, inv, out_h, out_w);
        const int2 fy = axis_footprint(g.y1, g.bin_h, out_h, sr, H);
        const int2 fx = axis_footprint(g.x1, g.bin_w, out_w, sr, W);
        hit = fy.x < ty0 + kRows && fy.y >= ty0 && fx.x < tx0 + tile_w &&
              fx.y >= tx0;
      }
    }
    const unsigned int mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) hits[before + __popc(mask & ((1u << lane) - 1))] = r;
    __syncthreads();

    for (int h0 = 0; h0 < total; h0 += kBatch) {
      const int nb = min(kBatch, total - h0);
      // 1. per RoI of the batch and bin of each axis (one thread each), the
      //    weights its samples put on each tile row (column), in sample
      //    order: dense[q][job][bin]
      for (int t = threadIdx.x; t < nb * (out_h + out_w); t += kThreads) {
        const int q = t / (out_h + out_w);
        const int u = t - q * (out_h + out_w);
        const RoiGrid g = roi_grid(rois + 5 * hits[h0 + q], inv, out_h, out_w);
        const bool is_y = u < out_h;
        const int p = is_y ? u : u - out_h;
        const int first_job = is_y ? 0 : kRows;
        const int n_cells = is_y ? kRows : tile_w;
        const int origin = is_y ? ty0 : tx0;
        float* d = dense + (q * jobs + first_job) * cap + p;
        for (int k = 0; k < n_cells; ++k) d[k * cap] = 0.f;
        for (int i = 0; i < sr; ++i) {
          const AxisSample a = is_y ? axis_sample(g.y1, g.bin_h, p * sr + i, sr, H)
                                    : axis_sample(g.x1, g.bin_w, p * sr + i, sr, W);
          if (a.lo >= origin && a.lo < origin + n_cells) d[(a.lo - origin) * cap] += a.w_lo;
          if (a.hi >= origin && a.hi < origin + n_cells) d[(a.hi - origin) * cap] += a.w_hi;
        }
      }
      __syncthreads();  // dense weights ready; the last batch's lists are read
      // 2. per RoI, tile row and column (a warp each), its bins of nonzero
      //    weight, in bin order
      for (int job = warp; job < nb * jobs; job += kWarps) {
        const bool is_row = job % jobs < kRows;
        const int n_bins = is_row ? out_h : out_w;
        int count = 0;
        for (int p0 = 0; p0 < n_bins; p0 += 32) {
          const int p = p0 + lane;
          const float w = p < n_bins ? dense[job * cap + p] : 0.f;
          const unsigned int m = __ballot_sync(0xffffffffu, w != 0.f);
          if (w != 0.f) {
            lists[job * cap + count + __popc(m & ((1u << lane) - 1))] =
                Entry{is_row ? p * out_w : p, w};
          }
          count += __popc(m);
        }
        if (lane == 0) counts[job] = count;
      }
      __syncthreads();  // lists ready
      if (!active) continue;
      // 3. cell (ty0 + k, tx0 + tx) gets, RoI after RoI, the products of
      //    row k's list and this column's, 2 x 2 entries at a time: four
      //    independent gradient loads (past a list's end, a valid vector
      //    with weight zero)
      for (int q = 0; q < nb; ++q) {
        const T* src = grad + static_cast<size_t>(hits[h0 + q]) * bins * channels + c;
        const Entry* col = lists + (q * jobs + kRows + tx) * cap;
        const int nc = counts[q * jobs + kRows + tx];
        if (nc == 0) continue;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int nr = counts[q * jobs + k];
          const Entry* row = lists + (q * jobs + k) * cap;
          for (int i0 = 0; i0 < nr; i0 += 2) {
            for (int j0 = 0; j0 < nc; j0 += 2) {
              float gv[4][V];
              float w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = i0 + (e >> 1), j = j0 + (e & 1);
                const bool ok = i < nr && j < nc;
                const Entry er = row[ok ? i : 0], ec = col[ok ? j : 0];
                w[e] = ok ? er.w * ec.w : 0.f;
                ChannelVec<T, V>::load(src + static_cast<size_t>(ok ? er.bin + ec.bin : 0) * channels, gv[e]);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int v = 0; v < V; ++v) acc[k][v] += w[e] * gv[e][v];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites hits and warp_hits
  }

  const int x = tx0 + tx;
  if (!active || x >= W) return;
  const float scale = 1.f / static_cast<float>(sr * sr);
  T* dst = static_cast<T*>(lv.ptr[l]) + static_cast<size_t>(b) * H * W * channels + c;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = ty0 + k;
    if (y >= H) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] *= scale;
    ChannelVec<T, V>::store(dst + (static_cast<size_t>(y) * W + x) * channels, acc[k]);
  }
}

template <typename T, int V>
int launch(const Levels& lv, int num_levels, int batch, int channels,
           const float* rois, int num_rois, const uint8_t* valid,
           const int* lvl, int out_h, int out_w, int sr, const void* grad,
           cudaStream_t stream) {
  // a slice of 8 to 32 channel vectors; a warp covers 32 / lanes columns
  const int vecs = channels / V;
  const int lanes = vecs < 8 ? 8 : vecs < 32 ? vecs : 32;
  const int tile_w = kWarps * (32 / lanes);
  Tiles tiles;
  tiles.start[0] = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    tiles.cols[i] = (lv.width[i] + tile_w - 1) / tile_w;
    tiles.per_image[i] = (lv.height[i] + kRows - 1) / kRows * tiles.cols[i];
    tiles.start[i + 1] = tiles.start[i] + (i < num_levels ? batch * tiles.per_image[i] : 0);
  }
  const size_t jobs = kRows + tile_w;
  const size_t cap = out_h > out_w ? out_h : out_w;
  const size_t smem = sizeof(int) * (kThreads + kWarps + kBatch * jobs) +
                      (sizeof(float) + sizeof(Entry)) * kBatch * jobs * cap;
  auto kernel = sr == 2 ? roi_align_block_bwd_kernel<T, V, 2>
                        : roi_align_block_bwd_kernel<T, V, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(tiles.start[num_levels], (vecs + lanes - 1) / lanes);
  kernel<<<grid, kThreads, smem, stream>>>(
      lv, tiles, num_levels, batch, channels, rois, num_rois, valid, lvl,
      out_h, out_w, sr, tile_w, lanes, static_cast<const T*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of grad_out and of the level gradients): 0 = float32, 1 = bfloat16.
// grad_level_ptrs are the (B, H, W, C) level gradients, one per level, which
// the kernel writes whole; host arrays hold num_levels entries.  lvl (int32)
// and valid (uint8, may be null: every row valid) are the forward's.
// Returns the cudaGetLastError() code after the launch (0 on success);
// launches on `stream`, does not sync.
extern "C" int roi_align_block_bwd(void* const* grad_level_ptrs,
                                   const int* heights, const int* widths,
                                   const float* inv_strides, int num_levels,
                                   int batch, int channels, const float* rois,
                                   int num_rois, const uint8_t* valid,
                                   const int* lvl, int out_h, int out_w,
                                   int sampling_ratio, int dtype,
                                   const void* grad_out, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, grad_level_ptrs, heights, widths, inv_strides,
                   num_levels, channels, sampling_ratio, batch) ||
      out_h < 1 || out_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[kMaxLevels + 1];
  for (int i = 0; i < num_levels; ++i) ptrs[i] = grad_level_ptrs[i];
  ptrs[num_levels] = grad_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sr = sampling_ratio;
#define ROI_ALIGN_LAUNCH(T, V)                                                \
  launch<T, V>(lv, num_levels, batch, channels, rois, num_rois, valid, lvl,   \
               out_h, out_w, sr, grad_out, s)
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
