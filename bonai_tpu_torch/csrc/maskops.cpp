// Host-side mask ops of bonai_tpu_torch: COCO RLE encode and decode, the
// bilinear mask paste, the scanline polygon fill and the RLE IoU, with a
// plain C interface bound through ctypes (bonai_tpu_torch/native.py), built
// with the host's g++ at first use.  A copy of bonai_tpu/native/maskops.cpp
// (which the port does not import), with entry points added:
// rle_iou_matrix, rle_iou over every pair of two lists of RLEs, and the
// float32 correlation loops of bonai_tpu_torch/utils/filters.py
// (OpenCV 5.0's orders of fused multiply-adds; std::fma is the fused
// operation, every other product and sum is rounded on its own, as the
// ISO C++ mode of g++ compiles it without contraction).
//
// All masks are uint8 row-major (h, w) unless stated; RLE uses COCO
// column-major runs starting with a zero-run.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RLE encode: mask (h*w, row-major) -> counts (int32).  Returns number of
// counts written (caller provides buffer of size h*w+2).
// ---------------------------------------------------------------------------
int rle_encode(const uint8_t* mask, int h, int w, int32_t* counts) {
    int n = 0;
    int64_t run = 0;
    uint8_t cur = 0;
    for (int x = 0; x < w; ++x) {
        const uint8_t* col = mask + x;
        for (int y = 0; y < h; ++y) {
            uint8_t v = col[(int64_t)y * w] ? 1 : 0;
            if (v == cur) {
                ++run;
            } else {
                counts[n++] = (int32_t)run;
                run = 1;
                cur = v;
            }
        }
    }
    counts[n++] = (int32_t)run;
    return n;
}

// ---------------------------------------------------------------------------
// RLE decode: counts -> mask (h*w row-major)
// ---------------------------------------------------------------------------
void rle_decode(const int32_t* counts, int n, int h, int w, uint8_t* mask) {
    std::memset(mask, 0, (size_t)h * w);
    int64_t pos = 0;
    uint8_t val = 0;
    for (int i = 0; i < n; ++i) {
        int64_t c = counts[i];
        if (val) {
            for (int64_t k = pos; k < pos + c; ++k) {
                int64_t y = k % h, x = k / h;
                mask[y * w + x] = 1;
            }
        }
        pos += c;
        val ^= 1;
    }
}

// ---------------------------------------------------------------------------
// Bilinear paste: prob (s x s float32) resized into out (h x w uint8) box
// region [x1,y1,x2,y2), thresholded.  Matches cv2.INTER_LINEAR semantics
// with half-pixel centers.
// ---------------------------------------------------------------------------
void paste_mask(const float* prob, int s, float x1f, float y1f, float x2f,
                float y2f, float thr, uint8_t* out, int h, int w) {
    int x1 = (int)std::floor(x1f), y1 = (int)std::floor(y1f);
    int x2 = (int)std::ceil(x2f), y2 = (int)std::ceil(y2f);
    int bw = std::max(x2 - x1, 1), bh = std::max(y2 - y1, 1);
    float sx = (float)s / bw, sy = (float)s / bh;
    int ys = std::max(y1, 0), ye = std::min(y2, h);
    int xs = std::max(x1, 0), xe = std::min(x2, w);
    for (int y = ys; y < ye; ++y) {
        float fy = ((y - y1) + 0.5f) * sy - 0.5f;
        int y0 = (int)std::floor(fy);
        float ly = fy - y0;
        int y0c = std::min(std::max(y0, 0), s - 1);
        int y1c = std::min(std::max(y0 + 1, 0), s - 1);
        for (int x = xs; x < xe; ++x) {
            float fx = ((x - x1) + 0.5f) * sx - 0.5f;
            int x0 = (int)std::floor(fx);
            float lx = fx - x0;
            int x0c = std::min(std::max(x0, 0), s - 1);
            int x1c = std::min(std::max(x0 + 1, 0), s - 1);
            float v = prob[y0c * s + x0c] * (1 - ly) * (1 - lx)
                    + prob[y0c * s + x1c] * (1 - ly) * lx
                    + prob[y1c * s + x0c] * ly * (1 - lx)
                    + prob[y1c * s + x1c] * ly * lx;
            if (v > thr) out[(int64_t)y * w + x] = 1;
        }
    }
}

// ---------------------------------------------------------------------------
// Scanline polygon fill into (h x w) mask; polygon (n x 2 float32, xy).
// Even-odd rule with half-pixel sample centers.
// ---------------------------------------------------------------------------
void fill_poly(const float* poly, int n, uint8_t* mask, int h, int w) {
    if (n < 3) return;
    std::vector<float> xs;
    for (int y = 0; y < h; ++y) {
        float py = y + 0.5f;
        xs.clear();
        for (int i = 0; i < n; ++i) {
            float ax = poly[2 * i], ay = poly[2 * i + 1];
            float bx = poly[2 * ((i + 1) % n)], by = poly[2 * ((i + 1) % n) + 1];
            if ((ay <= py && by > py) || (by <= py && ay > py)) {
                float t = (py - ay) / (by - ay);
                xs.push_back(ax + t * (bx - ax));
            }
        }
        std::sort(xs.begin(), xs.end());
        for (size_t i = 0; i + 1 < xs.size(); i += 2) {
            int x0 = std::max((int)std::ceil(xs[i] - 0.5f), 0);
            int x1 = std::min((int)std::floor(xs[i + 1] - 0.5f), w - 1);
            for (int x = x0; x <= x1; ++x) mask[(int64_t)y * w + x] = 1;
        }
    }
}

// ---------------------------------------------------------------------------
// IoU of two RLEs without decoding to dense (run-merge).
// ---------------------------------------------------------------------------
double rle_iou(const int32_t* a, int na, const int32_t* b, int nb) {
    int64_t ia = 0, ib = 0, pa = 0, pb = 0;
    int64_t inter = 0, area_a = 0, area_b = 0;
    uint8_t va = 0, vb = 0;
    int64_t ca = na > 0 ? a[0] : 0, cb = nb > 0 ? b[0] : 0;
    while (ia < na && ib < nb) {
        int64_t step = std::min(ca, cb);
        if (va && vb) inter += step;
        if (va) area_a += step;
        if (vb) area_b += step;
        ca -= step; cb -= step;
        if (ca == 0) { ++ia; if (ia < na) { ca = a[ia]; va ^= 1; } }
        if (cb == 0) { ++ib; if (ib < nb) { cb = b[ib]; vb ^= 1; } }
    }
    // tail runs
    while (ia < na) { if (va) area_a += ca; ++ia; if (ia < na) { ca = a[ia]; va ^= 1; } }
    while (ib < nb) { if (vb) area_b += cb; ++ib; if (ib < nb) { cb = b[ib]; vb ^= 1; } }
    int64_t uni = area_a + area_b - inter;
    return uni > 0 ? (double)inter / (double)uni : 0.0;
}

// ---------------------------------------------------------------------------
// rle_iou of every pair: RLE i of a is counts_a[off_a[i] .. off_a[i + 1]),
// and likewise for b; out is (na x nb) row-major.
// ---------------------------------------------------------------------------
void rle_iou_matrix(const int32_t* counts_a, const int64_t* off_a, int na,
                    const int32_t* counts_b, const int64_t* off_b, int nb,
                    double* out) {
    for (int i = 0; i < na; ++i)
        for (int j = 0; j < nb; ++j)
            out[(int64_t)i * nb + j] = rle_iou(
                counts_a + off_a[i], (int)(off_a[i + 1] - off_a[i]),
                counts_b + off_b[j], (int)(off_b[j + 1] - off_b[j]));
}

// ---------------------------------------------------------------------------
// Correlation loops over float32 rows.  filter_rows_seq: out[r][x] =
// fma(src[r][x + (n-1)cn], k[n-1], ... fma(src[r][x + cn], k[1],
// src[r][x] * k[0])), the taps left to right; src rows of in_len, out
// rows of out_len.  filter_cols_sym: src of rows + n - 1 rows of len,
// out[y][x] = the centre tap times k[r], then fma of each symmetric pair
// sum (src[y + r - j] + src[y + r + j]) with k[r + j], j = 1..r.
// filter_2d_fma: out[y][x] = fma chain from 0 over the nz taps (dy, dx,
// f), src[y + dy][x + dx * cn] each; src rows of in_len.
// ---------------------------------------------------------------------------
void filter_rows_seq(const float* src, int rows, int in_len, float* out,
                     int out_len, int cn, const float* k, int n) {
    for (int r = 0; r < rows; ++r) {
        const float* s = src + (int64_t)r * in_len;
        float* o = out + (int64_t)r * out_len;
        for (int x = 0; x < out_len; ++x) o[x] = s[x] * k[0];
        for (int j = 1; j < n; ++j) {
            const float* t = s + j * cn;
            const float f = k[j];
            for (int x = 0; x < out_len; ++x) o[x] = std::fma(t[x], f, o[x]);
        }
    }
}

void filter_cols_sym(const float* src, int rows, int len, float* out,
                     const float* k, int n) {
    const int r = n / 2;
    for (int y = 0; y < rows; ++y) {
        float* o = out + (int64_t)y * len;
        const float* c = src + (int64_t)(y + r) * len;
        for (int x = 0; x < len; ++x) o[x] = c[x] * k[r];
        for (int j = 1; j <= r; ++j) {
            const float* a = src + (int64_t)(y + r - j) * len;
            const float* b = src + (int64_t)(y + r + j) * len;
            const float f = k[r + j];
            for (int x = 0; x < len; ++x) {
                const float pair = a[x] + b[x];
                o[x] = std::fma(pair, f, o[x]);
            }
        }
    }
}

void filter_2d_fma(const float* src, int rows, int in_len, int out_len,
                   float* out, int cn, const int* dy, const int* dx,
                   const float* f, int nz) {
    for (int y = 0; y < rows; ++y) {
        float* o = out + (int64_t)y * out_len;
        for (int x = 0; x < out_len; ++x) o[x] = 0.0f;
        for (int i = 0; i < nz; ++i) {
            const float* t = src + (int64_t)(y + dy[i]) * in_len + dx[i] * cn;
            const float g = f[i];
            for (int x = 0; x < out_len; ++x) o[x] = std::fma(t[x], g, o[x]);
        }
    }
}

}  // extern "C"
