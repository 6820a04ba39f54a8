"""The float32 image filters of the corruptions, in numpy, as OpenCV 5.0
computes them on an x86 host (counterparts of the cv2 calls of
``bonai_tpu/datasets/pipelines/corrupt.py``).

- :func:`gaussian_kernel` is ``cv2.getGaussianKernel(n, sigma, CV_32F)``
  and :func:`gaussian_blur` ``cv2.GaussianBlur`` (``BORDER_REFLECT_101``,
  ``ksize=(0, 0)`` taking ``cvRound(8 * sigma + 1) | 1`` as OpenCV does
  for float32): the row pass, then the column pass, each in OpenCV's
  order of fused multiply-adds (a 3- or 5-tap row pairs the symmetric
  taps around the centre; a longer row sums its taps left to right; the
  column pass starts from the centre and adds the symmetric pairs).
  Exact wherever a row's ``width * channels`` is a multiple of 16 (OpenCV
  computes the rest of a row in scalar code, which can round one ulp
  otherwise).
- :func:`filter2d` is ``cv2.filter2D(x, -1, kernel)`` with the centre
  anchor and ``BORDER_REFLECT_101``: below 130 kernel cells the nonzero
  taps in row-major order, fused; from 130 on (13 x 13) OpenCV correlates
  through a DFT, which this function replaces by the float64 correlation
  (``scipy.ndimage.correlate``) rounded once (equal to OpenCV's in all but
  a few in 10^4 elements).

The long chains of fused multiply-adds (a row pass of more than 5 taps,
every column pass, the direct ``filter2d``) run in the host's mask
library (``native.py``, ``std::fma``): a 1024^2 elastic transform's two
329-tap blurs take seconds there.
- :func:`resize_cubic` and :func:`resize_linear` are ``cv2.resize`` with
  ``INTER_CUBIC`` (a = -0.75) and ``INTER_LINEAR`` on float32, border
  replicated, in float64 rounded once: OpenCV 5.0 hands these to Intel
  IPP, whose arithmetic is not reproduced, so single elements differ by
  a few ulps.  ``INTER_NEAREST`` is ``datasets/pipelines/transforms.py::
  resize_nearest``, exact.
- :func:`remap_nearest` and :func:`remap_linear` are ``cv2.remap`` with
  float32 maps: nearest rounds the map half to even (zero border);
  linear blends the four neighbours at the map's own float fractions
  (OpenCV 5.0 does not quantise them to 1/32) with ``fma(a, p01 - p00,
  p00)`` along rows and ``fma(b, v1 - v0, v0)`` between them, borders
  ``BORDER_REFLECT`` (not ``_101``); exact.
"""

from __future__ import annotations

import math

import numpy as np

from .warp import fma32

_DFT_CELLS = 130          # kernel cells from which cv2.filter2D uses a DFT


def gaussian_kernel(n, sigma):
    """``cv2.getGaussianKernel(n, sigma, ktype=CV_32F)``."""
    if sigma <= 0 and n in (1, 3, 5, 7):
        return np.array({1: [1.0], 3: [0.25, 0.5, 0.25],
                         5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                         7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                             0.109375, 0.03125]}[n], np.float32)
    sx = sigma if sigma > 0 else n * 0.15 + 0.35
    scale = -0.125 / (sx * sx)
    vals = [math.exp(float(x * x) * scale)
            for x in range(1 - n, 1 - n + 2 * ((n - 1) // 2), 2)]
    mul = 1.0 / (sum(vals) * 2 + 1 + (0 if n & 1 else 1))
    half = [v * mul for v in vals]
    mid = [mul] * (2 - (n & 1))
    return np.array(half + mid + half[::-1], np.float32)


def _reflect101(n, lo, hi):
    """Source indices ``-lo .. n + hi - 1`` under ``BORDER_REFLECT_101``
    (repeated as often as a kernel wider than the image needs)."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _taps(x, n, axis):
    """The ``n`` shifted views of ``x`` along ``axis`` of a centred
    ``n``-tap kernel under ``BORDER_REFLECT_101``."""
    r = n // 2
    size = x.shape[axis]
    idx = _reflect101(size, r, n - 1 - r)
    return [np.take(x, idx[j:j + size], axis=axis) for j in range(n)]


def _fma(a, k, c):
    return fma32(a, np.broadcast_to(np.float32(k), a.shape), c)


def _row_pass(x, k):
    """``(H, W, C)`` -> ``(H, W, C)``: OpenCV's row filter."""
    n, h, w, cn = len(k), *x.shape
    if n not in (1, 3, 5):
        from ..native import filter_rows_seq
        r = n // 2
        padded = x[:, _reflect101(w, r, n - 1 - r)].reshape(h, -1)
        return filter_rows_seq(padded, w, cn, k).reshape(h, w, cn)
    t = _taps(x, n, 1)
    if n == 1:
        return t[0] * k[0]
    if n == 3:
        return _fma(t[1], k[1], (t[0] + t[2]) * k[2])
    s = _fma(t[2], k[2], (t[1] + t[3]) * k[3])
    return _fma(t[0] + t[4], k[4], s)


def _column_pass(x, k):
    """``(H, W, C)`` -> ``(H, W, C)``: OpenCV's symmetric column filter."""
    from ..native import filter_cols_sym
    n, r, h = len(k), len(k) // 2, x.shape[0]
    padded = x[_reflect101(h, r, n - 1 - r)].reshape(h + n - 1, -1)
    return filter_cols_sym(padded, k).reshape(x.shape)


def _as_hwc(x):
    x = np.asarray(x, np.float32)
    return x if x.ndim == 3 else x[..., None]


def gaussian_blur(x, ksize, sigma):
    """``cv2.GaussianBlur(x, ksize, sigma)`` of a float32 ``(H, W)`` or
    ``(H, W, C)`` image (square kernels, one sigma)."""
    n = int(ksize[0])
    if n <= 0:
        n = int(np.rint(sigma * 8 + 1)) | 1
    k = gaussian_kernel(n, sigma)
    out = _column_pass(_row_pass(_as_hwc(x), k), k)
    return out.reshape(np.shape(x))


def filter2d(x, kernel):
    """``cv2.filter2D(x, -1, kernel)`` of a float32 ``(H, W)`` or
    ``(H, W, C)`` image."""
    img = _as_hwc(x)
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    h, w, cn = img.shape
    ay, ax = kh // 2, kw // 2
    rows = _reflect101(h, ay, kh - 1 - ay)
    cols = _reflect101(w, ax, kw - 1 - ax)
    if kh * kw >= _DFT_CELLS:
        from scipy.ndimage import correlate
        out = correlate(img.astype(np.float64),
                        kernel.astype(np.float64)[..., None], mode="mirror")
        return out.astype(np.float32).reshape(np.shape(x))
    from ..native import filter_2d_fma
    dy, dx = np.nonzero(kernel)
    padded = img[rows][:, cols].reshape(h + kh - 1, -1)
    out = filter_2d_fma(padded, h, w, cn, dy, dx, kernel[dy, dx])
    return out.reshape(np.shape(x))


def _cubic_axis(n_in, n_out):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i = np.floor(f)
    t = f - i
    a = -0.75
    w = np.stack([((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
                  ((a + 2) * t - (a + 3)) * t * t + 1,
                  ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1], -1)
    w = np.concatenate([w, 1 - w.sum(-1, keepdims=True)], -1)
    idx = np.clip(i.astype(np.int64)[:, None] + np.arange(-1, 3)[None],
                  0, n_in - 1)
    return idx, w


def resize_cubic(x, w, h):
    """``cv2.resize(x, (w, h), interpolation=INTER_CUBIC)`` of a float32
    image, in float64 rounded once."""
    x = np.asarray(x, np.float64)
    yi, yw = _cubic_axis(x.shape[0], h)
    xi, xw = _cubic_axis(x.shape[1], w)
    extra = (None,) * (x.ndim - 2)
    r = sum(x[:, xi[:, k]] * xw[(slice(None), k) + extra] for k in range(4))
    out = sum(r[yi[:, k]] * yw[(slice(None), k, None) + extra]
              for k in range(4))
    return out.astype(np.float32)


def _linear_axis(n_in, n_out):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i = np.floor(f).astype(np.int64)
    t = f - i
    t = np.where((i < 0) | (i >= n_in - 1), 0.0, t)
    i = np.clip(i, 0, n_in - 1)
    t = t.astype(np.float32)
    return (i, np.minimum(i + 1, n_in - 1),
            (np.float32(1) - t).astype(np.float64), t.astype(np.float64))


def resize_linear(x, w, h):
    """``cv2.resize(x, (w, h))`` (``INTER_LINEAR``) of a float32 image,
    in float64 rounded once."""
    x = np.asarray(x, np.float64)
    y0, y1, b0, b1 = _linear_axis(x.shape[0], h)
    x0, x1, a0, a1 = _linear_axis(x.shape[1], w)
    extra = (None,) * (x.ndim - 2)
    ex = (slice(None),) + extra
    r = x[:, x0] * a0[ex] + x[:, x1] * a1[ex]
    r = r.astype(np.float32).astype(np.float64)
    ey = (slice(None), None) + extra
    return (r[y0] * b0[ey] + r[y1] * b1[ey]).astype(np.float32)


def remap_nearest(x, map_x, map_y):
    """``cv2.remap(x, map_x, map_y, INTER_NEAREST)`` with float32 maps
    (zero outside the image)."""
    h, w = x.shape[:2]
    xs = np.rint(np.asarray(map_x, np.float32)).astype(np.int64)
    ys = np.rint(np.asarray(map_y, np.float32)).astype(np.int64)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = x[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    out[~inside] = 0
    return out


def _reflect(i, n):
    i = np.where(i < 0, -i - 1, i)
    return np.where(i >= n, 2 * n - i - 1, i)


def remap_linear(x, map_x, map_y):
    """``cv2.remap(x, map_x, map_y, INTER_LINEAR,
    borderMode=BORDER_REFLECT)`` of a float32 image with float32 maps that
    stay within one pixel of the image."""
    x = np.asarray(x, np.float32)
    h, w = x.shape[:2]
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    ix, iy = np.floor(mx), np.floor(my)
    a, b = mx - ix, my - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    x0, x1 = _reflect(ix, w), _reflect(ix + 1, w)
    y0, y1 = _reflect(iy, h), _reflect(iy + 1, h)
    p00, p01, p10, p11 = x[y0, x0], x[y0, x1], x[y1, x0], x[y1, x1]
    if x.ndim == 3:
        a, b = a[..., None], b[..., None]
    a = np.broadcast_to(a, p00.shape)
    b = np.broadcast_to(b, p00.shape)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    return fma32(b, v1 - v0, v0)
