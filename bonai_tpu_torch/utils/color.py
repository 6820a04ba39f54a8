"""BGR <-> HSV of uint8 images in numpy, rounding as OpenCV's
``cv2.cvtColor(..., COLOR_BGR2HSV)`` and ``COLOR_HSV2BGR`` round (hue in
``[0, 180)``), for ``PhotoMetricDistortion`` without cv2.

BGR -> HSV is OpenCV's integer path: 12-bit fixed-point reciprocal tables
for the saturation (``255 / v``) and the hue (``30 / diff``), each product
rounded by adding half and shifting.  HSV -> BGR is its float32 path: the
hue scaled by ``6 / 180``, its sector and fraction ``f``, the four sector
values ``v``, ``v (1 - s)``, ``v fma(-s, f, 1)``, ``v fma(-s, 1 - f, 1)``
(fused multiply-adds: one rounding) and each channel times 255.  OpenCV
5.0 (its x86 build, AVX2 dispatch) computes each image row in vector
blocks of 32 pixels, whose channels it truncates, and the row's last
``width mod 32`` pixels in scalar code, which rounds them to the nearest
even; ``hsv_to_bgr`` does the same by column.  A CPU test holds both
functions to ``cv2.cvtColor`` on all 2^24 colours, through both paths.
"""


from __future__ import annotations

import numpy as np

from .warp import fma32

_SHIFT = 12
VECTOR_BLOCK = 32                # pixels of a row in one vector step
_i = np.arange(1, 256, dtype=np.float64)
# OpenCV's tables, saturate_cast<int> (round half to even) of the quotients
_SDIV = np.concatenate([[0], np.rint((255 << _SHIFT) / _i)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _SHIFT) / (6.0 * _i))]).astype(
    np.int64)


# each sector's (b, g, r) picks of the four sector values
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr_to_hsv(img):
    """``(..., 3)`` uint8 BGR -> uint8 HSV, H in ``[0, 180)``."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_SHIFT - 1))) >> _SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_SHIFT - 1))) >> _SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr(hsv):
    """``(..., W, 3)`` uint8 HSV (H in ``[0, 180)``; larger wraps) -> uint8
    BGR, rows of ``W`` pixels as OpenCV converts them."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * (f32(6.0) / f32(180))
    s = hsv[..., 1].astype(f32) * (f32(1.0) / f32(255.0))
    v = hsv[..., 2].astype(f32) * (f32(1.0) / f32(255.0))
    h = np.fmod(h, f32(6.0))
    sector = np.floor(h)
    h = h - sector
    width = hsv.shape[-2]
    vector = np.arange(width) < width // VECTOR_BLOCK * VECTOR_BLOCK
    tab = np.stack([v, v * (f32(1.0) - s), v * fma32(-s, h, 1.0),
                    v * fma32(-s, f32(1.0) - h, 1.0)], -1)
    picks = _SECTORS[sector.astype(np.int64)]
    bgr = np.take_along_axis(tab, picks, -1) * f32(255.0)
    bgr = np.where(vector[:, None], np.floor(bgr), np.rint(bgr))
    return np.clip(bgr, 0, 255).astype(np.uint8)
