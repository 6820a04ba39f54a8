"""Image corruptions for the robustness benchmark (counterpart of
``bonai_tpu/datasets/pipelines/corrupt.py``), without cv2: the filters are
``utils/filters.py``'s, the snow kernel's rotation ``utils/warp.py``'s and
the JPEG round trip ``utils/jpeg.py``'s.

Every corruption draws from the given ``numpy.random.RandomState`` in
the JAX package's order, so the random parts are equal to the bit; the
filters follow OpenCV 5.0's arithmetic (exactly where ``utils/filters.py``
says so, else within a few ulps).
"""

from __future__ import annotations

import numpy as np

from ...utils.filters import (filter2d, gaussian_blur, remap_linear,
                              remap_nearest, resize_cubic, resize_linear)
from ...utils.jpeg import jpeg_round_trip
from ...utils.warp import rotation_matrix_2d, warp_affine
from .transforms import PIPELINES, resize_nearest

_SEV = {
    "gaussian_noise": [8, 16, 24, 32, 48],
    "shot_noise": [60, 25, 12, 5, 3],
    "impulse_noise": [0.03, 0.06, 0.09, 0.17, 0.27],
    "gaussian_blur": [1, 2, 3, 4, 6],
    "defocus_blur": [3, 4, 6, 8, 10],
    "glass_blur": [2, 4, 6, 8, 10],
    "motion_blur": [3, 5, 9, 13, 17],
    "zoom_blur": [1.11, 1.16, 1.21, 1.26, 1.31],
    "snow": [0.1, 0.2, 0.3, 0.45, 0.55],
    "frost": [0.4, 0.5, 0.6, 0.7, 0.8],
    "fog": [1.5, 2.0, 2.5, 3.0, 3.5],
    "brightness": [0.1, 0.2, 0.3, 0.4, 0.5],
    "contrast": [0.75, 0.5, 0.4, 0.3, 0.15],
    "elastic_transform": [10, 20, 30, 45, 60],
    "pixelate": [0.8, 0.65, 0.5, 0.35, 0.25],
    "jpeg_compression": [80, 60, 40, 25, 15],
}


def _low_freq_noise(rng, h, w, octaves=4):
    """Smooth multi-octave noise in [0, 1]: cubic upsamplings of coarse
    uniform grids, halving in weight per octave."""
    acc = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        step = max(min(h, w) >> (octaves - o), 2)
        coarse = rng.rand(h // step + 2, w // step + 2).astype(np.float32)
        acc += amp * resize_cubic(coarse, w, h)
        total += amp
        amp *= 0.5
    acc /= total
    lo, hi = acc.min(), acc.max()
    return (acc - lo) / max(hi - lo, 1e-6)


def _line_kernel(k):
    kern = np.zeros((k, k), np.float32)
    kern[k // 2, :] = 1.0 / k
    return kern


def corrupt_image(img, corruption, severity=1, rng=None):
    """Apply a corruption to a uint8/float BGR image (severity 1..5)."""
    rng = rng or np.random.RandomState(0)
    sev = _SEV[corruption][min(max(severity, 1), 5) - 1]
    x = img.astype(np.float32)
    h, w = x.shape[:2]
    if corruption == "gaussian_noise":
        x = x + rng.randn(*x.shape) * sev
    elif corruption == "shot_noise":
        x = rng.poisson(np.clip(x, 0, 255) / 255.0 * sev) / sev * 255.0
    elif corruption == "gaussian_blur":
        k = int(sev) * 2 + 1
        x = gaussian_blur(x, (k, k), sev)
    elif corruption == "motion_blur":
        x = filter2d(x, _line_kernel(int(sev)))
    elif corruption == "brightness":
        x = x + 255.0 * sev
    elif corruption == "contrast":
        mean = x.mean(axis=(0, 1), keepdims=True)
        x = (x - mean) * sev + mean
    elif corruption == "pixelate":
        x = resize_linear(x, max(int(w * sev), 1), max(int(h * sev), 1))
        x = resize_nearest(x, h, w)
    elif corruption == "jpeg_compression":
        x = jpeg_round_trip(np.clip(img, 0, 255).astype(np.uint8),
                            int(sev)).astype(np.float32)
    elif corruption == "impulse_noise":
        u = rng.rand(h, w)
        x[u < sev / 2] = 0.0
        x[u > 1.0 - sev / 2] = 255.0
    elif corruption == "defocus_blur":
        r = int(sev)
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        disk = ((yy ** 2 + xx ** 2) <= r ** 2).astype(np.float32)
        x = filter2d(x, disk / disk.sum())
    elif corruption == "glass_blur":
        d = int(sev)
        dy = rng.randint(-d, d + 1, (h, w)).astype(np.float32)
        dx = rng.randint(-d, d + 1, (h, w)).astype(np.float32)
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        x = remap_nearest(x, np.clip(gx + dx, 0, w - 1),
                          np.clip(gy + dy, 0, h - 1))
        x = gaussian_blur(x, (3, 3), 0.7)
    elif corruption == "zoom_blur":
        acc = x.copy()
        n = 1
        for z in np.arange(1.01, sev, 0.02):
            zh, zw = int(h / z), int(w / z)
            y0, x0 = (h - zh) // 2, (w - zw) // 2
            acc += resize_linear(x[y0:y0 + zh, x0:x0 + zw], w, h)
            n += 1
        x = acc / n
    elif corruption == "snow":
        grains = rng.randn(h, w).astype(np.float32) * 4 + sev * 10
        grains = np.clip(grains - 8, 0, None)
        k = 9
        m = rotation_matrix_2d((k / 2, k / 2), float(rng.uniform(-60, -30)))
        kern = warp_affine(_line_kernel(k), m, (k, k), "linear")
        streaks = filter2d(grains, kern)[..., None]
        x = np.maximum(x, x.mean(-1, keepdims=True) * 0.5 + 127.5 * 0.5) \
            * sev + x * (1 - sev)
        x = np.clip(x + streaks * 255.0 / max(streaks.max(), 1e-6) * 0.6,
                    0, 255)
    elif corruption == "frost":
        tex = _low_freq_noise(rng, h, w)[..., None]
        crystals = (tex > 0.6).astype(np.float32) * tex
        x = x * (1 - 0.4 * sev) + \
            (190.0 + 65.0 * tex) * crystals * sev + \
            x * (1 - crystals) * 0.4 * sev
    elif corruption == "fog":
        fog = _low_freq_noise(rng, h, w)[..., None] * sev
        mx = x.max() if x.max() > 0 else 255.0
        x = (x + fog * 255.0) * mx / (mx + sev * 255.0)
    elif corruption == "elastic_transform":
        sigma = max(min(h, w) * 0.01, 2.0) * 4
        dy = gaussian_blur(rng.rand(h, w).astype(np.float32) * 2 - 1,
                           (0, 0), sigma) * sev
        dx = gaussian_blur(rng.rand(h, w).astype(np.float32) * 2 - 1,
                           (0, 0), sigma) * sev
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        x = remap_linear(x, np.clip(gx + dx, 0, w - 1),
                         np.clip(gy + dy, 0, h - 1))
    else:
        raise KeyError(f"unknown corruption {corruption}; "
                       f"available: {sorted(_SEV)}")
    return np.clip(x, 0, 255).astype(img.dtype if img.dtype == np.uint8
                                     else np.float32)


@PIPELINES.register_module()
class Corrupt:
    """Corrupts ``results['img']`` with ``corruption`` at ``severity``,
    drawing from ``results['_rng']`` (a fresh ``RandomState(0)`` where
    there is none)."""

    def __init__(self, corruption, severity=1):
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results):
        rng = results.get("_rng") or np.random.RandomState(0)
        results["img"] = corrupt_image(results["img"], self.corruption,
                                       self.severity, rng)
        return results
