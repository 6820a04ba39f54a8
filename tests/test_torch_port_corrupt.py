"""``Corrupt`` and ``corrupt_image`` of bonai_tpu_torch against the JAX
package's, and ``utils/filters.py`` against the cv2 5.0 calls they
replace, on the CPU.

- All 16 corruptions at severities 1-5 on a 64x64 and an 80x96 (H x W)
  uint8 image (smooth colour fields plus noise), the same
  ``RandomState(7)`` on both sides.  The noise, brightness, contrast,
  impulse and glass corruptions are exact; so is every other, except that
  a filter path may differ by one level: here fog at severity 1 (1 pixel)
  and pixelate at severity 4 (6 pixels) on the 80x96 image, where
  OpenCV 5.0 resizes through Intel IPP (``utils/filters.py``).  Frost's
  ``tex > 0.6`` selection: any element selected on one side only lies
  within 1e-6 of 0.6 (ROADMAP.md's rule for selections under float noise).
- Each filter on its own against cv2: ``gaussian_blur`` (3 to 65 taps,
  ``ksize=(0, 0)``), the direct ``filter2d`` and the snow kernel's float32
  ``warpAffine`` exact; the DFT-sized ``filter2d`` (13 to 21 taps) equal
  but for at most 1 element in 10^3, within 1e-6 relative; the IPP
  resizes within 2e-6 relative; ``resize_nearest`` and both remaps exact;
  the host library's loops equal to the numpy emulation to the bit.
- ``Corrupt`` in a pipeline with ``_rng`` against the JAX pipeline (and
  through the test loader in ``test_torch_port_datasets_extra.py``).
"""

import cv2
import numpy as np
import pytest

from bonai_tpu.datasets.pipelines.corrupt import _SEV
from bonai_tpu.datasets.pipelines.corrupt import \
    _low_freq_noise as jax_low_freq_noise
from bonai_tpu.datasets.pipelines.corrupt import \
    corrupt_image as jax_corrupt_image
from bonai_tpu_torch.datasets.pipelines import build_pipeline
from bonai_tpu_torch.datasets.pipelines.corrupt import (_low_freq_noise,
                                                        corrupt_image)
from bonai_tpu_torch.datasets.pipelines.transforms import (UNPORTED,
                                                           resize_nearest)
from bonai_tpu_torch.utils import filters
from bonai_tpu_torch.utils.warp import rotation_matrix_2d, warp_affine

EXACT = ("gaussian_noise", "shot_noise", "impulse_noise", "brightness",
         "contrast", "glass_blur")
SHAPES = ((64, 64), (80, 96))


def _image(h, w, seed=0):
    rs = np.random.RandomState(seed)
    base = cv2.resize(rs.rand(h // 8, w // 8, 3).astype(np.float32) * 255,
                      (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(base + rs.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("corruption", sorted(_SEV))
def test_corruption_matches_jax(corruption, shape):
    img = _image(*shape)
    for sev in range(1, 6):
        ref = jax_corrupt_image(img, corruption, sev,
                                np.random.RandomState(7))
        got = corrupt_image(img, corruption, sev, np.random.RandomState(7))
        assert got.dtype == ref.dtype == np.uint8
        diff = np.abs(got.astype(np.int64) - ref)
        if corruption in EXACT:
            assert diff.max() == 0, (corruption, sev)
        else:
            assert diff.max() <= 1, (corruption, sev, diff.max())
            assert (diff > 0).mean() < 1e-2, (corruption, sev)


@pytest.mark.parametrize("shape", SHAPES)
def test_frost_threshold_under_float_noise(shape):
    h, w = shape
    for seed in range(5):
        ref = jax_low_freq_noise(np.random.RandomState(seed), h, w)
        got = _low_freq_noise(np.random.RandomState(seed), h, w)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        flipped = (got > 0.6) != (ref > 0.6)
        assert np.all(np.abs(ref[flipped] - 0.6) <= 1e-6)


def _motion(k):
    kern = np.zeros((k, k), np.float32)
    kern[k // 2, :] = 1.0 / k
    return kern


def _disk(r):
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    d = ((yy ** 2 + xx ** 2) <= r ** 2).astype(np.float32)
    return d / d.sum()


def _float_image(shape, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.rand(*shape) * 255).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 64, 3), (80, 96, 3), (64, 64),
                                   (1024, 32)])
def test_gaussian_blur_matches_cv2(shape):
    x = _float_image(shape)
    for n, sigma in ((3, 0.7), (3, 1), (5, 2), (7, 3), (9, 4), (13, 6),
                     (0, 8.0), (0, 40.96)):
        ref = cv2.GaussianBlur(x, (n, n), sigma)
        got = filters.gaussian_blur(x, (n, n), sigma)
        np.testing.assert_array_equal(got, ref, err_msg=f"{n} {sigma}")
    for n, sigma in ((3, 0.7), (65, 8.0), (329, 40.96)):
        np.testing.assert_array_equal(
            filters.gaussian_kernel(n, sigma),
            cv2.getGaussianKernel(n, sigma, ktype=cv2.CV_32F).ravel())


@pytest.mark.parametrize("shape", [(64, 64, 3), (80, 96, 3), (64, 64)])
def test_filter2d_matches_cv2(shape):
    x = _float_image(shape)
    angle = -41.7
    m = rotation_matrix_2d((4.5, 4.5), angle)
    snow = warp_affine(_motion(9), m, (9, 9), "linear")
    direct = [_motion(3), _motion(5), _motion(9), _disk(3), _disk(4), snow]
    for kern in direct:
        ref = cv2.filter2D(x, -1, kern)
        np.testing.assert_array_equal(filters.filter2d(x, kern), ref)
    for kern in (_motion(13), _motion(17), _disk(6), _disk(8), _disk(10)):
        ref = cv2.filter2D(x, -1, kern)
        got = filters.filter2d(x, kern)
        assert (got != ref).mean() <= 1e-3
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_snow_kernel_warp_matches_cv2():
    """The float32 single-channel linear warp, OpenCV's scalar path at 9
    wide and its vector path plus tail at 37 and 50."""
    rs = np.random.RandomState(3)
    for src in (_motion(9), rs.rand(40, 37).astype(np.float32),
                rs.rand(20, 50).astype(np.float32)):
        h, w = src.shape
        for angle in rs.uniform(-60, -30, 10):
            ref = cv2.warpAffine(src, cv2.getRotationMatrix2D(
                (w / 2, h / 2), float(angle), 1.0), (w, h))
            got = warp_affine(src, rotation_matrix_2d((w / 2, h / 2),
                                                      float(angle)),
                              (w, h), "linear")
            np.testing.assert_array_equal(got, ref)


def test_resizes_and_remaps_match_cv2():
    rs = np.random.RandomState(4)
    x = _float_image((80, 96, 3))
    for w, h in ((76, 64), (24, 20), (48, 40), (33, 27)):
        ref = cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(filters.resize_linear(x, w, h), ref,
                                   rtol=2e-6, atol=1e-4)
        small = filters.resize_linear(x, w, h)
        np.testing.assert_array_equal(
            resize_nearest(small, 80, 96),
            cv2.resize(small, (96, 80), interpolation=cv2.INTER_NEAREST))
    for sh, sw in ((18, 18), (7, 8), (22, 26)):
        c = rs.rand(sh, sw).astype(np.float32)
        ref = cv2.resize(c, (96, 80), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_allclose(filters.resize_cubic(c, 96, 80), ref,
                                   rtol=2e-6, atol=2e-6)
    h, w = 80, 96
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = rs.randint(-4, 5, (2, h, w)).astype(np.float32)
    mx, my = np.clip(gx + d[0], 0, w - 1), np.clip(gy + d[1], 0, h - 1)
    np.testing.assert_array_equal(filters.remap_nearest(x, mx, my),
                                  cv2.remap(x, mx, my, cv2.INTER_NEAREST))
    f = filters.gaussian_blur(rs.rand(h, w).astype(np.float32) * 2 - 1,
                              (0, 0), 8.0) * 45
    mx, my = np.clip(gx + f, 0, w - 1), np.clip(gy - f, 0, h - 1)
    np.testing.assert_array_equal(
        filters.remap_linear(x, mx, my),
        cv2.remap(x, mx, my, cv2.INTER_LINEAR,
                  borderMode=cv2.BORDER_REFLECT))


def test_corrupt_in_a_pipeline_with_rng():
    from bonai_tpu.datasets.pipelines import build_pipeline as jax_pipeline
    assert "Corrupt" not in UNPORTED
    img = _image(64, 64, seed=5)
    for corruption in ("gaussian_noise", "snow", "jpeg_compression"):
        cfg = [dict(type="Corrupt", corruption=corruption, severity=3)]
        ref = jax_pipeline(cfg)(dict(img=img.copy(),
                                     _rng=np.random.RandomState(11)))
        got = build_pipeline(cfg)(dict(img=img.copy(),
                                       _rng=np.random.RandomState(11)))
        np.testing.assert_array_equal(got["img"], ref["img"])
        # without an _rng both fall back to RandomState(0)
        ref = jax_pipeline(cfg)(dict(img=img.copy()))
        got = build_pipeline(cfg)(dict(img=img.copy()))
        np.testing.assert_array_equal(got["img"], ref["img"])
    with pytest.raises(KeyError):
        corrupt_image(img, "rain", 1)
