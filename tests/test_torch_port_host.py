"""bonai_tpu_torch host side against the JAX package: the test pipeline
(exact at identity size; after one bilinear rescale within one 8-bit
level everywhere and a quarter level on average, since cv2 rounds uint8
resizes in fixed point), the COCO RLE
encoder (exact), and ``results_to_host`` (bbox arrays and offsets to 1e-4,
per-mask IoU >= 0.99: cv2 and numpy bilinear differ at the 0.5
threshold)."""

import numpy as np
import pytest
import torch

from bonai_tpu.apis.test import results_to_host as jax_results_to_host
from bonai_tpu.datasets import mask_utils
from bonai_tpu.datasets.pipelines import build_pipeline
from bonai_tpu_torch import Config
from bonai_tpu_torch.apis import results_to_host
from bonai_tpu_torch.core.masks import crop_rle
from bonai_tpu_torch.datasets.pipelines import \
    build_pipeline as port_build_pipeline
from torch_port_common import CONFIG

STD = 57.12          # the smallest std of img_norm_cfg


def _pipeline(build, cfg, img):
    """The test pipeline without ``LoadImageFromFile`` on an in-memory
    image, as ``inference_detector`` runs it in both packages."""
    steps = [dict(s) for s in cfg.data.test.pipeline
             if s["type"] != "LoadImageFromFile"]
    out = build(steps)({"img": img, "img_shape": img.shape[:2],
                        "ori_shape": img.shape[:2], "scale_factor": 1.0})
    return out


@pytest.mark.parametrize("shape", [(768, 1024), (300, 410)])
def test_pipeline_matches_jax(shape):
    cfg = Config.fromfile(CONFIG)
    img = np.random.RandomState(0).randint(0, 256, shape + (3,), np.uint8)
    ref = _pipeline(build_pipeline, cfg, img)
    got = _pipeline(port_build_pipeline, cfg, img)
    assert got["img"].shape == ref["img"].shape
    assert tuple(got["img_shape"]) == tuple(ref["img_shape"])
    np.testing.assert_allclose(got["scale_factor"], ref["scale_factor"])
    diff = np.abs(got["img"] - ref["img"])
    if shape == (768, 1024):
        np.testing.assert_array_equal(got["img"], ref["img"])
    else:
        assert diff.max() <= 1.0 / STD + 1e-5
        assert diff.mean() < 0.25 / STD


@pytest.mark.parametrize("crop_at", [(0, 0), (5, 7), (40, 52), (44, 56)])
def test_crop_rle_matches_full_mask_encoder(crop_at):
    r = np.random.RandomState(sum(crop_at))
    crop = (r.uniform(size=(6, 4)) > 0.5).astype(np.uint8)
    crop[0, 0] = 1
    y0, x0 = crop_at
    full = np.zeros((50, 60), np.uint8)
    full[y0:y0 + 6, x0:x0 + 4] = crop[:50 - y0, :60 - x0]
    got = crop_rle(crop[:50 - y0, :60 - x0], y0, x0, 50, 60)
    assert got == mask_utils.encode_mask(full)


def test_crop_rle_empty_and_full():
    assert crop_rle(np.zeros((0, 0), np.uint8), 0, 0, 8, 9) == \
        mask_utils.encode_mask(np.zeros((8, 9), np.uint8))
    assert crop_rle(np.ones((8, 9), np.uint8), 0, 0, 8, 9) == \
        mask_utils.encode_mask(np.ones((8, 9), np.uint8))


def test_results_to_host_matches_jax():
    r = np.random.RandomState(1)
    b, p = 2, 12
    xy = r.uniform(-20, 150, (b, p, 2))
    wh = r.uniform(5, 60, (b, p, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # smooth probability maps (the head's outputs are smooth)
    g = np.linspace(-1, 1, 28)
    cx, cy = r.uniform(-0.5, 0.5, (2, b, p, 1, 1))
    probs = 1 / (1 + np.exp(-6 * (0.6 - np.hypot(g[None, None, None, :] - cx,
                                                  g[None, None, :, None] - cy))))
    out = {"det_bboxes": boxes,
           "det_scores": r.uniform(0.1, 1, (b, p)).astype(np.float32),
           "det_labels": np.zeros((b, p), np.int32),
           "det_valid": r.uniform(size=(b, p)) > 0.2,
           "mask_probs": probs.astype(np.float32),
           "offsets": r.normal(0, 5, (b, p, 2)).astype(np.float32)}
    metas = [{"ori_shape": (160, 180)}, {"ori_shape": (150, 200)}]
    ref = jax_results_to_host(out, metas)
    got = results_to_host({k: torch.from_numpy(v) for k, v in out.items()},
                          metas)
    for (gb, gs, go), (rb, rs, ro) in zip(got, ref):
        np.testing.assert_allclose(gb[0], rb[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go, ro, rtol=1e-4, atol=1e-4)
        assert len(gs[0]) == len(rs[0]) > 0
        for gm, rm in zip(gs[0], rs[0]):
            a, c = mask_utils.decode_mask(gm), mask_utils.decode_mask(rm)
            union = np.logical_or(a, c).sum()
            if union:
                assert np.logical_and(a, c).sum() / union >= 0.99
