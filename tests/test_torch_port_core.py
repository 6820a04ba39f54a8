"""bonai_tpu_torch box geometry, anchors and NMS against the JAX package.

Geometry in float32 to 1e-5; NMS keep masks identical; soft-NMS scores
to 1e-5 with identical selection order; multi-class NMS outputs equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread a process)

from bonai_tpu.core import anchors as jax_anchors
from bonai_tpu.core import boxes as jax_boxes
from bonai_tpu_torch.core import anchors, boxes, nms

# bonai_tpu.core re-exports the function nms under the module's name
jax_nms = importlib.import_module("bonai_tpu.core.nms")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(r, n, size=200.0, clustered=True):
    """Random boxes; ``clustered`` puts them around a few centres so NMS
    suppresses a lot."""
    if clustered:
        centres = r.uniform(20, size - 20, (max(n // 12, 1), 2))
        c = centres[r.randint(0, len(centres), n)] + r.normal(0, 6, (n, 2))
    else:
        c = r.uniform(0, size, (n, 2))
    wh = r.uniform(8, 60, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def test_geometry_matches_jax():
    r = np.random.RandomState(0)
    a, b = _boxes(r, 40), _boxes(r, 30)
    np.testing.assert_allclose(
        boxes.bbox_overlaps(_t(a), _t(b)).numpy(),
        np.asarray(jax_boxes.bbox_overlaps(a, b)), rtol=1e-5, atol=1e-6)
    deltas = r.normal(0, 0.5, (40, 8)).astype(np.float32)
    means, stds = (0.1, 0.0, -0.1, 0.0), (0.1, 0.1, 0.2, 0.2)
    np.testing.assert_allclose(
        boxes.delta2bbox(_t(a), _t(deltas), means, stds,
                         max_shape=(150.0, 170.0)).numpy(),
        np.asarray(jax_boxes.delta2bbox(a, deltas, means, stds,
                                        max_shape=(150.0, 170.0))),
        rtol=1e-5, atol=1e-4)
    od = r.normal(0, 2.0, (40, 2)).astype(np.float32)
    hs, ws = np.full(40, 90.0, np.float32), np.full(40, 120.0, np.float32)
    np.testing.assert_allclose(
        boxes.delta2offset(_t(a), _t(od), (0., 0.), (.5, .5),
                           max_shape=(_t(hs), _t(ws))).numpy(),
        np.asarray(jax_boxes.delta2offset(a, od, (0., 0.), (.5, .5),
                                          max_shape=(hs, ws))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        boxes.clip_boxes(_t(a), (100.0, 120.0)).numpy(),
        np.asarray(jax_boxes.clip_boxes(a, (100.0, 120.0))))


def test_grid_anchors_match_jax():
    kw = dict(strides=[4, 8, 16, 32, 64], ratios=[0.5, 1.0, 2.0],
              scales=[8])
    sizes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    for got, ref in zip(anchors.AnchorGenerator(**kw).grid_anchors(sizes),
                        jax_anchors.AnchorGenerator(**kw).grid_anchors(sizes)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,tile", [(600, 256), (90, 32)])
def test_nms_keep_masks_identical(n, tile):
    """Several tiles, batched problems, invalid entries and score ties."""
    r = np.random.RandomState(n)
    bx = np.stack([_boxes(r, n), _boxes(r, n)])
    sc = r.uniform(0, 1, (2, n)).astype(np.float32)
    sc[:, 10:20] = sc[:, :10]                         # exact ties
    valid = r.uniform(size=(2, n)) > 0.1
    got = nms.nms(_t(bx), _t(sc), 0.5, valid=_t(valid), tile_size=tile)
    f = jax.jit(lambda b, s, v: jax_nms.nms(b, s, 0.5, valid=v,
                                            tile_size=tile))
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(f(bx[i], sc[i], valid[i])))
    assert 0 < int(got.sum()) < valid.sum()


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches_jax(method):
    r = np.random.RandomState(1)
    n = 120
    bx = np.stack([_boxes(r, n), _boxes(r, n)])
    sc = r.uniform(0, 1, (2, n)).astype(np.float32)
    valid = r.uniform(size=(2, n)) > 0.1
    got_s, got_r = nms.soft_nms(_t(bx), _t(sc), 0.5, method=method,
                                max_out=80, valid=_t(valid))
    f = jax.jit(lambda b, s, v: jax_nms.soft_nms(
        b, s, 0.5, method=method, max_out=80, valid=v))
    for i in range(2):
        ref_s, ref_r = f(bx[i], sc[i], valid[i])
        np.testing.assert_allclose(got_s[i].numpy(), np.asarray(ref_s),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got_r[i].numpy(), np.asarray(ref_r))


def test_soft_nms_early_exit_leaves_scores():
    """After every score falls below min_score no slot changes the
    output, however many slots max_out leaves."""
    r = np.random.RandomState(2)
    bx = _boxes(r, 40, clustered=False)[None]
    sc = np.full((1, 40), 1e-4, np.float32)
    sc[0, :3] = [0.9, 0.5, 0.2]
    got_s, got_r = nms.soft_nms(_t(bx), _t(sc), 0.5, max_out=40)
    assert int((got_r >= 0).sum()) == 3
    np.testing.assert_allclose(got_s[0, 3:].numpy(), 0.0)


@pytest.mark.parametrize("nms_type", ["soft_nms", "nms"])
@pytest.mark.parametrize("agnostic", [True, False])
def test_multiclass_nms_matches_jax(nms_type, agnostic):
    r = np.random.RandomState(3)
    n, k = 100, 2
    bx = np.stack([_boxes(r, n)] * (1 if agnostic else k), 1)
    bx = np.stack([bx.reshape(n, -1), bx.reshape(n, -1)[::-1]])
    sc = r.dirichlet(np.ones(k + 1), (2, n)).astype(np.float32)
    valid = r.uniform(size=(2, n)) > 0.2
    cfg = dict(type=nms_type, iou_threshold=0.5)
    got = nms.multiclass_nms(_t(bx), _t(sc), 0.05, cfg, 60, valid=_t(valid))
    f = jax.jit(lambda b, s, v: jax_nms.multiclass_nms(b, s, 0.05, cfg, 60,
                                                       valid=v))
    for i in range(2):
        ref = f(jnp.asarray(bx[i]), sc[i], valid[i])
        for g, e in zip(got, ref):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(e),
                                       rtol=1e-5, atol=1e-5)
