"""``RandomRotate``, ``Pointobb2RBBox`` and the rotated-box pieces of
bonai_tpu_torch against cv2 5.0 and the JAX package on the CPU.

- ``utils/warp.py`` against cv2: the rotation matrix and its inverse, the
  uint8 3-channel linear warp, the uint8 1-channel and the float32
  2-channel nearest warps at 37, 123 and 271 degrees and the multiples of
  90, at 64^2, 128x160 and once at 1024^2: exact.  ``convex_hull``
  against ``cv2.convexHull``: exact.
- ``min_area_rect`` and ``Pointobb2RBBox`` against cv2 and the JAX
  transform on 200 random integer quads, squares, axis-aligned rectangles,
  collinear points and a single point: within 1e-4.  Where several edges
  give boxes of exactly the same area (every triangular hull), float
  rounding picks one; on one quad of the 4500 tried cv2 5.0 picks another
  than the port (ROADMAP.md queue C), and the test shows on that quad
  that both are boxes of the least area (the near-tie rule).
- ``RandomRotate`` against the JAX transform on a results dict with every
  field, on the exact 90-degree path and the general path and with
  ``angles='any'``: maps and image exact, boxes, polygons and offsets
  within 1e-5, the same draws; the train loader with ``RandomRotate``
  equal to the JAX process loader's rows.
- ``DeltaRBBoxCoder`` within 1e-5 of JAX; ``RAnchorGenerator`` exact.
"""

import copy
from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

from bonai_tpu.datasets.pipelines.transforms import PIPELINES as JAX_REG
from bonai_tpu_torch.datasets.pipelines import build_pipeline
from bonai_tpu_torch.utils import warp
from torch_port_common import synth_data, synth_train_cfg

ANGLES = (37, 123, 271, 90, 180, 270)


def _m(w, h, angle):
    return cv2.getRotationMatrix2D(((w - 1) * 0.5, (h - 1) * 0.5), angle,
                                   1.0)


@pytest.mark.parametrize("size", [(64, 64), (128, 160), (1024, 1024)])
def test_warps_match_cv2(size):
    h, w = size
    r = np.random.RandomState(h + w)
    img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    edge = r.randint(0, 256, (h, w)).astype(np.uint8)
    field = r.uniform(-30, 30, (h, w, 2)).astype(np.float32)
    for angle in ANGLES if h < 1024 else (37,):
        m = _m(w, h, angle)
        np.testing.assert_array_equal(
            warp.rotation_matrix_2d(((w - 1) * 0.5, (h - 1) * 0.5), angle),
            m)
        np.testing.assert_array_equal(warp.invert_affine(m),
                                      cv2.invertAffineTransform(m))
        for src, kind, flag in ((img, "linear", cv2.INTER_LINEAR),
                                (edge, "nearest", cv2.INTER_NEAREST),
                                (field, "nearest", cv2.INTER_NEAREST)):
            got = warp.warp_affine(src, m, (w, h), kind)
            want = cv2.warpAffine(src, m, (w, h), flags=flag)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{kind} {src.dtype} "
                                                  f"{angle}")


def test_convex_hull_matches_cv2():
    r = np.random.RandomState(0)
    sets = [r.randint(0, 60, (n, 2)) for n in (3, 4, 5, 8) for _ in range(50)]
    sets += [np.array([[3, 3]] * 4), np.array([[0, 0], [0, 5], [0, 9]]),
             np.array([[0, 0], [5, 5], [10, 10], [2, 2]])]
    for pts in sets:
        want = cv2.convexHull(pts.astype(np.int32))
        np.testing.assert_array_equal(pts[warp.convex_hull(pts)],
                                      want.reshape(-1, 2))


def _quads():
    r = np.random.RandomState(3)
    quads = [r.randint(0, 400, (4, 2)) for _ in range(200)]
    quads += [np.array([[10, 10], [30, 10], [30, 30], [10, 30]]),    # squares
              np.array([[5, 1], [9, 5], [5, 9], [1, 5]]),
              np.array([[10, 10], [30, 10], [30, 20], [10, 20]]),    # rects
              np.array([[7, 2], [7, 40], [3, 40], [3, 2]]),
              np.array([[0, 0], [5, 5], [10, 10], [2, 2]]),          # lines
              np.array([[4, 0], [4, 9], [4, 3], [4, 7]]),
              np.array([[6, 6]] * 4)]
    return quads


def _box_area(pts, edge):
    """The exact area of the hull's box flush with ``edge`` (a pair of
    integer points), as a fraction."""
    e = edge[1] - edge[0]
    proj, perp = pts @ e, pts @ np.array([-e[1], e[0]])
    return Fraction(int(proj.max() - proj.min())
                    * int(perp.max() - perp.min()), int(e @ e))


def _flush_edge(hull, rect):
    """The hull edge that the side of ``rect``'s angle runs along or
    across."""
    a = np.deg2rad(rect[2])
    d = np.array([np.cos(a), np.sin(a)])
    n = len(hull)
    edges = [(hull[i], hull[(i + 1) % n]) for i in range(n)]

    def off(e):
        u = (e[1] - e[0]) / np.linalg.norm(e[1] - e[0])
        return min(abs(d[0] * u[1] - d[1] * u[0]), abs(float(d @ u)))
    return min(edges, key=off)


def _rect(r):
    return np.array([*r[0], *r[1], r[2]])


def test_min_area_rect_matches_cv2():
    for q in _quads():
        got = warp.min_area_rect(q)
        np.testing.assert_allclose(
            _rect(got), _rect(cv2.minAreaRect(q.astype(np.int64))), rtol=0,
            atol=1e-4, err_msg=str(q.tolist()))
        assert -90 <= got[2] < 0


def test_min_area_rect_tie_is_a_least_box():
    """The quad on which cv2 5.0 and the port pick different boxes of the
    same least area: both lie flush with a hull edge whose box has the
    least exact area, and their areas agree to float noise."""
    q = np.array([[14, 39], [30, 26], [34, 54], [17, 35]])
    want = cv2.minAreaRect(q.astype(np.int64))
    got = warp.min_area_rect(q)
    assert not np.allclose(_rect(got), _rect(want), rtol=0, atol=1e-4)
    hull = q[warp.convex_hull(q)]
    least = min(_box_area(hull, (hull[i], hull[(i + 1) % len(hull)]))
                for i in range(len(hull)))
    for r in (want, got):
        assert _box_area(hull, _flush_edge(hull, r)) == least
        assert abs(r[1][0] * r[1][1] - float(least)) <= 1e-5 * float(least)


def test_pointobb2rbbox_matches_jax():
    """Every encoding through the pipeline builder against the JAX
    transform (cv2 inside), on the quads jittered below half a pixel."""
    quads = _quads()
    jitter = np.random.RandomState(4).uniform(-0.4, 0.4, (len(quads), 8))
    rb = (np.stack(quads).reshape(-1, 8) + jitter).astype(np.float32)
    for method in ("thetaobb", "hobb", "pointobb"):
        sample = dict(rbbox_fields=["gt_rbboxes"], gt_rbboxes=rb.copy())
        got = build_pipeline([dict(type="Pointobb2RBBox",
                                   encoding_method=method)])(
            copy.deepcopy(sample))["gt_rbboxes"]
        want = JAX_REG.get("Pointobb2RBBox")(method)(
            copy.deepcopy(sample))["gt_rbboxes"]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=method)


# ---------------------------------------------------------------------------
# RandomRotate
# ---------------------------------------------------------------------------

def _results(h=96, w=128, seed=0):
    """A results dict with every field RandomRotate moves."""
    r = np.random.RandomState(seed)
    xy = np.sort(r.uniform(0, min(h, w), (6, 2, 2)), axis=1)
    boxes = np.stack([xy[:, 0, 0], xy[:, 0, 1], xy[:, 1, 0], xy[:, 1, 1]],
                     -1).astype(np.float32)
    return dict(
        img=r.randint(0, 256, (h, w, 3)).astype(np.uint8), img_shape=(h, w),
        gt_bboxes=boxes, gt_footprint_bboxes=(boxes + 3).clip(0, w),
        proposals=boxes[:4] * 0.9,
        gt_masks=[[r.uniform(0, w, (6, 2)).astype(np.float32)],
                  [r.uniform(0, h, (4, 2)).astype(np.float32),
                   r.uniform(0, h, (5, 2)).astype(np.float32)]],
        gt_offsets=r.uniform(-20, 20, (6, 2)).astype(np.float32),
        gt_edge_maps=r.randint(0, 2, (h, w)).astype(np.uint8),
        edge_fields=["gt_edge_maps"],
        gt_side_face_maps=r.randint(0, 3, (h, w, 3)).astype(np.uint8),
        side_face_fields=["gt_side_face_maps"],
        gt_offset_field=r.uniform(-9, 9, (h, w, 2)).astype(np.float32),
        offset_field_fields=["gt_offset_field"])


def _same_results(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        if k == "_rng":
            assert a.get_state()[2] == b.get_state()[2]      # same draws
        elif k == "gt_masks":
            for pa, pb in zip(a, b):
                for x, y in zip(pa, pb):
                    assert x.dtype == y.dtype
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in ("gt_bboxes", "gt_footprint_bboxes", "proposals",
                     "gt_offsets"):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                           err_msg=k)
            else:                       # the image and the dense maps
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


@pytest.mark.parametrize("angles", [[90], [180], [270], [37], [123], [271],
                                    "any"])
def test_random_rotate_matches_jax(angles):
    """Built through the pipeline builder, three seeds (some of which do
    not rotate at ``rotate_ratio=0.6``)."""
    cfg = dict(type="RandomRotate", rotate_ratio=0.6, angles=angles)
    rotated = 0
    for seed in range(3):
        sample = _results(seed=seed)
        want = JAX_REG.get("RandomRotate")(rotate_ratio=0.6, angles=angles)(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        got = build_pipeline([cfg])(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        _same_results(got, want)
        rotated += not np.array_equal(got["img"], sample["img"])
    assert rotated > 0


def test_rotated_loader_matches_jax_process_loader(tmp_path):
    """The synthetic train pipeline with ``RandomRotate(rotate_ratio=1,
    angles='any')`` after ``RandomFlip``: the port's loader gives the JAX
    process loader's rows (image, boxes, masks, offsets), and the draws
    include arbitrary angles."""
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu.datasets.builder import build_dataloader as jax_loader
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    train = synth_train_cfg(synth_data(tmp_path, n=4, size=128)).data.train
    flip = [i for i, p in enumerate(train.pipeline)
            if p.type == "RandomFlip"][0]
    train.pipeline.insert(flip + 1, dict(type="RandomRotate",
                                         rotate_ratio=1.0, angles="any"))
    port = build_dataset(copy.deepcopy(train))
    ref = jax_build_dataset(copy.deepcopy(dict(train)))
    rotate = [t for t in port.pipeline.transforms
              if type(t).__name__ == "RandomRotate"][0]
    general = []
    plain = rotate._rotate_general
    rotate._rotate_general = lambda res, a: general.append(a) or plain(res, a)
    for i in range(len(port)):
        got = port.prepare(i, np.random.RandomState(i))
        want = ref.prepare(i, np.random.RandomState(i))
        for k in ("img", "gt_bboxes", "gt_offsets", "img_shape"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    del rotate._rotate_general
    assert general and any(a % 90 for a in general)
    got = build_dataloader(port, 2, workers_per_gpu=2, seed=5, max_gt=64,
                           loader_mode="process")
    want = jax_loader(ref, 2, workers_per_gpu=2, seed=5, max_gt=64,
                      loader_mode="process")
    try:
        a, b = list(got), list(want)
        assert len(a) == len(b) == 2
        for (ba, ma), (bb, mb) in zip(a, b):
            assert ba.keys() == bb.keys()
            for k in bb:
                np.testing.assert_array_equal(ba[k], bb[k], err_msg=k)
            assert [m["img_shape"] for m in ma] == \
                [m["img_shape"] for m in mb]
        assert any((ba["gt_valid"]).any() for ba, _ in a)
    finally:
        got.close()
        want._pool.shutdown()


# ---------------------------------------------------------------------------
# the rotated-box coder and anchors
# ---------------------------------------------------------------------------

def test_delta_rbbox_coder_matches_jax():
    import jax.numpy as jnp
    from bonai_tpu.core.boxes import DeltaRBBoxCoder as JaxCoder
    from bonai_tpu_torch.core.boxes import BBOX_CODERS, build_bbox_coder
    assert "DeltaRBBoxCoder" in BBOX_CODERS
    r = np.random.RandomState(0)
    props = np.stack([r.uniform(50, 200, 64), r.uniform(50, 200, 64),
                      r.uniform(10, 60, 64), r.uniform(10, 60, 64),
                      r.uniform(-1, 1, 64)], -1).astype(np.float32)
    gts = props + np.stack(
        [r.uniform(-5, 5, 64), r.uniform(-5, 5, 64), r.uniform(-2, 2, 64),
         r.uniform(-2, 2, 64), r.uniform(-0.2, 0.2, 64)],
        -1).astype(np.float32)
    gts[:4, 2:4] = 0                                  # clamped to eps
    kw = dict(target_means=(0.1, -0.1, 0.0, 0.05, 0.0),
              target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
    coder = build_bbox_coder(dict(type="DeltaRBBoxCoder", **kw))
    ref = JaxCoder(**kw)
    d = coder.encode(torch.from_numpy(props), torch.from_numpy(gts))
    d_ref = np.asarray(ref.encode(jnp.asarray(props), jnp.asarray(gts)))
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-5, atol=1e-5)
    deltas = r.uniform(-3, 3, (64, 5)).astype(np.float32)   # dw/dh clipped
    np.testing.assert_allclose(
        coder.decode(torch.from_numpy(props), torch.from_numpy(deltas)),
        np.asarray(ref.decode(jnp.asarray(props), jnp.asarray(deltas))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(strides=[8], ratios=[1.0], scales=[4], angles=[0, 45, 90]),
    dict(strides=[4, 8, 16], ratios=[0.5, 1.0, 2.0], scales=[8],
         angles=[-30, 0, 30, 60]),
    dict(strides=[8, 16], ratios=[1.0, 2.0], octave_base_scale=4,
         scales_per_octave=3, angles=[0, 90], center_offset=0.5)])
def test_ranchor_generator_matches_jax(kw):
    from bonai_tpu.core.anchors import RAnchorGenerator as JaxGenerator
    from bonai_tpu_torch.core.anchors import RAnchorGenerator
    got, want = RAnchorGenerator(**kw), JaxGenerator(**kw)
    for a, b in zip(got.base_anchors, want.base_anchors):
        assert a.shape[1] == 5
        np.testing.assert_array_equal(a, b)
    sizes = [(5, 7), (3, 4), (2, 2)][:len(kw["strides"])]
    for a, b in zip(got.grid_anchors(sizes), want.grid_anchors(sizes)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loft_refuses_offset_types_neither_package_defines():
    """The JAX LOFT reads any offset head type but ``OffsetHeadExpandFeature``
    as the plain head and ignores the coder's type; the port builds the two
    heads and every coder both packages register (the rotated-box coder
    among them), and refuses any other name with ``ValueError`` naming
    it.  No message of the port names item A5 any more."""
    import os
    from bonai_tpu.core.boxes import BBOX_CODERS as JAX_CODERS
    from bonai_tpu_torch.core.boxes import BBOX_CODERS
    from bonai_tpu_torch.models import build_detector
    from torch_port_common import LOFT_CONFIG, ROOT, tiny_cfg
    assert set(BBOX_CODERS.module_dict) == set(JAX_CODERS.module_dict)
    for key, value, ok in (("type", "OffsetHead", True),
                           ("type", "OffsetHeadExpandFeature", True),
                           ("type", "RoIOffsetHead", False),
                           ("offset_coder", dict(type="DeltaRBBoxCoder"),
                            True),
                           ("offset_coder", dict(type="DeltaXYZCoder"),
                            False)):
        cfg = tiny_cfg(config=LOFT_CONFIG)
        cfg.model.roi_head.offset_head[key] = value
        if ok:
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
            continue
        name = value["type"] if isinstance(value, dict) else value
        with pytest.raises(ValueError, match=name):
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    for d, _, files in os.walk(os.path.join(ROOT, "bonai_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert "A5" not in fh.read(), f
