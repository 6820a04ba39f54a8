"""The serving slice of bonai_tpu_torch as a whole against the JAX
package: ``simple_test`` of the tiny LOFT-FOA model with the same weights
and images, the R-CNN stage on the same proposals, and the entry points.

Valid detections (boxes, scores, labels), mask probabilities and offsets
are compared slot by slot (both sort by score with ties in index order):
boxes and offsets to 1e-3 px, scores and mask probabilities to 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import CONFIG, jax_model, port_model, t, tiny_cfg

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    jm, variables = jax_model(cfg)
    return cfg, jm, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)


def _compare(got, ref):
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    for key, tol in (("det_bboxes", 1e-3), ("det_scores", 1e-4),
                     ("mask_probs", 1e-4), ("offsets", 1e-3)):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy()[valid],
                                   np.asarray(ref[key])[valid], rtol=1e-4,
                                   atol=tol, err_msg=key)


def test_simple_test_matches_jax(models, image):
    _, jm, variables, pm = models
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref)
    _compare(got, jax.device_get(ref))


def test_rcnn_stage_matches_jax_on_same_proposals(models, image):
    """The R-CNN stage alone, fed the same FPN features and proposals."""
    _, jm, variables, pm = models
    r = np.random.RandomState(3)
    xy = r.uniform(0, 70, (2, 40, 2))
    wh = r.uniform(6, 40, (2, 40, 2))
    props = np.concatenate([xy, np.minimum(xy + wh, 96)], -1)
    props = props.astype(np.float32)
    pvalid = r.uniform(size=(2, 40)) > 0.15

    def stage(m, img, p, v, s, f):
        return m._rcnn_simple_test(m.extract_feat(img), p, v, s, f)

    ref = tpc.jax_call(lambda *a: jm.apply(variables, *a, method=stage),
                       image, props, pvalid, IMG_SHAPE, SCALE)
    feats = tpc.jax_call(lambda i: jm.apply(
        variables, i, method="extract_feat"), image)
    with torch.inference_mode():
        got = pm._rcnn_simple_test([t(f) for f in feats], t(props),
                                   t(pvalid), t(IMG_SHAPE), t(SCALE))
    _compare(got, jax.device_get(ref))


def test_init_detector_without_a_gpu_raises(monkeypatch):
    from bonai_tpu_torch.apis import init_detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_detector(CONFIG)


def test_build_detector_names_the_roadmap_item_for_unported_types():
    """Every detector type of the JAX registry is ported; an unported head
    option of a ported type names its item (FoveaBox's ``with_deform``,
    A6; ``RetinaSepBNHead``, which this test refused until it was
    ported, builds since item 6's A6 dense-head half)."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.POINT_CONFIGS["fovea"])
    cfg.model.bbox_head.with_deform = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)


def test_inference_detector_on_cpu():
    """init_detector -> inference_detector on one BGR image and on a batch
    of two: the reference result layout, finite, masks in the original
    image size."""
    from bonai_tpu_torch.apis import inference_detector, init_detector
    cfg = tiny_cfg()
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = init_detector(cfg, device="cpu", dtype=torch.float32, seed=1)
    r = np.random.RandomState(4)
    img = r.randint(0, 255, (60, 90, 3), np.uint8)
    bbox, segm, offsets = inference_detector(model, img)
    assert len(bbox) == len(segm) == 1
    assert bbox[0].shape[1] == 5 and len(segm[0]) == len(bbox[0])
    assert offsets.shape == (len(bbox[0]), 2)
    assert np.isfinite(bbox[0]).all() and np.isfinite(offsets).all()
    assert all(m["size"] == [60, 90] for m in segm[0])
    batch = inference_detector(model, [img, img[:40]])
    assert len(batch) == 2
    np.testing.assert_allclose(batch[0][0][0], bbox[0], rtol=1e-5,
                               atol=1e-4)


def test_init_detector_loads_an_mmdet_checkpoint(tmp_path):
    """An mmdet-style ``.pth`` (meta + state_dict with BatchNorm's
    ``num_batches_tracked``) loads as it is."""
    from bonai_tpu_torch.apis import init_detector
    cfg = tiny_cfg()
    src = init_detector(cfg, device="cpu", dtype=torch.float32, seed=3)
    sd = dict(src.state_dict())
    sd["backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "loft.pth"
    torch.save({"meta": {"mmdet_version": "2.3.0",
                         "CLASSES": ("building",)}, "state_dict": sd}, path)
    model = init_detector(cfg, checkpoint=str(path), device="cpu",
                          dtype=torch.float32, seed=0)
    ref = src.state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, ref[key]), key
