"""LOFT with polar offsets in bonai_tpu_torch against the JAX package, at
``torch_port_common.polar_cfg``'s tiny widths (the head of
``tests/test_polar_offsets.py::_polar_cfg``: the plain ``OffsetHead``
regressing ``(length, cos, sin)``, ``DeltaPolarOffsetCoder``) in float32 on
the CPU: the coder and its ``reg_num=3`` round trip, the head,
``simple_test`` (the angle from ``arctan2``, only the length divided by the
scale factor), one training step's losses and every gradient with JAX's
draws, and the train pipeline with ``OffsetTransform('xy2la')`` after the
flip.

Tolerances: coder, head and ``simple_test`` outputs and gradients 1e-4 of
their largest magnitude; each loss 1e-4 relative; the pipeline exact.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (LOFT_CONFIG, jax_forward_train_draws,
                               jax_model, polar_cfg, port_model, synth_data,
                               t, train_batch)

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)


def _close(got, ref, what, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(
        float(np.abs(ref).max()), 1e-12), err_msg=what)


@pytest.fixture(scope="module")
def models():
    cfg = polar_cfg(train=True)
    jm, variables = jax_model(cfg)
    return cfg, jm, variables, port_model(cfg, variables)


def test_coder_matches_jax():
    """Encode and decode (with and without ``max_shape``) against the JAX
    coder, and the ``reg_num=3`` round trip: ``(length, cos, sin)`` of the
    encoded pair decodes, through ``arctan2``, to the polar offset."""
    from bonai_tpu.core.boxes import DeltaPolarOffsetCoder as JaxCoder
    from bonai_tpu_torch.core.boxes import build_bbox_coder
    r = np.random.RandomState(0)
    xy = r.uniform(0, 90, (40, 2))
    boxes = np.concatenate([xy, xy + r.uniform(1, 60, (40, 2))],
                           -1).astype(np.float32)
    polar = np.stack([r.uniform(0, 40, 40), r.uniform(-3.1, 3.1, 40)],
                     -1).astype(np.float32)
    for means, stds in (((0.0, 0.0), (0.5, 0.5)), ((0.1, -0.2), (0.3, 2.0))):
        coder = build_bbox_coder(dict(type="DeltaPolarOffsetCoder",
                                      target_means=means, target_stds=stds))
        ref = JaxCoder(means, stds)
        enc = coder.encode(t(boxes), t(polar))
        _close(enc.numpy(), ref.encode(boxes, polar), "encode")
        for shape in (None, (64, 48)):
            _close(coder.decode(t(boxes), enc, shape).numpy(),
                   ref.decode(boxes, np.asarray(enc), shape), "decode")
        reg3 = torch.stack([enc[:, 0], torch.cos(enc[:, 1]),
                            torch.sin(enc[:, 1])], -1)
        dec = coder.decode(t(boxes), torch.stack(
            [reg3[:, 0], torch.atan2(reg3[:, 2], reg3[:, 1])], -1))
        # arctan2 gives back the encoded angle where it lies within pi
        keep = np.abs((polar[:, 1] - means[1]) / stds[1]) < np.pi
        assert keep.sum() > 10
        _close(dec.numpy()[keep], polar[keep], "round trip")


def test_config_builds_and_foa_refuses_polar():
    """The full-width ``polar`` derivation builds the plain head with three
    outputs; the FOA head with polar offsets raises JAX's refusal."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.models.roi_heads.offset_heads import OffsetHead
    cfg = Config.fromfile(LOFT_CONFIG)
    cfg.model.roi_head.offset_head.update(
        reg_num=3, offset_coordinate="polar",
        offset_coder=dict(type="DeltaPolarOffsetCoder"))
    with torch.device("meta"):
        m = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert isinstance(m.roi_head["offset_head"], OffsetHead)
    assert m.roi_head["offset_head"].fc_offset.weight.shape == (3, 1024)
    assert m.offset_coordinate == "polar" and m.offset_reg_num == 3
    foa = polar_cfg()
    foa.model.roi_head.offset_head.type = "OffsetHeadExpandFeature"
    with pytest.raises(ValueError, match="pair with the plain OffsetHead"):
        build_detector(foa.model, foa.train_cfg, foa.test_cfg)


def test_offset_head_matches_jax(models):
    _, jm, variables, pm = models
    x = np.random.RandomState(1).randn(29, 7, 7, 16).astype(np.float32)
    ref = jm.apply(variables, x, method=lambda m, x: m.offset_head_m(x))
    with torch.no_grad():
        got = pm.roi_head["offset_head"](t(x))
    assert got.shape == (29, 3)
    _close(got.numpy(), ref, "offset head")


def test_simple_test_matches_jax(models):
    _, jm, variables, pm = models
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref)
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() >= 4
    for k in ref:
        if k != "det_valid":
            _close(got[k].numpy()[valid], np.asarray(ref[k])[valid], k)
    # the angle is the std-scaled arctan2 output
    assert np.abs(got["offsets"].numpy()[..., 1]).max() <= np.pi * 0.5 + 1e-5


@pytest.fixture(scope="module")
def trained(models):
    """JAX's and the port's losses and gradients of one batch whose
    offsets are polar, as ``OffsetTransform('xy2la')`` leaves them."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables, _ = models
    batch = train_batch()
    o = batch["gt_offsets"]
    batch["gt_offsets"] = np.stack([np.hypot(o[..., 0], o[..., 1]),
                                    np.arctan2(o[..., 1], o[..., 0])],
                                   -1).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method="forward_train",
                          rngs={"sampling": key})
        return sum(losses.values()), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"], batch)
    ref_grads = state_dict_from_jax(jax.device_get(grads),
                                    variables["batch_stats"])
    pm = port_model(cfg, variables)
    got = pm.forward_train({k: t(v) for k, v in batch.items()},
                           jax_forward_train_draws(jm, variables, key, 2))
    sum(got.values()).backward()
    return (jax.device_get(ref), {k: float(v.detach()) for k, v in
                                  got.items()}, ref_grads, pm)


def test_forward_train_losses_match_jax(trained):
    ref, got, _, _ = trained
    assert set(got) == set(ref) and got["loss_offset"] > 0
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax(trained):
    _, _, ref_grads, pm = trained
    for name, p in pm.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_grads[name].numpy(), name)
    assert float(pm.roi_head["offset_head"].fc_offset.weight.grad.abs()
                 .max()) > 0


def test_train_pipeline_matches_jax(tmp_path):
    """The polar train pipeline (``OffsetTransform('xy2la')`` after
    ``RandomFlip``) on four synthetic tiles against the JAX pipeline,
    exact, flipped and not: polar offsets of the flipped vectors."""
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.datasets import build_dataset
    data = synth_data(tmp_path, n=4, size=128)
    train = polar_cfg(train=True).data.train
    train.update(ann_file=f"{data}/train/train.json",
                 img_prefix=f"{data}/train/images/")
    train.pipeline[2].img_scale = (128, 128)
    assert [p["type"] for p in train.pipeline][3:5] == ["RandomFlip",
                                                     "OffsetTransform"]
    port = build_dataset(copy.deepcopy(train))
    ref = jax_build_dataset(copy.deepcopy(dict(train)))
    flips = set()
    for i in range(4):
        got = port.prepare(i, np.random.RandomState(i))
        want = ref.prepare(i, np.random.RandomState(i))
        flips.add(got["flip_direction"])
        for k in ("img", "gt_bboxes", "gt_offsets"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["gt_offsets"].dtype == np.float32
        assert (got["gt_offsets"][:, 0] >= 0).all()
    assert len(flips) > 1
