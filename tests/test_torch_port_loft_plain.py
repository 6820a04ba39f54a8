"""LOFT with the plain ``OffsetHead``
(``configs/loft/loft_r50_fpn_2x_bonai.py``) in bonai_tpu_torch against the
JAX package, at the tiny widths of
``torch_port_common`` in float32 on the CPU: the head alone, the
detector's ``simple_test``, its ``forward_train`` losses and every
gradient, and the weight keys of the new head.

Tolerances: the head's output 1e-4 of its largest magnitude; detections as
in ``test_torch_port_detector.py`` (boxes and offsets 1e-3 px, scores and
mask probabilities 1e-4); each loss 1e-4 relative and each gradient 1e-4
of its tensor's largest magnitude, as in ``test_torch_port_train.py``.
"""

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (CONFIG, LOFT_CONFIG, jax_forward_train_draws,
                               jax_model, port_model, t, tiny_cfg,
                               tiny_train_cfg, train_batch)

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_train_cfg(LOFT_CONFIG)
    jm, variables = jax_model(cfg)
    return cfg, jm, variables, port_model(cfg, variables)


def test_config_builds_the_plain_head():
    """The shipped config at full width: the plain head, its SmoothL1
    weight 16 and the FOA config's coder defaults."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.models.roi_heads.offset_heads import OffsetHead
    cfg = Config.fromfile(LOFT_CONFIG)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    head = model.roi_head["offset_head"]
    assert isinstance(head, OffsetHead) and not model.foa
    assert [c.weight.shape for c in head.convs] == [(256, 256, 3, 3)] * 4
    assert [f.weight.shape for f in head.fcs] == [(1024, 256 * 49),
                                                  (1024, 1024)]
    assert head.fc_offset.weight.shape == (2, 1024)
    assert model.offset_loss == dict(type="SmoothL1Loss", loss_weight=16.0)
    assert (model.offset_coder_means, model.offset_coder_stds) == (
        (0.0, 0.0), (0.5, 0.5))


def test_polar_offsets_name_the_roadmap_item():
    """Polar offsets (ROADMAP.md item A5, ported): the plain head builds
    with them, and the FOA head with them raises the JAX detector's
    refusal (``test_torch_port_polar.py`` holds them to JAX)."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(LOFT_CONFIG)
    cfg.model.roi_head.offset_head.offset_coordinate = "polar"
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert model.offset_coordinate == "polar" and not model.foa
    foa = Config.fromfile(CONFIG)
    foa.model.roi_head.offset_head.offset_coordinate = "polar"
    with pytest.raises(ValueError, match="pair with the plain OffsetHead"):
        build_detector(foa.model, foa.train_cfg, foa.test_cfg)


def test_offset_head_matches_jax(models):
    _, jm, variables, pm = models
    x = np.random.RandomState(1).randn(37, 7, 7, 16).astype(np.float32)
    ref = np.asarray(jm.apply(variables, x,
                              method=lambda m, x: m.offset_head_m(x)))
    with torch.no_grad():
        got = pm.roi_head["offset_head"](t(x)).numpy()
    assert got.shape == ref.shape == (37, 2)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_simple_test_matches_jax(models):
    _, jm, variables, pm = models
    from test_torch_port_detector import _compare
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref)
    _compare(got, jax.device_get(ref))


@pytest.fixture(scope="module")
def trained(models):
    """JAX's and the port's losses and gradients of one batch, once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables, _ = models
    batch = train_batch()
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
    assert set(got) == set(ref)
    assert got["loss_offset"] > 0
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax(trained):
    _, _, ref_grads, pm = trained
    trainable = 0
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        trainable += 1
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert trainable > 50
    for conv in pm.roi_head["offset_head"].convs:
        assert float(conv.weight.grad.abs().max()) > 0


def test_weight_keys_of_the_plain_head():
    """``state_dict_from_jax`` gives the plain head mmdet's keys
    (``convs.<i>``, ``fcs.<i>``, ``fc_offset``) and the port loads them
    strictly and gives them back unchanged (the convs' round trip).  The
    JAX importer reads every other key back exactly, the head's FCs
    included, and leaves the head's convs, which it does not map, as they
    were (ROADMAP.md queue C).  256-channel heads: the importer's first-FC
    reorder assumes C=256."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = tiny_cfg(config=LOFT_CONFIG)
    m = cfg.model
    m.neck.out_channels = 256
    m.rpn_head.update(in_channels=256, feat_channels=32)
    m.roi_head.bbox_head.in_channels = 256
    m.roi_head.mask_head.in_channels = 256
    m.roi_head.offset_head.update(in_channels=256, conv_out_channels=256,
                                  num_convs=2)
    _, variables = jax_model(cfg)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    head = sorted(k[len("roi_head.offset_head."):] for k in sd
                  if k.startswith("roi_head.offset_head."))
    assert head == sorted([f"{mod}.{i}.{w}" for mod in ("convs", "fcs")
                           for i in range(2) for w in ("bias", "weight")]
                          + ["fc_offset.bias", "fc_offset.weight"])
    pm = port_model(cfg, variables)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats = mmdet_checkpoint_to_params(
        {k: v.numpy() for k, v in sd.items()}, zeros["params"],
        zeros["batch_stats"])
    got = jax.tree_util.tree_leaves_with_path({"params": params,
                                               "batch_stats": stats})
    ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(got) == len(ref)
    unmapped = 0
    for path, leaf in got:
        name = jax.tree_util.keystr(path)
        if "offset_head" in name and "'conv" in name:
            assert not np.any(leaf), name       # left at its zeros
            unmapped += 1
        else:
            np.testing.assert_array_equal(np.asarray(leaf), ref[path],
                                          err_msg=name)
    assert unmapped == 4                        # 2 convs, kernel and bias
