"""LOFT-FOA on HRNet + HRFPN (``configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py``)
in bonai_tpu_torch against the JAX package, at tiny widths
(``torch_port_common.TINY_HRNET_EXTRA``: one module of one block a stage,
branches of 8/16/32/64 channels, a 16-channel HRFPN) in float32 on the
CPU, with the same seeded JAX variables carried across by
``state_dict_from_jax``.

Tolerances: every backbone branch and HRFPN level within 1e-5 of its
largest magnitude; detections as in ``test_torch_port_detector.py``
(boxes and offsets 1e-3 px, scores and mask probabilities 1e-4); one
training step's losses to 1e-4 relative and every parameter's update to
1e-4 of its tensor's largest update.  The step runs at LR 1 and weight
decay 1e-2 (the config's 0.02 and 1e-4 would make the decay-only update of
``conv2``/``bn2`` about 2e-6 of the weight, below float32 rounding of the
weight itself).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (HRNET_CONFIG, TINY_HRNET_EXTRA,
                               jax_forward_train_draws, jax_model,
                               port_model, t, tiny_cfg, tiny_train_cfg,
                               train_batch)

IMG_SHAPE = np.array([[128, 128], [112, 120]], np.float32)
SCALE = np.array([1.0, 0.9], np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_train_cfg(HRNET_CONFIG)
    jm, variables = jax_model(cfg)
    return cfg, jm, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def features(models):
    """The JAX and the port's backbone branches and HRFPN levels (NHWC) of
    one 128^2 batch."""
    from bonai_tpu.models.backbones.hrnet import HRNet
    from bonai_tpu.models.necks.hrfpn import HRFPN
    cfg, _, variables, pm = models
    img = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    p, s = variables["params"], variables["batch_stats"]
    branches = HRNet(extra=TINY_HRNET_EXTRA, frozen_stages=1).apply(
        {"params": p["backbone"], "batch_stats": s["backbone"]}, img)
    levels = HRFPN(in_channels=(8, 16, 32, 64), out_channels=16).apply(
        {"params": p["neck"]}, branches)
    with torch.no_grad():
        got_b = pm.backbone(t(img).permute(0, 3, 1, 2).contiguous())
        got_l = pm.neck(got_b)
    nhwc = [tuple(x.permute(0, 2, 3, 1).numpy() for x in xs)
            for xs in (got_b, got_l)]
    return dict(branch=(jax.device_get(branches), nhwc[0]),
                level=(jax.device_get(levels), nhwc[1]))


@pytest.mark.parametrize("kind,i", [("branch", i) for i in range(4)]
                         + [("level", i) for i in range(5)])
def test_features_match_jax(features, kind, i):
    """Backbone branch ``i`` (finest first) or HRFPN level ``i``."""
    ref, got = (x[i] for x in features[kind])
    assert got.shape == ref.shape
    assert got.shape[1] == 32 >> i
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_simple_test_matches_jax(models):
    from test_torch_port_detector import _compare
    _, jm, variables, pm = models
    image = np.random.RandomState(1).randn(2, 128, 128, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) >= {"mask_probs", "offsets"}
    _compare(got, jax.device_get(ref))


LR, WD = 1.0, 1e-2


@pytest.fixture(scope="module")
def step(models):
    """One training step of both packages from the same weights, batch and
    sampler draws: the JAX optax chain over its frozen mask, and the port's
    ``make_train_step``.  Returns the losses and the updated weights."""
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables, _ = models
    params, stats = variables["params"], variables["batch_stats"]
    batch = train_batch(size=128)
    key = jax.random.PRNGKey(5)
    opt_cfg = dict(type="SGD", lr=LR, momentum=0.9, weight_decay=WD)
    max_norm = cfg.optimizer_config.grad_clip.max_norm

    def total(p, batch):
        losses = jm.apply({"params": p, "batch_stats": stats}, batch,
                          method="forward_train", rngs={"sampling": key})
        return sum(losses.values()), losses

    (_, ref_losses), grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(params, batch)
    tx = jax_optimizer(opt_cfg, lambda count: LR, dict(max_norm=max_norm),
                       frozen_mask_from_model(
                           params, cfg.model.backbone.frozen_stages))
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = state_dict_from_jax(jax.device_get(optax.apply_updates(
        params, updates)), stats)

    pm = port_model(cfg, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    train_step = make_train_step(pm, build_optimizer(pm, opt_cfg),
                                 lambda s: LR, max_norm=max_norm)
    got = train_step({k: t(v) for k, v in batch.items()}, 0,
                     jax_forward_train_draws(jm, variables, key, 2))
    return dict(ref_losses=jax.device_get(ref_losses), got=got, ref=ref,
                before=before, pm=pm)


def test_train_step_losses_match_jax(step):
    ref, got = step["ref_losses"], step["got"]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        assert np.isfinite(float(got[k])) and float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)


def test_train_step_updates_match_jax(step):
    """Every parameter's update against optax's: the frozen ``conv1``,
    ``bn1`` and ``layer1`` do not move; ``conv2``/``bn2``, behind the
    gradient stop after ``layer1``, move by weight decay alone (their
    zero-valued BN bias not at all); every other tensor by its gradient."""
    pm, ref, before = step["pm"], step["ref"], step["before"]
    trained = 0
    for name, p in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (p.detach() - before[name]).numpy()
        if not p.requires_grad:
            assert name.startswith(("backbone.conv1.", "backbone.bn1.",
                                    "backbone.layer1.")), name
            assert not want.any() and not moved.any(), name
            continue
        trained += 1
        if name.startswith(("backbone.conv2.", "backbone.bn2.")):
            decay = -LR * WD * before[name].numpy()
            np.testing.assert_allclose(want, decay, rtol=1e-3, atol=1e-9,
                                       err_msg=name)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(moved, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert trained > 100
    assert float((pm.backbone.conv2.weight.detach()
                  - before["backbone.conv2.weight"]).abs().max()) > 0


def test_weight_keys_are_mmdet_hrnet_keys():
    """The full-width config's ``state_dict`` carries mmdet v2.3's HRNet-W32
    and HRFPN keys: the stem, a transition of a changed and of a new
    branch, a branch block, the fuse paths from a coarser and from a finer
    branch, and the HRFPN convs."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(HRNET_CONFIG)
    sd = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg).state_dict()
    shapes = {
        "backbone.conv1.weight": (64, 3, 3, 3),
        "backbone.bn2.running_var": (64,),
        "backbone.layer1.0.downsample.0.weight": (256, 64, 1, 1),
        "backbone.layer1.3.conv3.weight": (256, 64, 1, 1),
        "backbone.transition1.0.0.weight": (32, 256, 3, 3),
        "backbone.transition1.0.1.bias": (32,),
        "backbone.transition1.1.0.0.weight": (64, 256, 3, 3),
        "backbone.transition1.1.0.1.running_mean": (64,),
        "backbone.transition3.3.0.0.weight": (256, 128, 3, 3),
        "backbone.stage2.0.branches.1.3.conv2.weight": (64, 64, 3, 3),
        "backbone.stage3.3.branches.2.0.bn1.weight": (128,),
        "backbone.stage4.2.fuse_layers.0.3.0.weight": (32, 256, 1, 1),
        "backbone.stage4.2.fuse_layers.0.3.1.running_var": (32,),
        "backbone.stage4.2.fuse_layers.3.0.0.0.weight": (32, 32, 3, 3),
        "backbone.stage4.2.fuse_layers.3.0.2.0.weight": (256, 32, 3, 3),
        "backbone.stage4.2.fuse_layers.3.0.2.1.bias": (256,),
        "neck.reduction_conv.conv.weight": (256, 480, 1, 1),
        "neck.reduction_conv.conv.bias": (256,),
        "neck.fpn_convs.4.conv.weight": (256, 256, 3, 3),
    }
    for key, shape in shapes.items():
        assert tuple(sd[key].shape) == shape, key
    bk = [k for k in sd if k.startswith("backbone.")]
    assert not [k for k in bk if ".transition2.0." in k
                or ".transition2.1." in k or ".fuse_layers.1.1." in k]
    assert len({k.split(".")[1] for k in bk}) == 11     # stem, layer1, t, s
    assert not [k for k in sd if k.startswith("neck.")
                and not k.startswith(("neck.reduction_conv.conv.",
                                      "neck.fpn_convs."))]


def test_the_config_builds_and_trains_what_jax_trains(models):
    """The port's optimizer holds exactly the parameters the JAX frozen mask
    leaves trainable: everything but ``conv1``/``bn1`` and ``layer1``."""
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.engine import build_optimizer
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables, pm = models
    params = variables["params"]
    mask = jax.tree_util.tree_map(
        lambda f, p: np.full(p.shape, float(f), np.float32),
        frozen_mask_from_model(params, cfg.model.backbone.frozen_stages),
        params)
    frozen = {k for k, v in state_dict_from_jax(
        mask, variables["batch_stats"]).items()
        if not k.endswith(("running_mean", "running_var"))
        and bool(torch.as_tensor(v).all())}
    opt = build_optimizer(pm, cfg.optimizer)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    trained = {n for n, p in pm.named_parameters() if id(p) in held}
    assert trained == {n for n, _ in pm.named_parameters()} - frozen
    assert "backbone.conv2.weight" in trained
    assert "backbone.layer1.0.conv1.weight" not in trained


def test_other_backbones_and_neck_options_name_their_item():
    from bonai_tpu_torch.models import build_detector
    cfg = tiny_cfg(config=HRNET_CONFIG)
    cfg.model.backbone.type = "HourglassNet"
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    cfg = tiny_cfg(config=HRNET_CONFIG)
    cfg.model.neck.pooling_type = "MAX"
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)

