"""The R-CNN trunk variants on BONAI in bonai_tpu_torch against the JAX
package, each a tiny detector built from its config
(``torch_port_common.trunk_cfg``): the DCNv2, GCNet, Res2Net and
RegNetX-3.2GF Mask R-CNNs and the generalized-attention and PAFPN Faster
R-CNNs, in float32 on the CPU with the same seeded JAX variables carried
across by ``state_dict_from_jax``.

Tolerances: detections as in ``test_torch_port_rcnn.py`` (boxes 1e-3 px,
scores and mask probabilities 1e-4, labels and validity exact); one
training step's losses to 1e-4 relative, every gradient (before the clip)
to 1e-4 of its tensor's largest magnitude, every parameter's update to
1e-4 of its tensor's largest update.  The step runs at LR 1 and weight
decay 1e-2, as ``test_torch_port_hrnet.py``'s, so that the Res2Net stem's
decay-only update is well above float32 rounding.  Where an input of the
box head's ReLUs lies within float noise of 0 and the two packages take
the two sides of the kink, the port's step is run again with JAX's side
(see ``step``).
"""

import numpy as np
import optax
import pytest
import torch

import jax
from test_torch_port_rcnn import IMG_SHAPE, SCALE, compare_detections
import torch_port_common as tpc
from torch_port_common import (TRUNK_CONFIGS, jax_forward_train_draws,
                               jax_model, port_model, t, train_batch,
                               trunk_cfg)

FAMILIES = sorted(TRUNK_CONFIGS)
LR, WD = 1.0, 1e-2

_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` at the training sizes,
    built once."""
    if family not in _MODELS:
        cfg = trunk_cfg(family, train=True)
        _MODELS[family] = (cfg, *jax_model(cfg))
    return _MODELS[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_simple_test_matches_jax(family):
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(1).randn(2, 128, 128, 3).astype(
        np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    masks = family not in ("attention", "pafpn")
    assert set(got) == set(ref) == {"det_bboxes", "det_scores",
                                    "det_labels", "det_valid"} | (
        {"mask_probs"} if masks else set())
    compare_detections(got, ref)


def _jax_step(cfg, jm, variables, batch, key, max_norm):
    """JAX's losses, gradients and updated weights (as the port's state
    dicts) of one step: the optax chain over the JAX frozen mask."""
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    params, stats = variables["params"], variables["batch_stats"]

    def total(p, batch):
        losses = jm.apply({"params": p, "batch_stats": stats}, batch,
                          method="forward_train", rngs={"sampling": key})
        return sum(losses.values()), losses

    mask = frozen_mask_from_model(params, cfg.model.backbone.frozen_stages)
    tx = jax_optimizer(dict(type="SGD", lr=LR, momentum=0.9,
                            weight_decay=WD), lambda count: LR,
                       dict(max_norm=max_norm) if max_norm else None, mask)

    def step(p, batch):
        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(
            p, batch)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, grads, optax.apply_updates(p, updates)
    losses, grads, new = tpc.jax_call(step, params, batch, fast=not any(
        k.startswith("mask_head") for k in params))
    frozen = jax.tree_util.tree_map(
        lambda f, p: np.full(np.shape(p), float(f), np.float32), mask,
        params)
    return (losses, state_dict_from_jax(grads, stats),
            state_dict_from_jax(new, stats),
            {k for k, v in state_dict_from_jax(frozen, stats).items()
             if not k.endswith(("running_mean", "running_var"))
             and bool(v.all())})


def _jax_fc_inputs(jm, variables, batch, key):
    """The inputs of the JAX box head's two ReLUs in its training
    forward."""
    def run(v, b):
        return jm.apply(v, b, method="forward_train", rngs={"sampling": key},
                        capture_intermediates=lambda m, _: m.name in (
                            "shared_fc1", "shared_fc2"),
                        mutable=["intermediates"])[1]
    inter = jax.device_get(jax.jit(run)(variables, batch))
    head = inter["intermediates"]["bbox_head"]
    return [np.asarray(head[k]["__call__"][0])
            for k in ("shared_fc1", "shared_fc2")]


def _port_step(cfg, jm, variables, batch, key, max_norm, ties=None):
    """The port's step from the JAX variables: its model before and after,
    the metrics, the gradients ``apply_gradients`` receives (before the
    clip), the parameters the optimizer holds and the inputs of the box
    head's two ReLUs.  ``ties``: ``{(fc, row, unit): value}`` inputs set
    to JAX's value before their ReLU."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from bonai_tpu_torch.engine import train_step as train_step_module
    pm = port_model(cfg, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    optimizer = build_optimizer(pm, dict(type="SGD", lr=LR, momentum=0.9,
                                         weight_decay=WD))
    grads, fc_inputs = {}, []

    def hook(j):
        def fix(m, i, o):
            fc_inputs.append(o.detach().clone())
            shift = torch.zeros_like(o)
            for (fc, row, unit), v in (ties or {}).items():
                if fc == j:             # a constant shift: the gradient
                    shift[row, unit] = v - o[row, unit].detach()   # stays
            return o + shift
        return fix
    for j, fc in enumerate(pm.roi_head["bbox_head"].shared_fcs):
        fc.register_forward_hook(hook(j))
    update = train_step_module.apply_gradients

    def recording(opt, lr, max_norm=None):
        grads.update({n: None if p.grad is None else p.grad.clone()
                      for n, p in pm.named_parameters()})
        return update(opt, lr, max_norm)
    train_step_module.apply_gradients = recording
    try:
        got = make_train_step(pm, optimizer, lambda s: LR,
                              max_norm=max_norm)(
            {k: t(v) for k, v in batch.items()}, 0,
            jax_forward_train_draws(jm, variables, key, 2))
    finally:
        train_step_module.apply_gradients = update
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return dict(got=got, grads=grads, pm=pm, before=before,
                fc_inputs=fc_inputs,
                trained={n for n, p in pm.named_parameters()
                         if id(p) in held})


@pytest.fixture(scope="module", params=FAMILIES)
def step(request):
    """One training step of both packages from the same weights, batch and
    sampler draws.  An input of the box head's ReLUs within float noise
    of 0 (1e-5 of the largest) on which the two packages take the two
    sides of the kink is first shown to be such a near-tie (the two
    values within 1e-5 of the largest), then set to JAX's value in a
    second run of the port's step: the gradients upstream of that ReLU
    would otherwise differ by that unit's whole term."""
    family = request.param
    cfg, jm, variables = models(family)
    grad_clip = cfg.optimizer_config.get("grad_clip")
    max_norm = grad_clip.max_norm if grad_clip else None
    batch = train_batch(size=128)
    key = jax.random.PRNGKey(5)
    ref_losses, ref_grads, ref, frozen = _jax_step(cfg, jm, variables,
                                                   batch, key, max_norm)
    run = _port_step(cfg, jm, variables, batch, key, max_norm)
    near = [(j, row, unit) for j, o in enumerate(run["fc_inputs"])
            for row, unit in torch.nonzero(
                o.abs() < 1e-5 * o.abs().max()).tolist()]
    ties = {}
    if near:
        jax_inputs = _jax_fc_inputs(jm, variables, batch, key)
        for j, row, unit in near:
            mine = float(run["fc_inputs"][j][row, unit])
            theirs = float(jax_inputs[j][row, unit])
            top = float(np.abs(jax_inputs[j]).max())
            assert abs(mine - theirs) <= 1e-5 * top, (j, row, unit)
            if (mine > 0) != (theirs > 0):
                ties[j, row, unit] = theirs
    if ties:
        run = _port_step(cfg, jm, variables, batch, key, max_norm, ties)
    return dict(family=family, ref_losses=ref_losses, ref_grads=ref_grads,
                ref=ref, frozen=frozen, ties=ties, **run)


def test_train_step_losses_match_jax(step):
    ref, got = step["ref_losses"], step["got"]
    assert set(ref) <= set(got)
    assert {"loss_mask" in ref} == {step["family"] not in ("attention",
                                                           "pafpn")}
    for k, v in ref.items():
        assert np.isfinite(float(got[k])) and float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_jax(step):
    """Every trainable tensor's gradient before the clip.  The softmax
    pooling bias of a context block (``conv_mask.bias``) shifts every
    logit alike: its gradient is 0 but for float noise.  The Res2Net stem,
    behind the gradient stop, gets none (JAX: zeros)."""
    pm, ref, grads = step["pm"], step["ref_grads"], step["grads"]
    top = max(float(v.abs().max()) for v in ref.values())
    checked = 0
    for name, p in pm.named_parameters():
        if name not in step["trained"]:
            continue
        want, got = ref[name].numpy(), grads[name]
        if got is None:
            assert name.startswith("backbone.stem."), name
            assert not want.any(), name
            continue
        got = got.numpy()
        if name.endswith("conv_mask.bias"):
            assert max(np.abs(want).max(), np.abs(got).max()) <= 1e-5 * top
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        checked += 1
    assert checked > 60


def test_train_step_updates_match_jax(step):
    """Every parameter's update against optax's over the JAX frozen mask:
    the optimizer holds exactly what the mask leaves trainable; the stem
    (but Res2Net's deep stem) and ``layer1`` do not move; Res2Net's stem,
    behind the gradient stop after the max-pool, moves by weight decay
    alone (its zero-valued BN biases not at all); every other tensor by
    its gradient."""
    pm, ref, before = step["pm"], step["ref"], step["before"]
    names = {n for n, _ in pm.named_parameters()}
    assert step["trained"] == names - step["frozen"]
    assert not {n for n in step["frozen"]
                if not n.startswith(("backbone.conv1.", "backbone.bn1.",
                                     "backbone.layer1."))}
    stem = 0
    for name, p in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (p.detach() - before[name]).numpy()
        if name not in step["trained"]:
            assert not want.any() and not moved.any(), name
            continue
        if name.endswith("conv_mask.bias"):
            # weight decay and a gradient of float noise (see above)
            top = max(float(v.abs().max()) for v in step["ref_grads"].values())
            np.testing.assert_allclose(moved, want, rtol=0,
                                       atol=1e-5 * LR * top, err_msg=name)
            continue
        if name.startswith("backbone.stem."):
            decay = -LR * WD * before[name].numpy()
            np.testing.assert_allclose(want, decay, rtol=1e-3, atol=1e-9,
                                       err_msg=name)
            stem += 1
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(moved, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    assert stem == (9 if step["family"] == "res2net" else 0)
