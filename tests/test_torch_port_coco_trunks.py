"""The COCO recipes' trunk, neck and R-CNN head options in bonai_tpu_torch
against the JAX package, on the CPU with the same seeded JAX variables
carried across by ``state_dict_from_jax``:

- two tiny Mask R-CNNs (``torch_port_common.trunk_cfg``), in float32:
  ``x_caffe``, the caffe config's trunk (stride on the 1x1 ``conv1``, the
  BN affine behind a gradient stop) as a ResNeXt of 4 groups, and
  ``gn_ws``, GN and ConvWS through the trunk, the FPN,
  ``Shared4Conv1FCBBoxHead`` and the mask head.  Each option's tests hold
  the detector's ``simple_test`` and one training step's losses, and the
  gradients: ``x_caffe``'s every one, the option's own among them;
  ``gn_ws``'s module by module in float64, since that chain's float32
  gradients are ill-conditioned (ROADMAP.md, "Gradients near a ReLU's
  kink"; ``test_gn_ws_backbone_float32_gradients_are_ill_conditioned``);
- SyncBN (frozen like BN), the FPN with GN and ConvWS with and without
  ``no_norm_on_lateral``, and the grid head's GroupNorm(36), module by
  module: outputs, and the gradients of a random projection of them;
- a ``requires_grad=False`` affine after 3 SGD steps, weights through an
  mmdet ``.pth`` with the ``gn*`` names and the JAX importer, parameter
  counts of full-width configs against ``jax.eval_shape``, and the
  392-config sweep.

Tolerances: detections as in ``test_torch_port_rcnn.py`` (boxes 1e-3 px,
scores and mask probabilities 1e-4, labels and validity exact); losses
1e-4 relative; every float32 gradient 1e-4 of its tensor's largest
magnitude, every float64 one 1e-6; module outputs in float32 1e-5 of
their largest value, 1e-4 through a GroupNorm (flax takes its variance
as E[x^2] - E[x]^2, torch in two passes).  The steps run at LR 0.02,
weight decay 1e-2 and the BONAI recipes' clip at 35, so that the
decay-only update of a frozen affine is far above float32 rounding and
random weights do not diverge in 3 steps.
"""

import glob
import os.path as osp
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_port_rcnn import IMG_SHAPE, SCALE, compare_detections
import torch_port_common as tpc
from torch_port_common import (ROOT, _random_tree, jax_forward_train_draws,
                               jax_model, meta_device, port_model, t,
                               train_batch, trunk_cfg)

LR, WD, MAX_NORM, STEPS = 0.02, 1e-2, 35.0, 3
GN4 = dict(type="GN", num_groups=4, requires_grad=True)
WS = dict(type="ConvWS")
# an option -> its tiny detector and the parameters that carry it
OPTIONS = {
    "resnext": ("x_caffe", r"backbone\.layer\d\.\d+\.conv2\.weight"),
    "caffe": ("x_caffe", r"backbone\.layer[234]\.0\.conv1\.weight"),
    "bn_requires_grad_false": (
        "x_caffe", r"backbone\.layer[234].*(bn\d|downsample\.1)\."),
    "gn": ("gn_ws", r"backbone\.layer\d\.\d+\.gn\d\."),
    "convws": ("gn_ws", r"backbone\.layer\d\.\d+\.conv\d\.weight"),
    "fpn_gn_ws": ("gn_ws", r"neck\.(lateral|fpn)_convs\.\d\.(conv|gn)\."),
    "shared4conv1fc_gn_ws": ("gn_ws", r"roi_head\.bbox_head\.shared_convs\."),
    "fcn_mask_gn_ws": ("gn_ws", r"roi_head\.mask_head\.convs\.")}
# the GN + ConvWS chain's float32 gradients are ill-conditioned (the
# port's own lie more than 1e-3 off its float64 ones): its options'
# gradients are held module by module in float64, each option to its
# module's
GN_WS_MODULE = {"gn": "backbone", "convws": "backbone",
                "fpn_gn_ws": "neck", "shared4conv1fc_gn_ws": "bbox_head",
                "fcn_mask_gn_ws": "mask_head"}

_MODELS, _RUNS = {}, {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` at the training sizes,
    built once."""
    if family not in _MODELS:
        cfg = trunk_cfg(family, train=True)
        _MODELS[family] = (cfg, *jax_model(cfg))
    return _MODELS[family]


def _close(got, want, tol, what=""):
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _jax_steps(cfg, jm, variables, batch, key):
    """JAX's losses and gradients of the first of ``STEPS`` steps (the
    optax chain over the JAX frozen mask, clipped at ``MAX_NORM``; the same
    sampler key each step) and the weights after the last, as the port's
    state dicts."""
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    params, stats = variables["params"], variables["batch_stats"]
    tx = jax_optimizer(dict(type="SGD", lr=LR, momentum=0.9,
                            weight_decay=WD), lambda count: LR,
                       dict(max_norm=MAX_NORM), frozen_mask_from_model(
                           params, cfg.model.backbone.frozen_stages))

    def total(p, batch):
        losses = jm.apply({"params": p, "batch_stats": stats}, batch,
                          method="forward_train", rngs={"sampling": key})
        return sum(losses.values()), losses

    @jax.jit
    def step(p, state, batch):
        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(
            p, batch)
        updates, state = tx.update(grads, state, p)
        return losses, grads, optax.apply_updates(p, updates), state
    p, state = params, tx.init(params)
    for i in range(STEPS):
        out = jax.device_get(step(p, state, batch))
        if i == 0:
            losses, grads = out[:2]
        p, state = out[2:]
    return (losses, state_dict_from_jax(grads, stats),
            state_dict_from_jax(p, stats))


def _port_steps(cfg, jm, variables, batch, key):
    """The port's ``STEPS`` steps from the JAX variables with JAX's draws:
    the first step's metrics, the gradients ``apply_gradients`` receives
    there, the model after the last and the parameters the optimizer
    holds."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from bonai_tpu_torch.engine import train_step as train_step_module
    pm = port_model(cfg, variables).train()
    tb = {k: t(v) for k, v in batch.items()}
    optimizer = build_optimizer(pm, dict(type="SGD", lr=LR, momentum=0.9,
                                         weight_decay=WD))
    grads = {}
    update = train_step_module.apply_gradients

    def recording(opt, lr, max_norm=None):
        if not grads:
            grads.update({n: None if p.grad is None else p.grad.clone()
                          for n, p in pm.named_parameters()})
        return update(opt, lr, max_norm)
    train_step_module.apply_gradients = recording
    try:
        step = make_train_step(pm, optimizer, lambda s: LR,
                               max_norm=MAX_NORM)
        metrics = [step(tb, i, jax_forward_train_draws(jm, variables, key, 2))
                   for i in range(STEPS)]
    finally:
        train_step_module.apply_gradients = update
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return dict(got=metrics[0], grads=grads, pm=pm,
                trained={n for n, p in pm.named_parameters()
                         if id(p) in held})


def run(family):
    """``simple_test`` and the training steps of ``family`` in both
    packages, run once."""
    if family not in _RUNS:
        cfg, jm, variables = models(family)
        pm = port_model(cfg, variables)
        image = np.random.RandomState(1).randn(2, 128, 128, 3).astype(
            np.float32)
        ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
            v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE,
            SCALE)
        with torch.no_grad():
            got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
        batch, key = train_batch(size=128), jax.random.PRNGKey(5)
        ref_losses, ref_grads, ref_after = _jax_steps(cfg, jm, variables,
                                                      batch, key)
        _RUNS[family] = dict(serve=(got, ref), ref_losses=ref_losses,
                             ref_grads=ref_grads, ref_after=ref_after,
                             **_port_steps(cfg, jm, variables, batch, key))
    return _RUNS[family]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_simple_test_matches_jax(option):
    family, pattern = OPTIONS[option]
    got, ref = run(family)["serve"]
    assert set(got) == set(ref) == {"det_bboxes", "det_scores", "det_labels",
                                    "det_valid", "mask_probs"}
    compare_detections(got, ref)
    sd = run(family)["pm"].state_dict()
    assert any(re.match(pattern, k) for k in sd), pattern


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_train_step_matches_jax(option):
    """The first step's losses, and the gradients: of every trainable
    tensor of ``x_caffe`` (the BN affine behind the gradient stop gets
    none, JAX zeros, but stays in the optimizer), the option's own among
    them; of the GN + ConvWS option's module in float64 (``GN_WS_MODULE``,
    ``_module_float64``: the module on seeded inputs, in both packages,
    within 1e-6 of each gradient's largest magnitude)."""
    family, pattern = OPTIONS[option]
    r = run(family)
    for k, v in r["ref_losses"].items():
        got = float(r["got"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, float(v), rtol=1e-4, err_msg=k)
    if family == "gn_ws":
        assert _module_float64(GN_WS_MODULE[option], pattern) > 0
        return
    own = 0
    for name in sorted(r["trained"]):
        want, got = r["ref_grads"][name].numpy(), r["grads"][name]
        if got is None:
            assert re.match(OPTIONS["bn_requires_grad_false"][1], name), name
            assert not want.any(), name
        else:
            _close(got.numpy(), want, 1e-4, name)
        own += re.match(pattern, name) is not None
    assert own > 0


def test_requires_grad_false_affine_after_three_steps_equals_jax():
    """The caffe trunk's BN affine behind the gradient stop (layer2-4; the
    stem and layer1 are frozen) after 3 steps: moved by weight decay and
    momentum alone, as optax moves it, its zero-gradient biases too."""
    r = run("x_caffe")
    pattern = OPTIONS["bn_requires_grad_false"][1]
    names = [n for n in r["trained"] if re.match(pattern, n)]
    assert len(names) == 2 * 3 * (4 + 6 + 3) + 2 * 3  # + the downsamples'
    params = dict(r["pm"].named_parameters())
    start = port_model(*models("x_caffe")[::2]).state_dict()
    for name in names:
        want = r["ref_after"][name].numpy()
        assert r["grads"][name] is None, name
        assert not np.array_equal(want, start[name].numpy()), name
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# modules: SyncBN, the FPN's norms, the grid head's GroupNorm
# ---------------------------------------------------------------------------

def _vjp_match(jax_fn, variables, port_fn, inputs, tol, r):
    """The outputs of ``jax_fn(variables, *inputs)`` and ``port_fn(*inputs)``
    (tuples of NHWC maps) within ``tol``, and the inputs' gradients of
    ``sum(out * c)`` for seeded cotangents ``c``; returns JAX's parameter
    gradients of it (a flax tree)."""
    outs, vjp = jax.vjp(lambda p, *x: jax_fn({**variables, "params": p}, *x),
                        variables["params"], *inputs)
    cot = tuple(r.randn(*np.shape(o)).astype(np.asarray(o).dtype)
                for o in outs)
    grads = vjp(cot)
    xs = [t(x).requires_grad_() for x in inputs]
    got = port_fn(*xs)
    sum((g * t(c)).sum() for g, c in zip(got, cot)).backward()
    for i, (g, o) in enumerate(zip(got, outs)):
        _close(g.detach().numpy(), o, tol, f"output {i}")
    for x, want in zip(xs, grads[1:]):
        _close(x.grad.numpy(), want, tol, "input gradient")
    return jax.device_get(grads[0])


def _grads_match(module, sd, prefix, tol):
    """Every parameter gradient of ``module`` against ``sd`` (JAX's, by
    the port's keys under ``prefix``)."""
    n = 0
    for name, p in module.named_parameters():
        _close(p.grad.numpy(), sd[f"{prefix}.{name}"].numpy(), tol, name)
        n += 1
    return n


def _variables(jax_module, r, *inputs):
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *inputs)
    return {k: _random_tree(v, r) for k, v in shapes.items()}


def _nhwc(outs):
    return tuple(o.permute(0, 2, 3, 1) for o in outs)


_F64 = {}


def _module_float64(part, pattern):
    """The ``gn_ws`` detector's ``part`` (``'backbone'``, its stem and first
    two stages without frozen stages; ``'neck'``; ``'bbox_head'``;
    ``'mask_head'``) in float64 in both packages, on seeded inputs and
    variables: its outputs, the
    gradients of its inputs and of every parameter of ``sum(out * c)``
    for seeded cotangents ``c``, within 1e-6 of each one's largest
    magnitude (the heads' float32 outputs, in both packages, within
    their rounding), run once.  Returns how many of its parameters (by
    the detector's keys) match ``pattern``."""
    if part not in _F64:
        _F64[part] = _run_module_float64(part)
    return sum(re.match(pattern, k) is not None for k in _F64[part])


def _run_module_float64(part):
    from bonai_tpu.models.detectors.builders import build_backbone_m
    from bonai_tpu.models.necks.fpn import FPN as JaxFPN
    from bonai_tpu.models.roi_heads.bbox_head import Shared2FCBBoxHead
    from bonai_tpu.models.roi_heads.mask_head import FCNMaskHead
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = trunk_cfg("gn_ws", train=True)
    r = np.random.RandomState(7)
    mh = cfg.model.roi_head.mask_head
    with jax.enable_x64(True):
        f64 = jnp.float64
        if part == "backbone":              # its first two stages
            bk = dict(cfg.model.backbone, frozen_stages=-1, num_stages=2,
                      out_indices=(0, 1))
            jm = build_backbone_m(bk, f64)
            module = build_detector(dict(cfg.model, backbone=bk)).backbone
            inputs = [r.randn(2, 64, 64, 3)]
            port_fn = lambda x: _nhwc(module(x.permute(0, 3, 1, 2)))
            jax_fn = jm.apply
        elif part == "neck":
            jm = JaxFPN(in_channels=(32, 64, 128, 256), out_channels=16,
                        num_outs=5, norm_cfg=GN4, conv_cfg=WS, dtype=f64)
            module = build_detector(cfg.model).neck
            inputs = [r.randn(2, s, s, c) for s, c in ((16, 32), (8, 64),
                                                       (4, 128), (2, 256))]
            port_fn = lambda *x: _nhwc(module([f.permute(0, 3, 1, 2)
                                               for f in x]))
            jax_fn = lambda v, *x: jm.apply(v, x)
        elif part == "bbox_head":
            jm = Shared2FCBBoxHead(
                num_classes=1, in_channels=16, fc_out_channels=32,
                num_shared_convs=4, num_shared_fcs=1, conv_out_channels=16,
                norm_cfg=GN4, conv_cfg=WS, dtype=f64)
            module = build_detector(cfg.model).roi_head["bbox_head"]
            inputs = [r.randn(6, 7, 7, 16)]
            port_fn, jax_fn = module, jm.apply
        else:
            jm = FCNMaskHead(num_convs=mh.num_convs, in_channels=16,
                             conv_out_channels=16,
                             num_classes=mh.num_classes, norm_cfg=GN4,
                             conv_cfg=WS, dtype=f64)
            module = build_detector(cfg.model).roi_head["mask_head"]
            inputs = [r.randn(6, 14, 14, 16)]
            port_fn = lambda x: (module(x).permute(0, 2, 3, 1),)
            jax_fn = lambda v, x: (jm.apply(v, x),)
        prefix = {"bbox_head": "roi_head.bbox_head",
                  "mask_head": "roi_head.mask_head"}.get(part, part)

        def tree(p):
            return {"backbone": {}, "neck": {}, **{part: p}}
        variables = _variables(jm, r, *(
            [tuple(inputs)] if part == "neck" else inputs))
        sd = state_dict_from_jax(tree(variables["params"]), {})
        module.load_state_dict({k[len(prefix) + 1:]: v
                                for k, v in sd.items()})
        module.double()
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                           variables)
        grads = _vjp_match(jax_fn, variables, port_fn, inputs, 1e-6, r)
    _grads_match(module, state_dict_from_jax(tree(grads), {}), prefix, 1e-6)
    return [f"{prefix}.{n}" for n, _ in module.named_parameters()]


def test_gn_ws_backbone_float32_gradients_are_ill_conditioned():
    """Why the GN + ConvWS gradients are held module by module in float64
    (ROADMAP.md, "Gradients near a ReLU's kink"): on the ``gn_ws`` trunk
    the port's own float32 parameter gradients lie more than 1e-3 of a
    tensor's largest value off its float64 ones (JAX's float32 ones too;
    the float64 ones of both packages agree, ``_module_float64``)."""
    import copy
    from bonai_tpu.models.detectors.builders import build_backbone_m
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = trunk_cfg("gn_ws")
    bk = dict(cfg.model.backbone, frozen_stages=-1)
    pm = build_detector(dict(cfg.model, backbone=bk)).backbone
    r = np.random.RandomState(3)
    img = r.randn(2, 3, 128, 128)
    variables = _variables(build_backbone_m(bk, jnp.float32), r,
                           img.transpose(0, 2, 3, 1).astype(np.float32))
    sd = state_dict_from_jax({"backbone": variables["params"], "neck": {}},
                             {})
    pm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    cot = [r.randn(2, c, s, s) for c, s in ((32, 32), (64, 16), (128, 8),
                                            (256, 4))]

    def grads(m, dtype):
        out = m(t(img).to(dtype))
        sum((o * t(c).to(dtype)).sum() for o, c in zip(out, cot)).backward()
        return {n: p.grad.double() for n, p in m.named_parameters()}
    p64 = grads(copy.deepcopy(pm).double(), torch.float64)
    p32 = grads(pm, torch.float32)
    assert max(float((p32[n] - p64[n]).abs().max() / p64[n].abs().max())
               for n in p64) > 1e-3


def test_syncbn_backbone_matches_jax():
    """SyncBN is BN over stored statistics, under DDP too (no
    ``nn.SyncBatchNorm``): a ResNet-18 at base 8 with ``norm_cfg=dict(
    type='SyncBN')``, its stages and every gradient."""
    from bonai_tpu.models.detectors.builders import build_backbone_m
    from bonai_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
    from bonai_tpu_torch.models.detectors.two_stage import _build_backbone
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = dict(type="ResNet", depth=18, base_channels=8, frozen_stages=-1,
               norm_cfg=dict(type="SyncBN", requires_grad=True))
    r = np.random.RandomState(3)
    img = r.randn(2, 64, 64, 3).astype(np.float32)
    jm, pm = build_backbone_m(cfg, jnp.float32), _build_backbone(cfg)
    assert not any(isinstance(m, torch.nn.SyncBatchNorm)
                   for m in pm.modules())
    assert sum(isinstance(m, FrozenBatchNorm2d) for m in pm.modules()) == 20
    variables = _variables(jm, r, img)
    stats = {"backbone": variables["batch_stats"]}
    sd = state_dict_from_jax({"backbone": variables["params"], "neck": {}},
                             stats)
    pm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    grads = _vjp_match(jm.apply, variables,
                       lambda x: _nhwc(pm(x.permute(0, 3, 1, 2))), [img],
                       1e-5, r)
    sd = state_dict_from_jax({"backbone": grads, "neck": {}}, stats)
    assert _grads_match(pm, sd, "backbone", 1e-4) == 60


@pytest.mark.parametrize("no_norm_on_lateral", [False, True],
                         ids=["lateral_norm", "no_norm_on_lateral"])
def test_fpn_gn_ws_matches_jax(no_norm_on_lateral):
    """The FPN with GN and ConvWS (the nas_fpn crop640 configs' laterals
    without a norm): no bias where a norm follows, mmcv's ``.gn`` names,
    the levels and every gradient."""
    from bonai_tpu.models.necks.fpn import FPN as JaxFPN
    from bonai_tpu_torch.models.necks.fpn import FPN
    from bonai_tpu_torch.ops.layers import ConvWS2d
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    opts = dict(norm_cfg=dict(type="GN", num_groups=4),
                conv_cfg=dict(type="ConvWS"),
                no_norm_on_lateral=no_norm_on_lateral)
    r = np.random.RandomState(4)
    feats = tuple(r.randn(2, s, s, c).astype(np.float32)
                  for s, c in ((16, 8), (8, 16), (4, 32), (2, 64)))
    jm = JaxFPN(in_channels=(8, 16, 32, 64), out_channels=16, num_outs=5,
                **opts)
    pm = FPN((8, 16, 32, 64), 16, 5, **opts)
    keys = set(pm.state_dict())
    assert ("lateral_convs.0.gn.weight" in keys) != no_norm_on_lateral
    assert ("lateral_convs.0.conv.bias" in keys) == no_norm_on_lateral
    assert "fpn_convs.3.gn.bias" in keys and "fpn_convs.3.conv.bias" \
        not in keys
    assert all(isinstance(m.conv, ConvWS2d)
               for m in [*pm.lateral_convs, *pm.fpn_convs])
    variables = _variables(jm, r, feats)
    sd = state_dict_from_jax({"backbone": {}, "neck": variables["params"]},
                             {})
    pm.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    grads = _vjp_match(lambda v, *x: jm.apply(v, x), variables,
                       lambda *x: _nhwc(pm([f.permute(0, 3, 1, 2)
                                            for f in x])),
                       list(feats), 1e-4, r)
    sd = state_dict_from_jax({"backbone": {}, "neck": grads}, {})
    assert _grads_match(pm, sd, "neck", 1e-4) == (
        20 if no_norm_on_lateral else 24)


def test_grid_head_gn_matches_jax():
    """The gn-head configs' grid head: ``norm_cfg=dict(type='GN',
    num_groups=36)`` is the JAX grid head's own GroupNorm and builds (any
    other raises A7); its fused and unfused heatmaps and every gradient
    against the JAX head's."""
    from bonai_tpu.models.roi_heads.grid_head import GridHead as JaxHead
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = Config.fromfile(osp.join(
        ROOT, "configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_1x_coco.py"))
    gh = cfg.model.roi_head.grid_head
    assert gh.norm_cfg == dict(type="GN", num_groups=36)
    gh.update(num_convs=2, in_channels=16, point_feat_channels=8)
    cfg.model.roi_head.grid_roi_extractor.out_channels = 16
    pm = build_detector(cfg.model).roi_head["grid_head"]
    jm = JaxHead(num_convs=2, in_channels=16, point_feat_channels=8)
    r = np.random.RandomState(6)
    x = r.randn(6, 14, 14, 16).astype(np.float32)
    variables = _variables(jm, r, x)
    key = "roi_head.grid_head"
    sd = state_dict_from_jax({"backbone": {}, "neck": {},
                              "grid_head": variables["params"]}, {})
    pm.load_state_dict({k[len(key) + 1:]: v for k, v in sd.items()})

    def jax_fn(v, x):
        out = jm.apply(v, x, train=True)
        return out["fused"], out["unfused"]

    def port_fn(x):
        out = pm(x, unfused=True)
        return _nhwc((out["fused"], out["unfused"]))
    grads = _vjp_match(jax_fn, variables, port_fn, [x], 1e-4, r)
    sd = state_dict_from_jax({"backbone": {}, "neck": {},
                              "grid_head": grads}, {})
    assert _grads_match(pm, sd, key, 1e-4) > 50
    gh.norm_cfg = dict(type="GN", num_groups=32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A7"):
        build_detector(cfg.model)


# ---------------------------------------------------------------------------
# weights, parameter counts, the config sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["x_caffe", "gn_ws"])
def test_weight_round_trip(family, tmp_path):
    """JAX variables -> ``state_dict_from_jax`` -> an mmdet ``.pth`` ->
    ``load_mmdet_checkpoint`` -> ``mmdet_state_dict`` -> the port's model,
    exactly, every key used: ResNeXt's grouped ``conv2``, mmcv's ``gn1``
    (stem and blocks), ``downsample.1``, the FPN's and the heads'
    ``.gn``, ``shared_convs``/``shared_fcs.0`` and no conv bias before a
    norm; an mmdet GN checkpoint with its ``num_batches_tracked``-free
    keys loads with strict keys."""
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import (load_mmdet_checkpoint,
                                               mmdet_state_dict,
                                               state_dict_from_jax)
    cfg, _, variables = models(family)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    torch.save({"state_dict": sd}, tmp_path / "m.pth")
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    loaded = mmdet_state_dict(model, load_mmdet_checkpoint(
        str(tmp_path / "m.pth")))
    assert set(loaded) == set(model.state_dict())
    model.load_state_dict(loaded, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    if family == "x_caffe":
        assert tuple(sd["backbone.layer1.0.conv2.weight"].shape) == (
            8, 2, 3, 3)
        assert model.backbone.layer2[0].conv1.stride == (2, 2)
        return
    for key in ("backbone.gn1.weight", "backbone.layer1.0.gn3.bias",
                "backbone.layer2.0.downsample.1.weight",
                "neck.lateral_convs.0.gn.weight", "neck.fpn_convs.3.gn.bias",
                "roi_head.bbox_head.shared_convs.3.gn.weight",
                "roi_head.bbox_head.shared_fcs.0.weight",
                "roi_head.mask_head.convs.0.gn.bias"):
        assert key in sd, key
    assert not [k for k in sd if re.search(r"running_|bn\d|\.bn\.", k)]
    assert not [k for k in sd if re.search(
        r"(lateral_convs|fpn_convs|shared_convs|mask_head\.convs)\.\d+"
        r"\.conv\.bias", k)]
    assert "roi_head.bbox_head.shared_fcs.1.weight" not in sd


def test_jax_importer_on_the_coco_checkpoints():
    """``bonai_tpu.utils.torch_import.mmdet_checkpoint_to_params`` reads
    the caffe ResNeXt checkpoint whole (its grouped ``conv2`` and
    ``requires_grad=False`` BN are ResNet-shaped; heads at the importer's
    256 channels), exactly the inverse of ``state_dict_from_jax``; on a GN
    checkpoint it raises ``KeyError`` (it reads every norm as a BatchNorm
    with statistics; ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = trunk_cfg("x_caffe")
    m = cfg.model
    m.neck.out_channels = m.rpn_head.in_channels = 256
    for k in ("bbox_roi_extractor", "mask_roi_extractor"):
        m.roi_head[k].out_channels = 256
    for k in ("bbox_head", "mask_head"):
        m.roi_head[k].in_channels = 256
    _, variables = jax_model(cfg)
    r = np.random.RandomState(2)
    start = {k: _random_tree(v, r) for k, v in variables.items()}
    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        variables["params"], variables["batch_stats"]).items()}
    params, stats = mmdet_checkpoint_to_params(sd, start["params"],
                                               start["batch_stats"])
    got = state_dict_from_jax(params, stats)
    assert set(got) == set(sd)
    for k, v in got.items():
        assert np.array_equal(v.numpy(), sd[k]), k
    gn_variables = models("gn_ws")[2]
    gn_sd = {k: v.numpy() for k, v in state_dict_from_jax(
        gn_variables["params"], gn_variables["batch_stats"]).items()}
    with pytest.raises(KeyError, match="bn1"):
        mmdet_checkpoint_to_params(gn_sd, gn_variables["params"],
                                   gn_variables["batch_stats"])


# full-width configs, one of each kind the slice builds
COUNTED = ("mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py",
           "faster_rcnn/faster_rcnn_x101_64x4d_fpn_1x_coco.py",
           "faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py",
           "gn+ws/mask_rcnn_x50_32x4d_fpn_gn_ws-all_2x_coco.py",
           "regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py",
           "cornernet/cornernet_hourglass104_mstest_8x6_210e_coco.py")


@pytest.mark.parametrize("config", COUNTED, ids=lambda c: c.split("/")[0])
def test_full_width_parameter_counts_equal_jax(config):
    """The port's parameters (built on the meta device) against the JAX
    detector's ``jax.eval_shape`` params, in number and in total size."""
    from bonai_tpu.models import build_detector as jax_build
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(osp.join(ROOT, "configs", config))
    jm = jax_build(cfg.model, cfg.train_cfg, cfg.test_cfg,
                   compute_dtype="float32")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    with torch.device("meta"):
        pm = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    params = list(pm.parameters())
    assert len(params) == len(leaves)
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(x.shape)) for x in leaves)


# every config of the sweep that stays unported, by the ROADMAP item its
# error names
UNPORTED = {"A6": 13}


def test_configs_build_340_of_392():
    """Every config under ``configs/`` (``_base_/`` excluded) builds on the
    meta device with its ``train_cfg``, whose R-CNN options the detector
    checks as it is built (so a config that builds also trains), but 13,
    each of which raises ``NotImplementedError`` naming A6 (none a
    ``KeyError`` or ``TypeError``): 379 of 392 (340 when the test was
    named, before item 6's A7 part; 359 before its A6 dense-head half).
    The three C4 configs, GRoIE, the deformable pooling packs, Libra's COCO
    samplers, OHEM, the IoU losses and the four PISA R-CNNs among the
    built, and Guided Anchoring's RetinaNets and RPN-only detectors, the
    legacy v1.x configs, Libra's and PISA's RetinaNets and the two
    crop640 NAS-FPN configs."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    built, raised = [], {}
    for path in sorted(glob.glob(osp.join(ROOT, "configs", "**", "*.py"),
                                 recursive=True)):
        name = osp.relpath(path, osp.join(ROOT, "configs"))
        if name.startswith("_base_"):
            continue
        cfg = Config.fromfile(path)
        try:
            with meta_device():
                build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
            built.append(name)
        except NotImplementedError as e:
            raised[name] = re.search(r"ROADMAP.md item (A\d)", str(e))[1]
    assert len(built) + len(raised) == 392
    assert len(built) == 379
    assert {k: sum(v == k for v in raised.values())
            for k in set(raised.values()) | set(UNPORTED)} == UNPORTED
    for kind in ("x101", "caffe_fpn", "gn_ws", "gn-all", "gn-head",
                 "syncbn", "regnetx", "hourglass", "caffe_c4", "groie",
                 "dpool", "mdpool", "ohem", "giou", "bounded_iou",
                 "libra_faster_rcnn_r50_fpn_1x_coco", "pisa_faster_rcnn",
                 "pisa_mask_rcnn", "ga_retinanet", "ga_rpn", "_v1",
                 "libra_retinanet", "pisa_retinanet", "crop640"):
        assert any(kind in n for n in built), kind


@pytest.mark.parametrize("config,rcnn", [
    ("cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py",
     dict(isr=dict(k=2, bias=0))),
    ("cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py",
     dict(sampler=dict(type="OHEMSampler", num=512))),
    ("mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py",
     dict(sampler=dict(type="RandomSampler", num=512,
                       add_gt_as_proposals=False))),
    ("libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py",
     dict(sampler=dict(type="CombinedSampler", num=512,
                       pos_sampler=dict(type="InstanceBalancedPosSampler"),
                       neg_sampler=dict(type="OHEMSampler"))))],
    ids=["cascade-isr", "cascade-ohem", "no-gt-proposals",
         "combined-ohem-neg"])
def test_refused_rcnn_train_options_raise_at_build(config, rcnn):
    """A config whose ``train_cfg.rcnn`` carries an option the port's step
    would refuse raises A7 when the detector is built, as the PISA R-CNN
    configs did at their first step before their port (the sweep builds
    with the train config): PISA on a cascade (the JAX cascade reads
    neither ``isr`` nor ``carl``), a hard-mining sampler in a cascade's
    stage, ``add_gt_as_proposals=False``, a combined sampler's unported
    negative sampler."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(osp.join(ROOT, "configs", config))
    stages = cfg.train_cfg.rcnn if isinstance(
        cfg.train_cfg.rcnn, (list, tuple)) else [cfg.train_cfg.rcnn]
    for stage in stages:
        stage.update(rcnn)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A7"):
        with torch.device("meta"):
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    with torch.device("meta"):          # the serving model builds
        build_detector(cfg.model, None, cfg.test_cfg)
