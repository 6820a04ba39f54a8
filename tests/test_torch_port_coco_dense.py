"""Item 6's A6 dense-head and anchor half in bonai_tpu_torch against the
JAX package, in float32 on the CPU, at the tiny widths of
``torch_port_common.coco_dense_cfg``: Guided Anchoring's RetinaNet
(``GARetinaHead``) and RPN-only detector, mmdetection v1.x's anchors
(``LegacyAnchorGenerator``) and coder in the legacy Mask and Cascade Mask
R-CNNs, ``RetinaSepBNHead`` on a NAS-FPN with ``norm_cfg``, Libra's
balanced-L1 and PISA's RetinaNets.

Served (GA RetinaNet, the GA RPN-only detector, the legacy Mask R-CNN):
head outputs, ``simple_test`` (the GA RPN-only detector's proposals);
stepped (all eight): every loss and every gradient with JAX's draws (GA
RetinaNet's shape sampler from the unsplit ``sampling`` key; the GA
RPN-only detector's from it and from it folded with 1: the JAX
``RPN.forward_train`` cannot run a ``GARPNHead``, so its reference is the
JAX ``ga_rpn_loss`` on the JAX module's outputs and that key).  The JAX
references compile at XLA's lowest optimisation level but for the mask
families' steps (``torch_port_common.jax_call``).  Weights:
``state_dict_from_jax`` both ways, mmdetection's SepBN layout (each shared
conv repeated under every level) and its four-group GA offsets.

Tolerances: head outputs 1e-5 of their largest value, detections 1e-3 px
(``compare_detections``), losses 1e-4 relative, gradients 1e-4 of their
tensor's largest element; anchors, valid flags and weights exact.
"""

import numpy as np
import pytest
import torch

import jax
import torch_port_common as tpc
from test_torch_port_rcnn import compare_detections
from test_torch_port_rcnn_a7 import ZERO_GRADS
from torch_port_common import (coco_dense_cfg, jax_call,
                               jax_forward_train_draws, jax_model, port_model,
                               t, train_batch)

# the JAX module's square input for each family (NAS-FPN's P7 needs 224)
SIZE = {"ga_rpn": 96, "legacy_mask": 96, "legacy_cascade": 96,
        "sepbn_nasfpn": 224}
KEY = jax.random.PRNGKey(5)
# the dense heads' output convs whose weights are cut by 10 (their decoded
# boxes stay near their anchors)
REG_OUTPUTS = ("retina_reg", "conv_shape")

_MODELS = {}


def _size(family):
    return SIZE.get(family, 160)


def models(family):
    """``(cfg, JAX model, variables, port model)`` of ``family`` at its
    training sizes, built once."""
    if family not in _MODELS:
        cfg = coco_dense_cfg(family, train=True)
        jm, variables = jax_model(cfg, seed=3, init_size=_size(family))
        head = variables["params"].get("bbox_head", {})
        for name in REG_OUTPUTS:
            if name in head:
                head[name]["kernel"] *= 0.1
        _MODELS[family] = (cfg, jm, variables, port_model(cfg, variables))
    return _MODELS[family]


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


def _inputs(family, seed=1):
    size = _size(family)
    image = np.random.RandomState(seed).randn(2, size, size, 3).astype(
        np.float32)
    shape = np.array([[size, size], [size - 16, size - 6]], np.float32)
    return image, shape, np.array([1.0, 0.8], np.float32)


def _batch(family):
    """The tiny training batch; 3-class labels for the RetinaNets."""
    batch = train_batch(seed=2, size=_size(family))
    if models(family)[0].model.type == "RetinaNet":
        batch["gt_labels"] = np.random.RandomState(2).randint(
            0, 3, batch["gt_labels"].shape).astype(np.int32)
    return batch


# ---------------------------------------------------------------------------
# the configs, the anchors and the weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(tpc.COCO_DENSE_CONFIGS))
def test_configs_build_at_full_width(family):
    """Each shipped config on the meta device: GA RetinaNet's head with
    mmdetection's keys (one offset group a feature adaption), the GA
    RPN-only detector, the legacy anchors and coders, the SepBN head's
    per-level norms under one shared conv a depth, Libra's balanced L1."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.core.anchors import LegacyAnchorGenerator
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.COCO_DENSE_CONFIGS[family])
    with tpc.meta_device():
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert type(model).__name__ == cfg.model.type
    if family == "ga_retina":
        assert model.ga_head and (model.ga_strides, model.ga_square_scale,
                                  model.loc_filter_thr) == (
            [8, 16, 32, 64, 128], 4, 0.01)
        h = "bbox_head."
        assert {k: v for k, v in sd.items() if k.startswith(h) and (
            "feature_adaption" in k or "retina" in k or "conv_" in k)} == {
            h + "conv_loc.weight": (1, 256, 1, 1), h + "conv_loc.bias": (1,),
            h + "conv_shape.weight": (2, 256, 1, 1),
            h + "conv_shape.bias": (2,),
            h + "feature_adaption_cls.conv_offset.weight": (18, 2, 1, 1),
            h + "feature_adaption_cls.conv_adaption.weight": (256, 256, 3, 3),
            h + "feature_adaption_reg.conv_offset.weight": (18, 2, 1, 1),
            h + "feature_adaption_reg.conv_adaption.weight": (256, 256, 3, 3),
            h + "retina_cls.weight": (80, 256, 3, 3),
            h + "retina_cls.bias": (80,),
            h + "retina_reg.weight": (4, 256, 3, 3),
            h + "retina_reg.bias": (4,)}
    elif family == "ga_rpn":
        assert model.ga_rpn and not model.roi_head
    elif family.startswith("legacy"):
        gen = model.anchor_generator
        assert isinstance(gen, LegacyAnchorGenerator)
        if family != "legacy_retina":
            assert model.rpn_legacy
        if family == "legacy_mask":
            assert model.bbox_coder["type"] == "LegacyDeltaXYWHBBoxCoder"
    elif family == "sepbn_nasfpn":
        assert sd["bbox_head.cls_convs.0.0.conv.weight"] == (256, 256, 3, 3)
        assert "bbox_head.cls_convs.0.0.conv.bias" not in sd
        assert "bbox_head.cls_convs.4.3.conv.weight" not in sd
        assert sd["bbox_head.reg_convs.4.3.bn.running_var"] == (256,)
        assert not any(k.startswith("neck.") and ".bn." in k for k in sd)
    elif family == "libra_retina":
        assert model.loss_bbox_cfg["type"] == "BalancedL1Loss"
    elif family == "pisa_retina":
        assert set(model.train_cfg) >= {"isr", "carl"}


@pytest.mark.parametrize("family", ["legacy_retina", "legacy_mask"])
def test_legacy_anchors_and_valid_flags_equal_jax(family):
    """The v1.x anchors of the single-stage setting (RetinaNet's octave
    scales on strides 8..128) and of the RPN's (scale 8 on strides 4..64),
    rounded, centred at half a ``size - 1`` cell, and their valid flags
    for an unpadded region that ends inside a cell, exactly JAX's."""
    from bonai_tpu.core.anchors import LegacyAnchorGenerator as JaxLegacy
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.core.anchors import LegacyAnchorGenerator
    cfg = Config.fromfile(tpc.COCO_DENSE_CONFIGS[family])
    head = cfg.model.get("rpn_head") or cfg.model.bbox_head
    ag = dict(head.anchor_generator)
    assert ag.pop("type") == "LegacyAnchorGenerator"
    got, want = LegacyAnchorGenerator(**ag), JaxLegacy(**ag)
    sizes = [(1024 // s // 2 + 1, 1024 // s) for s in ag["strides"]]
    for a, b in zip(got.grid_anchors(sizes) + got.valid_flags(
            sizes, (300, 517)), want.grid_anchors(sizes) + want.valid_flags(
            sizes, (300, 517))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.base_anchors[0] == np.round(got.base_anchors[0])).all()
    assert not got.valid_flags(sizes, (300, 517))[0].all()


@pytest.mark.parametrize("family", ["ga_retina", "sepbn_nasfpn"])
def test_weights_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys (GA's
    adaption kernels and offsets under ``feature_adaption_cls|reg``, the
    SepBN norms' statistics), and a ``.pth`` of them loads back equal; the
    JAX importer raises ``KeyError``: it reads ``rpn_head.*``, which a
    RetinaNet has not (and before that an FPN's ``lateral_0``, which the
    NAS-FPN's laterals are not)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables, pm = models(family)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(pm.state_dict()) == set(sd)
    pth = tmp_path / "w.pth"
    torch.save({"state_dict": sd}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError, match={"ga_retina": "rpn_head",
                                        "sepbn_nasfpn": "lateral_0"}[family]):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])


def test_mmdet_layouts(tmp_path):
    """mmdetection's SepBN head repeats each shared conv under every level
    (``cls_convs.<l>.<i>.conv``): level 0's loads and an equal copy is
    dropped, a differing one raises ``ValueError`` naming its level;
    mmdetection's four-group GA feature adaption (a 72-channel
    ``conv_offset``) raises ``ValueError``."""
    from bonai_tpu_torch.apis import init_detector
    cfg, _, _, pm = models("sepbn_nasfpn")
    sd = dict(pm.state_dict())
    for lvl in range(1, 5):
        for i in range(2):
            for kind in ("cls", "reg"):
                sd[f"bbox_head.{kind}_convs.{lvl}.{i}.conv.weight"] = \
                    sd[f"bbox_head.{kind}_convs.0.{i}.conv.weight"].clone()
    pth = tmp_path / "sepbn.pth"
    torch.save({"state_dict": sd}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, pm.state_dict()[k]), k
    sd["bbox_head.reg_convs.3.1.conv.weight"] += 1.0
    torch.save({"state_dict": sd}, pth)
    with pytest.raises(ValueError, match="reg_convs.3.1.conv.weight differs "
                                         "from level 0"):
        init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    cfg, _, _, pm = models("ga_retina")
    sd = dict(pm.state_dict())
    sd["bbox_head.feature_adaption_reg.conv_offset.weight"] = torch.zeros(
        72, 2, 1, 1)
    torch.save({"state_dict": sd}, pth)
    with pytest.raises(ValueError, match="4 offset groups"):
        init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["ga_retina", "ga_rpn", "legacy_mask"])
def test_serving_matches_jax(family):
    """The dense head's outputs (GA's through both deformable adaptions)
    and ``simple_test``: GA RetinaNet's detections, the GA RPN-only
    detector's guided-anchor proposals, the legacy Mask R-CNN's v1.x
    proposals, box decode and masks."""
    cfg, jm, variables, pm = models(family)
    image, shape, scale = _inputs(family)
    dense = cfg.model.type == "RetinaNet"
    ref_outs, ref = jax_call(lambda v, i, s, f: (
        jm.apply(v, i) if dense else None,
        jm.apply(v, i, s, f, method="simple_test")),
        variables, image, shape, scale)
    if dense:
        with torch.no_grad():
            outs = pm.bbox_head(pm.extract_feat(t(image)))
        assert len(outs) == len(ref_outs) == (
            4 if family == "ga_retina" else 2)
        for kind, (got, want) in enumerate(zip(outs, ref_outs)):
            for lvl, (g, w) in enumerate(zip(got, want)):
                _close(g.permute(0, 2, 3, 1).numpy(), w,
                       err_msg=f"output {kind} level {lvl}")
    got = pm.simple_test(t(image), t(shape), t(scale))
    assert set(got) == set(ref)
    compare_detections(got, ref)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _jax_ga_rpn_losses(jm, variables, batch):
    """The JAX ``ga_rpn_loss`` of the RPN-only detector's outputs on the
    module's ``sampling`` key unsplit, and its gradient (the JAX
    ``RPN.forward_train`` fails on a ``GARPNHead``)."""
    from bonai_tpu.models.dense_heads.ga_rpn_head import (approx_anchors,
                                                          ga_rpn_loss)

    def losses(m, batch):
        feats = m.extract_feat(batch["image"])
        sizes = [(int(f.shape[1]), int(f.shape[2])) for f in feats]
        outs, _, squares, _, _, _ = m._rpn_and_proposals(
            feats, batch["img_shape"], {})
        approxs = [jax.numpy.asarray(a) for a in approx_anchors(
            sizes, m.ga_strides, m.ga_octave_base_scale,
            m.ga_scales_per_octave, m.ga_ratios)]
        return ga_rpn_loss(*outs, squares, approxs, batch["gt_bboxes"],
                           batch["gt_valid"], m.make_rng("sampling"),
                           dict(m.train_cfg["rpn"]), m.ga_strides,
                           m.ga_octave_base_scale, sizes)
    return losses


def _jax_losses_and_grads(family, batch):
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    _, jm, variables, _ = models(family)
    method = _jax_ga_rpn_losses(jm, variables, batch) \
        if family == "ga_rpn" else "forward_train"

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method=method, rngs={"sampling": KEY})
        return sum(losses.values()), losses
    # the mask targets' sample points land on 0.5 ties that XLA's fused
    # multiply-adds decide (``core/masks.py``): those families compile at
    # XLA's default optimisation level
    (_, ref), grads = jax_call(jax.value_and_grad(total, has_aux=True),
                               variables["params"], batch,
                               fast="mask_head" not in variables["params"])
    return ({k: float(v) for k, v in ref.items()},
            state_dict_from_jax(grads, variables["batch_stats"]))


STEPPED = ("ga_retina", "ga_rpn", "legacy_mask", "legacy_cascade",
           "legacy_retina", "sepbn_nasfpn", "libra_retina", "pisa_retina")
LOSSES = {
    "ga_retina": {"loss_cls", "loss_bbox", "loss_shape", "loss_loc"},
    "ga_rpn": {"loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_shape",
               "loss_rpn_loc"},
    "legacy_mask": {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                    "loss_bbox", "loss_mask"},
    "legacy_cascade": {"loss_rpn_cls", "loss_rpn_bbox", "loss_mask"} | {
        f"s{i}.loss_{k}" for i in range(3) for k in ("cls", "bbox")},
    "legacy_retina": {"loss_cls", "loss_bbox"},
    "sepbn_nasfpn": {"loss_cls", "loss_bbox"},
    "libra_retina": {"loss_cls", "loss_bbox"},
    "pisa_retina": {"loss_cls", "loss_bbox", "loss_carl"}}


@pytest.mark.parametrize("family", STEPPED)
def test_step_matches_jax(family):
    """One batch's losses and every trainable tensor's gradient against
    JAX with JAX's draws: GA's adaption offsets and kernels through the
    deformable sampling, the v1.x RPN and R-CNN targets, the cascade's
    stages and the legacy RetinaNet (which do not read the v1.x coder, as
    in JAX; the RetinaNet's v1.x anchors), the SepBN
    head's shared convs over five levels' norms, Libra's balanced L1 (its
    non-local phi bias's gradient is 0 but for float noise, within 1e-6
    of its weight's largest in both, as in ``test_torch_port_rcnn_a7.py``),
    PISA's ISR-P and CARL."""
    cfg, jm, variables, pm = models(family)
    batch = _batch(family)
    ref, ref_grads = _jax_losses_and_grads(family, batch)
    draw = jax_forward_train_draws(
        jm, variables, KEY, 2, cascade=family == "legacy_cascade",
        unsplit=family.startswith("ga_"), ga=family == "ga_rpn")
    pm.zero_grad()
    got = pm.forward_train({k: t(v) for k, v in batch.items()}, draw)
    sum(got.values()).backward()
    assert set(got) == set(ref) == LOSSES[family]
    for k, v in ref.items():
        assert float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, err_msg=k)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    for name, g in grads.items():
        assert g is not None, name
        if name in ZERO_GRADS:          # Libra's non-local phi bias
            scale = float(grads[ZERO_GRADS[name]].abs().max())
            assert float(g.abs().max()) < 1e-6 * scale, name
            assert float(ref_grads[name].abs().max()) < 1e-6 * scale, name
            continue
        _close(g.numpy(), ref_grads[name].numpy(), 1e-4, err_msg=name)
    if family.startswith("ga_"):
        head = "bbox_head" if family == "ga_retina" else "rpn_head"
        offsets = [p.grad for n, p in pm.named_parameters()
                   if n.startswith(head) and "conv_offset" in n]
        assert offsets and all(float(g.abs().max()) > 0 for g in offsets)


def test_norm_decay_mult_matches_jax():
    """The crop640 recipe's ``paramwise_cfg=dict(norm_decay_mult=0,
    bypass_duplicate=True)``: one SGD step from zero gradients moves each
    trainable tensor by its weight decay alone, which the norms' affines
    (the trunk's, the SepBN head's) do not take, as in the JAX optax
    chain; another ``paramwise_cfg`` key raises A7."""
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu_torch.engine import build_optimizer
    from bonai_tpu_torch.engine.optim import apply_gradients
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables, _ = models("sepbn_nasfpn")
    opt_cfg = dict(cfg.optimizer)
    assert opt_cfg["paramwise_cfg"] == dict(norm_decay_mult=0,
                                            bypass_duplicate=True)
    tx = jax_optimizer(opt_cfg, lambda step: 0.5)
    updates = jax_call(lambda p: tx.update(
        jax.tree_util.tree_map(jax.numpy.zeros_like, p), tx.init(p), p)[0],
        variables["params"])
    want = state_dict_from_jax(updates, variables["batch_stats"])
    pm = port_model(cfg, variables)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    apply_gradients(build_optimizer(pm, opt_cfg), 0.5)
    held = []
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            continue
        if not want[name].any():
            held.append(name)
            assert torch.equal(p.detach(), before[name]), name
            continue
        # the step's float32 rounding is an ulp of the weight, not of the
        # update
        np.testing.assert_allclose(
            (p.detach() - before[name]).numpy(), want[name].numpy(), rtol=0,
            atol=1e-6 * float(before[name].abs().max()), err_msg=name)
    norms = [n for n, m in pm.named_modules()
             if type(m).__name__ == "FrozenBatchNorm2d"]
    assert sorted(held) == sorted(
        n for n, p in pm.named_parameters() if p.requires_grad
        and n.rsplit(".", 1)[0] in norms)
    assert any(n.startswith("bbox_head.cls_convs.4.") for n in held)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A7"):
        build_optimizer(pm, dict(opt_cfg, paramwise_cfg=dict(
            bias_lr_mult=2.0, bias_decay_mult=0.0)))
