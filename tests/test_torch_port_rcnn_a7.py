"""The rest of the R-CNN family on BONAI in bonai_tpu_torch against the JAX
package, at the tiny widths of ``torch_port_common`` in float32 on the CPU:
Libra R-CNN (``configs/libra_rcnn/libra_faster_rcnn_r50_fpn_1x_bonai.py``:
FPN + BFP with a non-local refine, the IoU-balanced sampler, the balanced
L1 loss), Double-Head R-CNN (``configs/double_heads/
dh_faster_rcnn_r50_fpn_1x_bonai.py``), Mask Scoring R-CNN
(``configs/ms_rcnn/ms_rcnn_r50_fpn_1x_bonai.py``), the RPN-only detector
(``configs/rpn/rpn_r50_fpn_1x_bonai.py``) and Fast R-CNN
(``configs/fast_rcnn/fast_rcnn_r50_fpn_1x_bonai.py``, on given
proposals); their modules (``NonLocal2d``, ``BFP``, ``BalancedL1Loss``,
``iou_balanced_neg_sample``, ``DoubleConvFCBBoxHead``, ``scale_rois``,
``MaskIoUHead``, ``mask_iou_targets``) and weights.

Tolerances: ``simple_test`` outputs within 1e-4 of each output's largest
magnitude, validity and labels exact; each loss 1e-5 relative; each
gradient 1e-4 of its tensor's largest magnitude; the modules 1e-5 of
their output's largest magnitude (the losses and IoU targets 1e-6
relative); the sampler and the weights exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from bonai_tpu_torch.tools.profile_train import synthetic_proposals
from test_torch_port_rcnn import (IMG_SHAPE, SCALE, jax_losses_and_grads,
                                  port_losses)
from torch_port_common import (a7_cfg, jax_forward_train_draws, jax_model,
                               port_model, t, train_batch)

FAMILIES = ("libra", "double_head", "mask_scoring", "rpn", "fast_rcnn")
# the RoI heads of each family, as mmdet names them; the RPN has none
HEADS = {"libra": {"bbox_head"}, "double_head": {"bbox_head"},
         "mask_scoring": {"bbox_head", "mask_head", "mask_iou_head"},
         "rpn": set(), "fast_rcnn": {"bbox_head"}}
# phi's bias shifts every pairwise logit of a row alike, which the softmax
# cancels: its gradient is 0 but for float noise in both packages
ZERO_GRADS = {"neck.1.refine.phi.conv.bias": "neck.1.refine.phi.conv.weight"}

_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` at the training sizes,
    weights of seed 1, built once."""
    if family not in _MODELS:
        cfg = a7_cfg(family, train=True)
        _MODELS[family] = (cfg, *jax_model(cfg, seed=1))
    return _MODELS[family]


def _serve_args(family):
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    args = [image, IMG_SHAPE, SCALE]
    if family == "fast_rcnn":
        gt = train_batch(size=96)
        args += list(synthetic_proposals(gt["gt_bboxes"], gt["gt_valid"],
                                         48, 96, seed=1))
    return args


def _train_batch(family):
    batch = train_batch()
    if family == "fast_rcnn":
        batch["proposals"], batch["proposals_valid"] = synthetic_proposals(
            batch["gt_bboxes"], batch["gt_valid"], 48, 128, seed=1)
    return batch


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_build_at_full_width(family):
    """``build_detector`` builds the shipped config with mmdet's module
    layout; Fast R-CNN without the RPN head its config inherits."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.models.roi_heads.bbox_head import (
        DoubleConvFCBBoxHead)
    from bonai_tpu_torch.ops.layers import NonLocal2d
    cfg = Config.fromfile(tpc.A7_CONFIGS[family])
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == {
        "libra": "FasterRCNN", "double_head": "FasterRCNN",
        "mask_scoring": "MaskRCNN", "rpn": "RPN",
        "fast_rcnn": "FastRCNN"}[family]
    sd = model.state_dict()
    tops = {k.split(".")[0] for k in sd}
    assert tops == {"backbone", "neck"} | (
        set() if family == "fast_rcnn" else {"rpn_head"}) | (
        set() if family == "rpn" else {"roi_head"})
    assert {k.split(".")[1] for k in sd if k.startswith("roi_head.")} \
        == HEADS[family]
    if family == "libra":
        assert isinstance(model.neck[1].refine, NonLocal2d)
        assert sd["neck.1.refine.theta.conv.weight"].shape == (256, 256, 1, 1)
        assert "neck.0.fpn_convs.3.conv.weight" in sd
        assert model.bbox_loss_cfg["type"] == "BalancedL1Loss"
    if family == "double_head":
        head = model.roi_head["bbox_head"]
        assert isinstance(head, DoubleConvFCBBoxHead)
        assert model.reg_roi_scale_factor == 1.3
        assert sd["roi_head.bbox_head.res_block.conv2.conv.weight"].shape \
            == (1024, 256, 1, 1)
        assert sd["roi_head.bbox_head.conv_branch.3.conv2.weight"].shape \
            == (256, 256, 3, 3)
        assert sd["roi_head.bbox_head.fc_branch.0.weight"].shape \
            == (1024, 256 * 49)
        assert sd["roi_head.bbox_head.fc_reg.weight"].shape == (4, 1024)
    if family == "mask_scoring":
        head = model.roi_head["mask_iou_head"]
        assert head.convs[3].conv.stride == (2, 2)
        assert sd["roi_head.mask_iou_head.convs.0.conv.weight"].shape \
            == (256, 257, 3, 3)
        assert sd["roi_head.mask_iou_head.fcs.0.weight"].shape \
            == (1024, 256 * 49)
        assert model.mask_iou_loss_weight == 0.5


def compare_outputs(got, ref, min_valid=20):
    valid = np.asarray(ref["det_valid"])
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > min_valid
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    for key in set(ref) - {"det_valid", "det_labels"}:
        want = np.asarray(ref[key])[valid]
        np.testing.assert_allclose(got[key].numpy()[valid], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
def test_simple_test_matches_jax(family):
    """Mask Scoring adds ``mask_scores``; the RPN's detections are its
    proposals; Fast R-CNN's come from the given proposals."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    args = _serve_args(family)
    ref = tpc.jax_call(lambda v, *a: jm.apply(
        v, *a, method="simple_test"), variables, *args)
    got = pm.simple_test(*(t(a) for a in args))
    assert set(got) == {"det_bboxes", "det_scores", "det_labels",
                        "det_valid"} | ({"mask_probs", "mask_scores"}
                                        if family == "mask_scoring" else set())
    compare_outputs(got, ref)


_TRAINED = {}


def trained(family):
    """JAX's and the port's losses and gradients of one batch under the
    JAX draws (the RPN-only detector's and Fast R-CNN's from their unsplit
    sampling key; Libra's R-CNN sampler's from three streams), once."""
    if family not in _TRAINED:
        cfg, jm, variables = models(family)
        batch = _train_batch(family)
        key = jax.random.PRNGKey(3)
        ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
        pm = port_model(cfg, variables)
        got = port_losses(pm, batch, jax_forward_train_draws(
            jm, variables, key, 2, unsplit=family in ("rpn", "fast_rcnn")))
        _TRAINED[family] = (ref, got, ref_grads, pm)
    return _TRAINED[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_losses_match_jax(family):
    ref, got, _, _ = trained(family)
    rpn = {"loss_rpn_cls", "loss_rpn_bbox"}
    rcnn = {"loss_cls", "loss_bbox"}
    assert set(got) == set(ref) == {
        "libra": rpn | rcnn, "double_head": rpn | rcnn,
        "mask_scoring": rpn | rcnn | {"loss_mask", "loss_mask_iou"},
        "rpn": rpn, "fast_rcnn": rcnn}[family]
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """Every trainable tensor has a gradient, within 1e-4 of the largest
    of JAX's; a gradient that is 0 but for float noise (``ZERO_GRADS``)
    is within 1e-6 of its weight's largest in both packages."""
    _, _, ref_grads, pm = trained(family)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    assert len(grads) > 30
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        if name in ZERO_GRADS:
            scale = float(grads[ZERO_GRADS[name]].abs().max())
            assert float(g.abs().max()) < 1e-6 * scale, name
            assert float(np.abs(ref).max()) < 1e-6 * scale, name
            continue
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)
    if family == "libra":       # the non-local block's branches train
        assert float(grads["neck.1.refine.theta.conv.weight"].abs().max()) > 0
    if family == "mask_scoring":
        assert float(grads["roi_head.mask_iou_head.fc_mask_iou.weight"]
                     .abs().max()) > 0


# ---------------------------------------------------------------------------
# the modules, on the detectors' own weights
# ---------------------------------------------------------------------------

def _levels(seed, c=16):
    """FPN levels of a 160x96 tile (the extra level of odd size): NHWC
    numpy."""
    r = np.random.RandomState(seed)
    return [r.randn(2, h, w, c).astype(np.float32)
            for h, w in ((40, 24), (20, 12), (10, 6), (5, 3), (3, 2))]


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("refine", [None, "conv", "non_local"])
def test_bfp_and_nonlocal_match_jax(refine):
    """BFP on levels of odd sizes, each refine type; the non-local block
    (alone, and in the BFP) on the Libra detector's weights."""
    from bonai_tpu.models.necks.bfp import BFP as JaxBFP
    from bonai_tpu.ops.layers import NonLocal2d as JaxNonLocal
    from bonai_tpu_torch.models.necks.bfp import BFP
    levels = _levels(0)
    jbfp = JaxBFP(in_channels=16, refine_type=refine)
    bfp = BFP(16, refine_type=refine)
    if refine == "non_local":
        cfg, _, variables = models("libra")
        params = {"refine": variables["params"]["neck_extra0"]["refine"]}
        bfp.load_state_dict(port_model(cfg, variables).neck[1].state_dict())
        x = levels[2]
        _close(bfp.refine(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
               .detach(), JaxNonLocal(reduction=1).apply(
                   {"params": params["refine"]}, x))
    else:
        params = jbfp.init(jax.random.PRNGKey(0), levels)["params"] \
            if refine else {}
        if refine == "conv":
            k = np.asarray(params["refine"]["kernel"])
            bfp.refine.conv.weight.data = t(k.transpose(3, 2, 0, 1))
            bfp.refine.conv.bias.data = t(params["refine"]["bias"])
    want = jbfp.apply({"params": params}, levels)
    got = bfp(tuple(t(x).permute(0, 3, 1, 2) for x in levels))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == (w.shape[0], w.shape[3], w.shape[1], w.shape[2])
        _close(g.permute(0, 2, 3, 1).detach(), w)


def test_double_head_and_scale_rois_match_jax():
    """The Double-Head box head on separate cls and reg RoI features, and
    the RoI scaling, on the detector's weights."""
    from bonai_tpu.models.roi_heads.bbox_head import (
        DoubleConvFCBBoxHead as JaxHead)
    from bonai_tpu.models.roi_heads.bbox_head import scale_rois as jax_scale
    from bonai_tpu_torch.models.roi_heads.bbox_head import scale_rois
    cfg, _, variables = models("double_head")
    pm = port_model(cfg, variables)
    r = np.random.RandomState(2)
    x_cls, x_reg = (r.randn(12, 7, 7, 16).astype(np.float32)
                    for _ in range(2))
    head = JaxHead(num_classes=1, num_convs=2, num_fcs=2, in_channels=16,
                   conv_out_channels=32, fc_out_channels=32)
    want = head.apply({"params": variables["params"]["bbox_head"],
                       "batch_stats": variables["batch_stats"]["bbox_head"]},
                      x_cls, x_reg)
    got = pm.roi_head["bbox_head"](t(x_cls), t(x_reg))
    for g, w in zip(got, want):
        _close(g.detach(), w)
    rois = np.concatenate([r.randint(0, 2, (40, 1)), r.uniform(0, 60, (40, 2)),
                           r.uniform(60, 128, (40, 2))], 1).astype(np.float32)
    np.testing.assert_allclose(scale_rois(t(rois), 1.3).numpy(),
                               np.asarray(jax_scale(rois, 1.3)), rtol=1e-6)


def test_mask_iou_head_and_targets_match_jax():
    """The mask-IoU head on the Mask Scoring detector's weights (the
    largest of two classes' logits pooled), and the IoU targets of masks
    that cover, miss and straddle their GTs."""
    from bonai_tpu.models.roi_heads.mask_head import MaskIoUHead as JaxHead
    from bonai_tpu.models.roi_heads.mask_head import (
        mask_iou_targets as jax_targets)
    from bonai_tpu_torch.models.roi_heads.mask_head import mask_iou_targets
    cfg, _, variables = models("mask_scoring")
    pm = port_model(cfg, variables)
    r = np.random.RandomState(3)
    feats = r.randn(10, 14, 14, 16).astype(np.float32)
    logits = r.randn(10, 1, 28, 28).astype(np.float32)
    head = JaxHead(num_convs=2, in_channels=16, conv_out_channels=16,
                   fc_out_channels=32)
    want = head.apply({"params": variables["params"]["mask_iou_head"]},
                      feats, logits.transpose(0, 2, 3, 1))
    _close(pm.roi_head["mask_iou_head"](t(feats), t(logits)).detach(), want)
    two = np.concatenate([logits, r.randn(10, 1, 28, 28).astype(np.float32)],
                         1)
    want2 = JaxHead(num_convs=2, in_channels=16, conv_out_channels=16,
                    fc_out_channels=32).apply(
        {"params": variables["params"]["mask_iou_head"]}, feats,
        two.transpose(0, 2, 3, 1))
    _close(pm.roi_head["mask_iou_head"](t(feats), t(two)).detach(), want2)

    boxes = np.concatenate([r.uniform(0, 40, (10, 2)),
                            r.uniform(60, 100, (10, 2))], 1).astype(np.float32)
    gt = boxes + r.uniform(-10, 10, (10, 4)).astype(np.float32)
    masks = (r.rand(10, 28, 28) > 0.5).astype(np.float32)
    inst = (r.rand(10, 112, 112) > 0.3).astype(np.float32)
    args = (logits[:, 0], masks, boxes, gt, inst)
    want = np.asarray(jax_targets(*args))
    assert 0 < want.min() and want.max() < 1
    np.testing.assert_allclose(mask_iou_targets(*(t(a) for a in args)),
                               want, rtol=1e-6)


def test_balanced_l1_matches_jax():
    """Both sides of ``beta``, weighted, at Libra's and other constants."""
    from bonai_tpu.models.losses import BalancedL1Loss
    from bonai_tpu_torch.models.losses import balanced_l1_loss
    r = np.random.RandomState(4)
    pred = r.randn(64, 4).astype(np.float32)
    target = r.randn(64, 4).astype(np.float32)
    weight = (r.rand(64, 4) > 0.3).astype(np.float32)
    for kw in (dict(), dict(alpha=0.25, gamma=2.0, beta=0.5,
                            loss_weight=2.0)):
        want = float(BalancedL1Loss(**kw)(pred, target, weight,
                                          avg_factor=50.0))
        got = float(balanced_l1_loss(t(pred), t(target), t(weight),
                                     avg_factor=50.0, **kw))
        assert abs(pred - target).min() < kw.get("beta", 1.0) \
            < abs(pred - target).max()
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("case", ["default", "num_past_n", "no_negatives",
                                  "floor_zero", "floor_positive"])
def test_iou_balanced_sampler_matches_jax(case):
    """``iou_balanced_neg_sample`` on JAX's three streams: the default bins
    from -1, fewer candidates than ``num`` (the padding path), an empty
    negative pool, and a floor at IoU 0 and at 0.1 with half the
    negatives from under it.  Exact."""
    from bonai_tpu.core.samplers import iou_balanced_neg_sample as jax_fn
    from bonai_tpu_torch.core.samplers import iou_balanced_neg_sample
    r = np.random.RandomState(5)
    n = 300
    max_ov = r.uniform(0, 1, n).astype(np.float32)
    max_ov[r.rand(n) < 0.3] = 0.0
    assigned = np.where(max_ov >= 0.5, r.randint(1, 6, n), 0)
    assigned[r.rand(n) < 0.05] = -1                 # ignored candidates
    kw = dict(num=128, pos_fraction=0.25)
    if case == "num_past_n":
        kw["num"] = 512
    if case == "no_negatives":
        assigned[assigned == 0] = -1
    if case == "floor_zero":
        kw.update(floor_thr=0, floor_fraction=0.5)
    if case == "floor_positive":
        kw.update(floor_thr=0.1, floor_fraction=0.5)
    assigned = assigned.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    want = [jax_fn(k, jnp.asarray(assigned), jnp.asarray(max_ov), **kw)
            for k in keys]
    uniforms = [tpc.jax_uniforms(k, n, 3) for k in keys]
    got = iou_balanced_neg_sample(
        t(np.stack([assigned] * 2)), t(np.stack([max_ov] * 2)),
        kw.pop("num"), kw.pop("pos_fraction"),
        *(t(np.stack(u)) for u in zip(*uniforms)), **kw)
    for k in ("inds", "is_pos", "valid", "pos_gt_inds"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.stack([w[k] for w in want]),
                                      err_msg=k)
    valid = got["valid"].numpy()
    assert valid.any() and (case != "no_negatives"
                            or got["is_pos"].numpy()[valid].all())


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_weight_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys (mmdet's), the
    port loads them strictly and gives them back unchanged, and
    ``init_detector`` reads them from an mmdet-style ``.pth``.  The JAX
    importer, on such a ``.pth`` (256-channel neck and heads, as it
    assumes): Libra's neck is left at its initial values (mmdet keys it
    ``neck.0``/``neck.1``, the importer reads ``neck.*``) and Mask
    Scoring's IoU head too; it raises ``KeyError`` on Double-Head's box
    head, the RPN's missing box head and Fast R-CNN's missing RPN head
    (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = a7_cfg(family)
    m = cfg.model
    for neck in tpc._each(m.neck):
        if neck.type == "FPN":
            neck.out_channels = 256
        else:
            neck.in_channels = 256
    if m.get("rpn_head") is not None:
        m.rpn_head.update(in_channels=256, feat_channels=32)
    for k in ("bbox_head", "mask_head", "mask_iou_head"):
        if (m.get("roi_head") or {}).get(k) is not None:
            m.roi_head[k].in_channels = 256
    _, variables = jax_model(cfg)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    pm = port_model(cfg, variables)
    assert set(pm.state_dict()) == set(sd)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    pth = tmp_path / "mmdet.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k

    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    if family in ("double_head", "rpn", "fast_rcnn"):
        with pytest.raises(KeyError):
            mmdet_checkpoint_to_params(numpy_sd, zeros["params"],
                                       zeros["batch_stats"])
        return
    params, stats = mmdet_checkpoint_to_params(
        numpy_sd, zeros["params"], zeros["batch_stats"])
    unread = {"libra": ("neck", "neck_extra0"),
              "mask_scoring": ("mask_iou_head",)}[family]
    assert set(unread) <= set(params)
    ref = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        where = jax.tree_util.keystr(path)
        if path[0].key in unread:
            assert not np.asarray(leaf).any(), where
        else:
            np.testing.assert_array_equal(np.asarray(leaf), ref[path],
                                          err_msg=where)
