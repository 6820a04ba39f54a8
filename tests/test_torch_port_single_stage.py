"""The dense single-stage detectors in bonai_tpu_torch against the JAX
package, at the tiny widths of ``torch_port_common.dense_cfg`` in float32
on the CPU: RetinaNet (focal + L1; GHM-C/GHM-R; PISA), FreeAnchor, ATSS,
GFL and FCOS on their BONAI (and RetinaNet's COCO) configs, with the FPN's
``start_level=1``, extra convs and 5 outputs at 160^2 (levels of 20^2 to
2^2: on a 1x1 level each of GroupNorm's groups would hold two elements,
and their normalisation is rounding noise magnified); their modules and
functions, and their weights.  FCOS runs once more with its
centre-sampling, ``norm_on_bbox``, ``centerness_on_reg`` and GIoU axes.

Tolerances: head outputs, detections and each loss 1e-5 of the largest
value (labels and validity exact); each gradient 1e-4 of its tensor's
largest element; the FPN 1e-5 of its largest output; the assigners, ranks,
GHM edges and the weights exact; the loss functions 1e-6 of their largest
value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from torch_port_common import dense_cfg, jax_model, port_model, t, train_batch

FAMILIES = ("retinanet", "ghm", "pisa", "free_anchor", "atss", "gfl", "fcos",
            "fcos_axes")
# the families of distinct heads and decodes (GHM's and PISA's are
# RetinaNet's)
SERVED = ("retinanet", "free_anchor", "atss", "gfl", "fcos", "fcos_axes")
# FCOS's other axes, which the JAX detector reads (the reference's
# fcos_center-normbbox-centeronreg-giou configs)
FCOS_AXES = dict(center_sampling=True, center_sample_radius=1.5,
                 norm_on_bbox=True, centerness_on_reg=True,
                 loss_bbox=dict(type="GIoULoss", loss_weight=1.0))
SIZE = 160
IMG_SHAPE = np.array([[160, 160], [136, 150]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)
REG_OUTPUTS = ("retina_reg", "atss_reg", "conv_reg")

_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family``, weights of seed 1
    with the delta outputs scaled by 0.1 (decoded boxes stay near their
    anchors), built once."""
    if family not in _MODELS:
        cfg = _cfg(family)
        jm, variables = jax_model(cfg, seed=1)
        head = variables["params"]["bbox_head"]
        for name in REG_OUTPUTS:
            if name in head:
                head[name]["kernel"] *= 0.1
        _MODELS[family] = (cfg, jm, variables)
    return _MODELS[family]


def _cfg(family):
    if family == "fcos_axes":
        cfg = dense_cfg("fcos")
        cfg.model.bbox_head.update(FCOS_AXES)
        return cfg
    return dense_cfg(family)


def _jit(fn, *args):
    return tpc.jax_call(fn, *args)


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


def _batch(family, seed=0):
    """The tiny training batch; 3-class labels for the RetinaNet-family
    configs."""
    batch = train_batch(seed=seed, size=SIZE)
    if _cfg(family).model.bbox_head.num_classes > 1:
        batch["gt_labels"] = np.random.RandomState(seed).randint(
            0, 3, batch["gt_labels"].shape).astype(np.int32)
    return batch


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(tpc.DENSE_CONFIGS))
def test_configs_build_at_full_width(family):
    """``build_detector`` builds the shipped config with mmdet's layout:
    the FPN's extra convs as ``fpn_convs.3``/``.4`` (the first on C5's
    2048 channels), the head's towers, outputs and per-level scales."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.DENSE_CONFIGS[family])
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == cfg.model.type
    assert not model.takes_proposals
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert not any(k.startswith(("rpn_head", "roi_head")) for k in sd)
    assert sd["neck.lateral_convs.0.conv.weight"] == (256, 512, 1, 1)
    assert sd["neck.fpn_convs.3.conv.weight"] == (256, 2048, 3, 3)
    assert sd["neck.fpn_convs.4.conv.weight"] == (256, 256, 3, 3)
    assert "neck.fpn_convs.5.conv.weight" not in sd
    c = cfg.model.bbox_head.num_classes
    h = "bbox_head."
    assert sd[h + "cls_convs.3.conv.weight"] == (256, 256, 3, 3)
    outputs = {"retina": {"retina_cls": 9 * c, "retina_reg": 36},
               "atss": {"atss_cls": c, "atss_reg": 4, "atss_centerness": 1},
               "gfl": {"gfl_cls": c, "gfl_reg": 68},
               "fcos": {"fcos_cls": c, "fcos_reg": 4, "fcos_centerness": 1}}[
        family if family in ("atss", "gfl", "fcos") else "retina"]
    for name, n in outputs.items():
        assert sd[f"{h}{name}.weight"] == (n, 256, 3, 3), name
    gn = family in ("atss", "gfl", "fcos")
    assert (h + "reg_convs.0.gn.weight" in sd) == gn
    assert sum(k.startswith(h + "scales.") for k in sd) == (5 if gn else 0)
    if family == "ghm":
        assert model.loss_cls_cfg["bins"] == 30
        assert model.loss_bbox_cfg["type"] == "GHMR"
    if family == "pisa":
        assert model.train_cfg["isr"] == dict(k=2.0, bias=0.0)


# the BONAI configs of the single-stage types that bring their own trunk
OWN_TRUNK = {"SSD": "ssd/ssd300_bonai.py",
             "CornerNet": "cornernet/cornernet_hourglass104_bonai.py",
             "NASFCOS": "nas_fcos/nas_fcos_r50_fpn_bonai.py"}


@pytest.mark.parametrize("det_type", ["FSAF", "FOVEA", "FoveaBox",
                                      "RepPointsDetector", "SSD",
                                      "CornerNet", "NASFCOS"])
def test_unported_single_stage_types_name_a6(det_type):
    """Every single-stage type of the JAX registry is ported: FSAF,
    FoveaBox (and its alias ``FOVEA``) and RepPoints build from ATSS's
    layout; SSD, CornerNet and NAS-FCOS, which build their own backbone
    or neck, from their BONAI configs (on the meta device)."""
    from bonai_tpu import Config as JaxConfig
    from bonai_tpu.models import build_detector as jax_build
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    if det_type in OWN_TRUNK:
        path = f"{tpc.ROOT}/configs/{OWN_TRUNK[det_type]}"
        cfg = Config.fromfile(path)
        jcfg = JaxConfig.fromfile(path)
        assert jax_build(jcfg.model, jcfg.train_cfg, jcfg.test_cfg)
        with torch.device("meta"):
            model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
        assert type(model).__name__ == det_type
        return
    cfg = dense_cfg("atss")
    cfg.model.type = det_type
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == {"FOVEA": "FoveaBox"}.get(det_type,
                                                              det_type)


@pytest.mark.parametrize("change", ["two_stage_on_dense", "dense_on_two",
                                    "head_type", "anchor_type",
                                    "loss_bbox"])
def test_layouts_and_options_that_raise(change):
    """A two-stage type on a single-stage layout and the reverse raise
    ``ValueError``; a RetinaNet head type, an anchor generator and a box
    loss that the port does not build raise A6 (Guided Anchoring's head,
    ``LegacyAnchorGenerator`` and ``BalancedL1Loss``, which these cases
    refused until item 6's A6 dense-head half, build:
    ``test_torch_port_rcnn.py::test_item6_a6_options_build``)."""
    from bonai_tpu_torch.models import build_detector
    cfg = dense_cfg("retinanet")
    bh = cfg.model.bbox_head
    error, match = NotImplementedError, "ROADMAP.md item A6"
    if change == "two_stage_on_dense":
        cfg.model.type = "FasterRCNN"
        error, match = ValueError, "two-stage detector"
    elif change == "dense_on_two":
        cfg = tpc.tiny_cfg(config=tpc.MASK_RCNN_CONFIG)
        cfg.model.type = "ATSS"
        error, match = ValueError, "single-stage detector"
    elif change == "head_type":
        bh.type = "FoveaHead"
    elif change == "anchor_type":
        bh.anchor_generator.type = "SSDAnchorGenerator"
    else:
        bh.loss_bbox = dict(type="IoULoss")
    with pytest.raises(error, match=match):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", SERVED)
def test_head_outputs_and_detections_match_jax(family):
    """Every level's head outputs, then ``simple_test``'s detections: the
    per-level ``nms_pre`` top-k, the decode and the multi-class NMS."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(
        np.float32)
    ref_outs = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    assert len(outs) == len(ref_outs) == (3 if family in ("atss", "fcos",
                                                          "fcos_axes")
                                          else 2)
    for kind, (got, want) in enumerate(zip(outs, ref_outs)):
        assert len(got) == len(want) == 5
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w,
                   err_msg=f"output {kind} level {lvl}")
    ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
               variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {"det_bboxes", "det_scores", "det_labels",
                                    "det_valid"}
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    _close(got["det_bboxes"].numpy()[valid],
           np.asarray(ref["det_bboxes"])[valid])
    _close(got["det_scores"].numpy()[valid],
           np.asarray(ref["det_scores"])[valid])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_TRAINED = {}


def trained(family):
    """JAX's losses and gradients of one batch and the port's, once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    if family not in _TRAINED:
        cfg, jm, variables = models(family)
        batch = _batch(family)

        def total(params, batch):
            losses = jm.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              batch, method="forward_train")
            return sum(losses.values()), losses

        (_, ref), grads = _jit(jax.value_and_grad(total, has_aux=True),
                               variables["params"], batch)
        pm = port_model(cfg, variables)
        got = pm.forward_train({k: t(v) for k, v in batch.items()})
        sum(got.values()).backward()
        _TRAINED[family] = (
            {k: float(v) for k, v in ref.items()},
            {k: float(v.detach()) for k, v in got.items()},
            state_dict_from_jax(grads, variables["batch_stats"]), pm)
    return _TRAINED[family]


LOSSES = {"retinanet": {"loss_cls", "loss_bbox"},
          "ghm": {"loss_cls", "loss_bbox"},
          "pisa": {"loss_cls", "loss_bbox", "loss_carl"},
          "free_anchor": {"positive_bag_loss", "negative_bag_loss"},
          "atss": {"loss_cls", "loss_bbox", "loss_centerness"},
          "gfl": {"loss_cls", "loss_bbox", "loss_dfl"},
          "fcos": {"loss_cls", "loss_bbox", "loss_centerness"},
          "fcos_axes": {"loss_cls", "loss_bbox", "loss_centerness"}}


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_losses_match_jax(family):
    """No draw source: none of the five samples at random."""
    ref, got, _, _ = trained(family)
    assert set(got) == set(ref) == LOSSES[family]
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """Every trainable tensor has a gradient (the head's towers, outputs
    and scales, the FPN's extra convs), within 1e-4 of JAX's largest."""
    _, _, ref_grads, pm = trained(family)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)
    for name in ("neck.fpn_convs.4.conv.weight",
                 "bbox_head.cls_convs.0.conv.weight"):
        assert float(grads[name].abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the modules and functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("on,relu", [("input", False), ("output", True),
                                     ("lateral", False), (None, False)])
def test_fpn_extra_convs_match_jax(on, relu):
    """The FPN from ``start_level=1`` with each extra-conv source (or the
    stride-2 subsampling without them), against the JAX ``FPN``; the
    config flags as ``_extra_convs_mode`` normalises them."""
    from bonai_tpu.models.detectors.builders import _extra_convs_mode
    from bonai_tpu.models.necks.fpn import FPN as JaxFPN
    from bonai_tpu_torch.models.necks.fpn import FPN, extra_convs_mode
    from bonai_tpu_torch.utils.weights import _conv
    for flags in ({"add_extra_convs": True}, {"add_extra_convs": False},
                  {"add_extra_convs": "on_output"},
                  {"add_extra_convs": True, "extra_convs_on_inputs": False},
                  {"add_extra_convs": "on_lateral"}):
        add, src = _extra_convs_mode(flags)
        assert extra_convs_mode(flags) == (src if add else None)
    chans = (8, 16, 32, 64)
    r = np.random.RandomState(4)
    inputs = [r.randn(2, 64 // 2 ** i, 64 // 2 ** i, c).astype(np.float32)
              for i, c in enumerate(chans)]
    jfpn = JaxFPN(in_channels=chans, out_channels=16, num_outs=5,
                  start_level=1, add_extra_convs=on is not None,
                  extra_convs_on=on or "input",
                  relu_before_extra_convs=relu)
    variables = jfpn.init(jax.random.PRNGKey(0), inputs)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + r.normal(0, 0.1, x.shape).astype(
            np.float32), variables["params"])
    ref = _jit(lambda p, x: jfpn.apply({"params": p}, x), params, inputs)
    fpn = FPN(chans, 16, 5, start_level=1,
              add_extra_convs=False if on is None else f"on_{on}",
              relu_before_extra_convs=relu)
    sd = {}
    for name, p in params.items():
        kind, i = name.rsplit("_", 1)
        key = {"lateral": f"lateral_convs.{i}",
               "fpn": f"fpn_convs.{i}",
               "extra": f"fpn_convs.{3 + int(i)}"}[kind]
        sd[f"{key}.conv.weight"] = torch.from_numpy(_conv(p["kernel"]).copy())
        sd[f"{key}.conv.bias"] = torch.from_numpy(p["bias"])
    fpn.load_state_dict(sd)
    with torch.no_grad():
        outs = fpn([t(x).permute(0, 3, 1, 2) for x in inputs])
    assert [tuple(o.shape[2:]) for o in outs] == [(32, 32), (16, 16),
                                                  (8, 8), (4, 4), (2, 2)]
    for o, w in zip(outs, ref):
        _close(o.permute(0, 2, 3, 1).numpy(), w)


def _atss_anchors(sizes=((16, 16), (8, 8))):
    from bonai_tpu_torch.core.anchors import AnchorGenerator
    gen = AnchorGenerator(strides=[8, 16], ratios=[1.0],
                          octave_base_scale=8, scales_per_octave=1)
    return gen.grid_anchors(list(sizes))


def test_atss_assign_matches_jax_with_exact_ties():
    """GT centres planted between anchor centres, against JAX at the
    configs' ``topk=9`` over two levels, and at ``topk=2`` over the
    stride-8 level alone.  There the centre (12, 12) of GT 0 has four
    nearest anchors at one distance: ``topk=2`` takes the two of lower
    index, as ``jax.lax.top_k`` takes them, and with equal IoUs (the
    threshold their mean) both are positive, the other two not.  GT 1 is centred between two anchors of a row; random GTs and a
    padded one besides."""
    from bonai_tpu.core.assigners import atss_assign as jax_atss
    from bonai_tpu_torch.core.assigners import atss_assign
    levels = _atss_anchors()
    anchors = np.concatenate(levels)
    nla = [len(a) for a in levels]
    r = np.random.RandomState(5)
    gts = np.zeros((2, 6, 4), np.float32)
    gts[0, 0] = [-20, -20, 44, 44]              # centre (12, 12)
    gts[0, 1] = [44, 4, 76, 44]                 # centre (60, 24)
    xy = r.uniform(0, 90, (2, 4, 2))
    wh = r.uniform(10, 60, (2, 4, 2))
    gts[:, 2:] = np.concatenate([xy, xy + wh], -1)
    valid = np.ones((2, 6), bool)
    valid[1, -1] = False
    gts[1, -1] = 0
    acx = (anchors[:nla[0], 0] + anchors[:nla[0], 2]) / 2
    acy = (anchors[:nla[0], 1] + anchors[:nla[0], 3]) / 2
    nearest = np.flatnonzero(np.hypot(acx - 12, acy - 12)
                             == np.hypot(acx - 12, acy - 12).min())
    assert nearest.tolist() == [17, 18, 33, 34]
    # both levels at topk 9; the stride-8 level alone at topk 2
    for anc, counts, topk in ((anchors, nla, 9), (levels[0], nla[:1], 2)):
        got, got_ov = atss_assign(t(anc), counts, t(gts), t(valid), topk)
        for i in range(2):
            want, want_ov = _jit(lambda g, v: jax_atss(
                jnp.asarray(anc), counts, g, v, topk=topk), gts[i],
                valid[i])
            np.testing.assert_array_equal(got[i].numpy(), want)
            np.testing.assert_allclose(got_ov[i].numpy(), want_ov, rtol=0,
                                       atol=1e-7)
    assert np.flatnonzero(got[0].numpy() == 1).tolist() == [17, 18]


def test_max_iou_assign_takes_retinanet_settings():
    """``pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0``: ignored
    anchors between the thresholds, and every valid GT's best anchors
    however low their IoU, as in JAX."""
    from bonai_tpu.core.assigners import max_iou_assign as jax_assign
    from bonai_tpu_torch.core.assigners import max_iou_assign
    from bonai_tpu_torch.core.anchors import AnchorGenerator
    gen = AnchorGenerator(strides=[8, 16], ratios=[0.5, 1.0, 2.0],
                          octave_base_scale=4, scales_per_octave=3)
    anchors = np.concatenate(gen.grid_anchors([(8, 8), (4, 4)]))
    r = np.random.RandomState(6)
    xy = r.uniform(0, 50, (2, 5, 2))
    wh = r.uniform(2, 30, (2, 5, 2))
    gts = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gts[0, 0] = [1, 1, 3, 3]                    # a tiny GT: IoU << 0.4
    valid = np.ones((2, 5), bool)
    valid[1, 3:] = False
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    got, _ = max_iou_assign(t(anchors), t(gts), t(valid), **kw)
    for i in range(2):
        want, _ = _jit(lambda g, v: jax_assign(jnp.asarray(anchors), g, v,
                                               **kw), gts[i], valid[i])
        np.testing.assert_array_equal(got[i].numpy(), want)
    assert (got == -1).any() and (got[0] == 1).any()


def test_ghm_edges_and_losses_match_jax():
    """The bin edges equal ``jnp.linspace``'s to the bit (``i / bins``
    rounded once differs at 16 of 31 edges); GHM-C with ignored elements
    and GHM-R with padded rows, against JAX."""
    from bonai_tpu.models.losses import GHMC as JaxGHMC
    from bonai_tpu.models.losses import GHMR as JaxGHMR
    from bonai_tpu_torch.models.losses import GHMC, GHMR, ghm_edges
    for bins in (10, 30):
        want = np.asarray(jnp.linspace(0, 1, bins + 1))
        assert np.array_equal(np.float32(ghm_edges(bins)), want)
    rounded_once = np.float32([i / 30 for i in range(31)])
    assert (rounded_once != np.asarray(jnp.linspace(0, 1, 31))).sum() == 16
    r = np.random.RandomState(7)
    pred = r.randn(2, 300, 3).astype(np.float32) * 3
    target = (r.rand(2, 300, 3) > 0.9).astype(np.float32)
    weight = (r.rand(2, 300, 3) > 0.2).astype(np.float32)
    want = JaxGHMC(bins=30, momentum=0.75)(jnp.asarray(pred),
                                           jnp.asarray(target),
                                           jnp.asarray(weight))
    got = GHMC(bins=30, momentum=0.75)(t(pred), t(target), t(weight))
    _close(float(got), float(want), 1e-6)
    reg = r.randn(2, 300, 4).astype(np.float32) * 0.1
    tgt = r.randn(2, 300, 4).astype(np.float32) * 0.1
    w = np.repeat((r.rand(2, 300, 1) > 0.7), 4, -1).astype(np.float32)
    want = JaxGHMR(mu=0.02, bins=10, loss_weight=10.0)(
        jnp.asarray(reg), jnp.asarray(tgt), jnp.asarray(w))
    got = GHMR(mu=0.02, bins=10, loss_weight=10.0)(t(reg), t(tgt), t(w))
    _close(float(got), float(want), 1e-6)


def test_isr_p_and_carl_match_jax():
    """ISR-P's two hierarchical ranks (with exact IoU ties inside a group,
    which go to the lower index) and CARL, against JAX."""
    from bonai_tpu.models.losses import carl_loss as jax_carl
    from bonai_tpu.models.losses import isr_p as jax_isr_p
    from bonai_tpu_torch.models.losses import carl_loss, isr_p
    r = np.random.RandomState(8)
    n = 400
    pos = r.rand(n) > 0.6
    labels = r.randint(0, 3, n)
    matched = r.randint(0, 12, n)
    ious = r.rand(n).astype(np.float32)
    ious[pos.nonzero()[0][:6]] = 0.5            # exact ties
    lw = np.ones(n, np.float32)
    focal = np.where(pos, r.rand(n), 0).astype(np.float32)
    args = (lw, ious, pos, labels, matched, focal)
    want = _jit(lambda *a: jax_isr_p(*a, k=2.0, bias=0.0), *args)
    got = isr_p(*(t(a) for a in args), k=2.0, bias=0.0)
    _close(got.numpy(), want, 1e-6)
    prob = r.rand(n).astype(np.float32)
    raw = r.rand(n, 4).astype(np.float32)
    want = _jit(lambda p, m, x: jax_carl(p, m, x, k=1.0, bias=0.2,
                                         avg_factor=37.0), prob, pos, raw)
    got = carl_loss(t(prob), t(pos), t(raw), k=1.0, bias=0.2,
                    avg_factor=37.0)
    _close(float(got), float(want), 1e-6)


def test_quality_and_distribution_focal_losses_match_jax():
    from bonai_tpu.models.losses import DistributionFocalLoss, QualityFocalLoss
    from bonai_tpu_torch.models.losses import (distribution_focal_loss,
                                               quality_focal_loss)
    r = np.random.RandomState(9)
    pred = r.randn(2, 50, 3).astype(np.float32) * 2
    labels = r.randint(0, 4, (2, 50)).astype(np.int32)     # 3: background
    score = r.rand(2, 50).astype(np.float32)
    want = QualityFocalLoss(beta=2.0, reduction="none")(
        jnp.asarray(pred), (jnp.asarray(labels), jnp.asarray(score)))
    _close(quality_focal_loss(t(pred), t(labels), t(score), 2.0).numpy(),
           want, 1e-6)
    logits = r.randn(2, 50, 4, 17).astype(np.float32)
    target = r.uniform(0, 15.9, (2, 50, 4)).astype(np.float32)
    target[0, :3, 0] = [0.0, 7.0, 15.9]                    # on bins, the top
    want = DistributionFocalLoss(reduction="none")(jnp.asarray(logits),
                                                   jnp.asarray(target))
    _close(distribution_focal_loss(t(logits), t(target)).numpy(), want, 1e-6)


@pytest.mark.parametrize("linear", [False, True])
def test_iou_losses_match_jax(linear):
    """``IoULoss`` (log or linear) and ``GIoULoss`` on aligned boxes,
    degenerate and disjoint ones among them, weighted and averaged as the
    JAX classes do."""
    from bonai_tpu.models.losses import GIoULoss as JaxGIoU
    from bonai_tpu.models.losses import IoULoss as JaxIoU
    from bonai_tpu_torch.models.losses import GIoULoss, IoULoss
    r = np.random.RandomState(10)
    xy = r.uniform(0, 50, (2, 40, 2, 2))
    wh = r.uniform(0, 30, (2, 40, 2, 2))
    pred, target = (np.concatenate([xy[:, :, i], xy[:, :, i] + wh[:, :, i]],
                                   -1).astype(np.float32) for i in range(2))
    pred[0, :3] = [[5, 5, 5, 9], [0, 0, 1, 1], [80, 80, 90, 90]]
    w = r.rand(2, 40).astype(np.float32)
    for jax_cls, cls, kw in ((JaxIoU, IoULoss, dict(linear=linear)),
                             (JaxGIoU, GIoULoss, {})):
        for avg in (None, 7.0):
            want = jax_cls(eps=1e-6, loss_weight=2.0, **kw)(
                jnp.asarray(pred), jnp.asarray(target), jnp.asarray(w),
                avg_factor=avg)
            got = cls(eps=1e-6, loss_weight=2.0, **kw)(
                t(pred), t(target), t(w), avg_factor=avg)
            _close(float(got), float(want), 1e-6)


@pytest.mark.parametrize("family", SERVED)
def test_weight_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys (mmdet's), the
    port loads them strictly, and ``init_detector`` reads an mmdet-style
    ``.pth`` with and without the GN towers' conv biases (mmdet's convs
    before a norm have none: zeros then).  The JAX importer reads
    ``rpn_head.*`` unconditionally and raises ``KeyError`` on it
    (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = models(family)
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
    gn_biases = [k for k in sd if k.endswith(".conv.bias")
                 and k[:-len("conv.bias")] + "gn.weight" in sd]
    assert bool(gn_biases) == (family in ("atss", "gfl", "fcos",
                                          "fcos_axes"))
    if gn_biases:
        torch.save({k: v for k, v in sd.items() if k not in gn_biases}, pth)
        loaded = init_detector(cfg, str(pth), device="cpu",
                               dtype=torch.float32)
        for k, v in loaded.state_dict().items():
            assert torch.equal(v, torch.zeros_like(v) if k in gn_biases
                               else sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError, match="rpn_head"):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])
