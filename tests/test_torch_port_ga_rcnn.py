"""Guided-Anchoring Faster R-CNN (``configs/guided_anchoring/
ga_faster_r50_fpn_1x_bonai.py``) and FCOS's ``dcn_on_last_conv`` in
bonai_tpu_torch against the JAX package, in float32 on the CPU: GA at the
tiny widths of ``torch_port_common.ga_cfg`` (ResNet-18 at base 8, a
16-channel FPN and GA-RPN, one class), FCOS at ``dense_cfg``'s.

For GA: the RPN head's four outputs, the proposals (the location filter,
the guided anchors' decode, NMS with the levels apart), ``simple_test``;
the square and approximate anchors, the location targets with rounding
ties planted on the region edges, the approximate max-IoU shape targets
and their sample; the losses and every gradient of a step with JAX's
draws (the shape sampler's from the RPN key, the RPN sampler's from it
folded with 1, then the R-CNN's); one step's updates; the weights with
mmdetection's keys and the refusal of its four-group ``conv_offset``; and
the train CLI on two gloo ranks (DDP) with the test CLI.  For FCOS: the
deformable last tower convs' outputs, losses, gradients and keys.

Tolerances: head outputs 1e-5 of their largest value, proposals and
detections 1e-3 px (and the tests' ``compare_detections``), losses 1e-4
relative, gradients 1e-4 of their tensor's largest element, updates 1e-4
of their largest; anchors, targets, assignments and samples exact.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from test_torch_port_rcnn import IMG_SHAPE, SCALE, compare_detections
from torch_port_common import (dense_cfg, ga_cfg, jax_forward_train_draws,
                               jax_model, port_model, t, train_batch)

SIZE = 96
KEY = jax.random.PRNGKey(7)

_MODELS = {}


def models(family="ga"):
    """``(cfg, JAX model, variables)``: GA Faster R-CNN at the training
    sizes, or FCOS with ``dcn_on_last_conv``; built once."""
    if family not in _MODELS:
        if family == "ga":
            cfg = ga_cfg(train=True)
            jm, variables = jax_model(cfg, seed=0)
        else:
            cfg = dense_cfg("fcos")
            cfg.model.bbox_head.dcn_on_last_conv = True
            jm, variables = jax_model(cfg, seed=1)
        _MODELS[family] = (cfg, jm, variables)
    return _MODELS[family]


def _jit(fn, *args):
    return tpc.jax_call(fn, *args)


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


def _image(seed=0):
    return np.random.RandomState(seed).randn(2, SIZE, SIZE, 3).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the builder and the weights
# ---------------------------------------------------------------------------

def test_config_builds_at_full_width():
    """The shipped config: ``GARPNHead`` with mmdetection's keys (one
    offset group: an 18-channel ``conv_offset``), its anchors' settings,
    the inherited Faster R-CNN head with COCO's 80 classes."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.GA_CONFIG)
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == "FasterRCNN" and model.ga_rpn
    assert (model.ga_strides, model.ga_octave_base_scale,
            model.ga_scales_per_octave, model.ga_ratios,
            model.loc_filter_thr) == ([4, 8, 16, 32, 64], 8, 3,
                                      (0.5, 1.0, 2.0), 0.01)
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()
          if k.startswith("rpn_head")}
    assert sd == {
        "rpn_head.rpn_conv.weight": (256, 256, 3, 3),
        "rpn_head.rpn_conv.bias": (256,),
        "rpn_head.conv_loc.weight": (1, 256, 1, 1),
        "rpn_head.conv_loc.bias": (1,),
        "rpn_head.conv_shape.weight": (2, 256, 1, 1),
        "rpn_head.conv_shape.bias": (2,),
        "rpn_head.feature_adaption.conv_offset.weight": (18, 2, 1, 1),
        "rpn_head.feature_adaption.conv_adaption.weight": (256, 256, 3, 3),
        "rpn_head.conv_cls.weight": (1, 256, 1, 1),
        "rpn_head.conv_cls.bias": (1,),
        "rpn_head.conv_reg.weight": (4, 256, 1, 1),
        "rpn_head.conv_reg.bias": (4,)}
    assert model.roi_head["bbox_head"].fc_cls.out_features == 81


def test_weights_round_trip_and_four_offset_groups(tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys (the JAX
    ``conv_offset`` and ``adaption_kernel`` under ``feature_adaption``),
    ``init_detector`` reads them from an mmdet-style ``.pth``; a ``.pth``
    of mmdetection's four-group feature adaption (a ``(72, 2, 1, 1)``
    ``conv_offset``) raises ``ValueError`` naming its groups.  The JAX
    importer reads ``rpn_head.rpn_cls``, which a GA-RPN has not, and
    raises ``KeyError`` (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = models()
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    pm = port_model(cfg, variables)
    assert set(pm.state_dict()) == set(sd)
    np.testing.assert_array_equal(
        sd["rpn_head.feature_adaption.conv_adaption.weight"].numpy(),
        np.transpose(variables["params"]["rpn_head"]["adaption_kernel"],
                     (3, 2, 0, 1)))
    pth = tmp_path / "ga.pth"
    torch.save({"state_dict": sd, "meta": {}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    key = "rpn_head.feature_adaption.conv_offset.weight"
    sd[key] = torch.zeros(72, 2, 1, 1)
    torch.save({"state_dict": sd}, pth)
    with pytest.raises(ValueError, match="4 offset groups"):
        init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError, match="rpn_cls"):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_rpn_outputs_and_proposals_match_jax():
    """The GA-RPN's per-level logits, deltas, shapes and location logits,
    then the test proposals: the same kept set (the location filter and
    NMS), boxes within 1e-3 px, scores 1e-5.  The filter at 0.5 (the
    config's 0.01 filters none of the random model's cells) drops a part
    of them."""
    cfg = ga_cfg(train=True)
    cfg.model.rpn_head.loc_filter_thr = 0.5
    jm, variables = jax_model(cfg, seed=0)
    pm = port_model(cfg, variables)
    image = _image()
    ref_outs, ref_props = _jit(lambda v, x, s: jm.apply(
        v, x, s, method=lambda m, x, s: (
            m.rpn_head_m(m.extract_feat(x)),
            m._rpn_and_proposals(m.extract_feat(x), s,
                                 dict(m.test_cfg["rpn"]))[3:])),
        variables, image, IMG_SHAPE)
    with torch.no_grad():
        feats = pm.extract_feat(t(image))
        outs = pm.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
        props = pm._rpn_and_proposals(feats, t(IMG_SHAPE),
                                      dict(pm.test_cfg["rpn"]))
    for kind, (got, want) in enumerate(zip(outs, ref_outs)):
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w,
                   err_msg=f"output {kind} level {lvl}")
    boxes, scores, valid = (np.asarray(x) for x in ref_props)
    assert props[0].shape == boxes.shape and valid.sum() > 50
    np.testing.assert_array_equal(props[2].numpy(), valid)
    np.testing.assert_allclose(props[0].numpy()[valid], boxes[valid],
                               rtol=0, atol=1e-3)
    _close(props[1].numpy()[valid], scores[valid])
    loc = np.concatenate([np.asarray(w).reshape(2, -1) for w in ref_outs[3]],
                         1)
    assert 0.05 < (loc < 0).mean() < 0.95


def test_simple_test_matches_jax():
    cfg, jm, variables = models()
    pm = port_model(cfg, variables)
    image = _image(1)
    ref = _jit(lambda v, i, s, f: jm.apply(v, i, s, f,
                                           method="simple_test"),
               variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {"det_bboxes", "det_scores",
                                    "det_labels", "det_valid"}
    compare_detections(got, ref)


# ---------------------------------------------------------------------------
# the anchors and targets
# ---------------------------------------------------------------------------

SIZES = [(24, 24), (12, 12), (6, 6), (3, 3), (2, 2)]
STRIDES = [4, 8, 16, 32, 64]


def _gts():
    """GT boxes of two 96^2 images, a padded one among them; image 0's
    first box puts its level-0 centre region's edges on ``x.5``, where
    rounding half to even decides."""
    r = np.random.RandomState(8)
    xy = r.uniform(0, 60, (2, 5, 2))
    wh = np.exp(r.uniform(np.log(6), np.log(90), (2, 5, 2)))
    gts = np.concatenate([xy, np.minimum(xy + wh, 95)], -1).astype(
        np.float32)
    # at stride 4 the box spans cells 1.5..11.5: its centre region's
    # left edge is 0.3 * 13 + 0.4 * 1.5 = 4.5 cells, rounded to 4
    gts[0, 0] = [6, 6, 46, 46]
    valid = np.ones((2, 5), bool)
    valid[1, -1] = False
    gts[1, -1] = 0
    return gts, valid


def test_anchors_match_jax():
    """Square and approximate anchors (octave-major, 9 a cell) equal to the
    JAX package's, and the guided-anchor decode with shapes past the
    +-6 clip."""
    from bonai_tpu.models.dense_heads import ga_rpn_head as jga
    from bonai_tpu_torch.models.dense_heads import ga_rpn_head as ga
    for a, b in zip(ga.square_anchors(SIZES, STRIDES, 8),
                    jga.square_anchors(SIZES, STRIDES, 8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ga.approx_anchors(SIZES, STRIDES, 8),
                    jga.approx_anchors(SIZES, STRIDES, 8)):
        assert a.shape[1:] == (9, 4)
        np.testing.assert_array_equal(a, b)
    squares = np.concatenate(ga.square_anchors(SIZES, STRIDES, 8)).astype(
        np.float32)
    shape = np.random.RandomState(9).normal(0, 4, (2, len(squares), 2)
                                            ).astype(np.float32)
    assert (np.abs(shape) > 6).any()
    want = _jit(jax.vmap(lambda s: jga.decode_guided_anchors(
        jnp.asarray(squares), s)), shape)
    _close(ga.decode_guided_anchors(t(squares), t(shape)).numpy(), want,
           1e-6)


def test_loc_targets_match_jax():
    """Each level's location targets and weights (centre regions, ignore
    rings on the GT's level and its neighbours) and the average factor,
    exact, with a region edge planted on a rounding tie."""
    from bonai_tpu.models.dense_heads.ga_rpn_head import (
        ga_loc_targets as jax_loc)
    from bonai_tpu_torch.models.dense_heads.ga_rpn_head import (
        ga_loc_targets, region_bounds)
    gts, valid = _gts()
    r1 = (1 - 0.2) / 2
    edges = torch.stack(region_bounds(t(gts[:1, :1]) / 4.0, r1, 24, 24))
    # (1 - r1) * 0.5 * (1.5 + 11.5) + r1 * 1.5 = 3.9 + 0.6 = 4.5
    raw = (1 - r1) * 0.5 * (1.5 + 11.5) + r1 * 1.5
    assert abs(raw - 4.5) < 1e-6 and edges[0].item() == 4.0   # to even
    got_t, got_w, got_avg = ga_loc_targets(t(gts), t(valid), SIZES, STRIDES,
                                           8)
    want_t, want_w, want_avg = jax_loc(jnp.asarray(gts), jnp.asarray(valid),
                                       SIZES, STRIDES, 8)
    assert got_avg == want_avg
    for g, w in zip(got_t + got_w, list(want_t) + list(want_w)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(float(x.sum()) for x in got_t) > 10
    assert any((x == 0).any() for x in got_w)


def test_shape_targets_match_jax(monkeypatch):
    """The approximate max-IoU (the best of each cell's 9 approximate
    anchors, in chunks of any size) fed to the max-IoU assigner, the
    random sample from JAX's uniforms, the positives' mask, matched GTs
    and the sample's size, exact."""
    from bonai_tpu.core.assigners import max_iou_assign as jax_assign
    from bonai_tpu.core.boxes import bbox_overlaps as jax_iou
    from bonai_tpu.models.dense_heads.ga_rpn_head import (
        ga_shape_targets as jax_targets)
    from bonai_tpu_torch.models.dense_heads import ga_rpn_head as ga
    gts, valid = _gts()
    squares = np.concatenate(ga.square_anchors(SIZES, STRIDES, 8)).astype(
        np.float32)
    approxs = np.concatenate(ga.approx_anchors(SIZES, STRIDES, 8)).astype(
        np.float32)
    n = len(squares)
    keys = jax.random.split(KEY, 2)
    uniforms = [tpc.jax_uniforms(k, n) for k in keys]

    def draw(shape, device):
        assert tuple(shape) == (2, n)
        return tuple(torch.from_numpy(np.stack(u)) for u in zip(*uniforms))
    got = ga.ga_shape_targets(t(squares), t(approxs), t(gts), t(valid), draw,
                              sample_num=64)
    monkeypatch.setattr(ga, "APPROX_CHUNK", 100)
    iou = ga.approx_max_iou(t(approxs), t(gts))
    for i in range(2):
        want_iou = _jit(lambda g: jnp.max(jax_iou(
            jnp.asarray(approxs).reshape(-1, 4), g).reshape(n, 9, -1),
            axis=1), gts[i])
        np.testing.assert_array_equal(iou[i].numpy(), want_iou)
        want = _jit(lambda r, g, v: jax_targets(
            jnp.asarray(squares), jnp.asarray(approxs), g, v, r,
            sample_num=64), keys[i], gts[i], valid[i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
        assigned, _ = _jit(lambda g, v, o: jax_assign(
            jnp.asarray(squares), g, v, 0.7, 0.3, min_pos_iou=0.3,
            overlaps=o), gts[i], valid[i], want_iou)
        assert (np.asarray(assigned) > 0).sum() >= int(got[0][i].sum()) > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained():
    """JAX's losses and gradients of one batch under ``KEY`` and the
    port's with JAX's draws."""
    from test_torch_port_rcnn import jax_losses_and_grads
    cfg, jm, variables = models()
    batch = train_batch()
    ref, ref_grads = jax_losses_and_grads(jm, variables, batch, KEY)
    pm = port_model(cfg, variables)
    got = pm.forward_train({k: t(v) for k, v in batch.items()},
                           jax_forward_train_draws(jm, variables, KEY, 2,
                                                   ga=True))
    sum(got.values()).backward()
    return ref, got, ref_grads, pm


def test_forward_train_losses_match_jax(trained):
    ref, got, _, _ = trained
    assert set(got) == set(ref) == {
        "loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_shape", "loss_rpn_loc",
        "loss_cls", "loss_bbox"}
    for k, v in ref.items():
        assert float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax(trained):
    """Every trainable tensor's gradient: the GA-RPN's feature adaption
    (its ``conv_offset`` through the deformable sampling's offsets), its
    location and shape convs, the R-CNN head."""
    _, _, ref_grads, pm = trained
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        _close(g.numpy(), ref_grads[name].numpy(), 1e-4, err_msg=name)
    for name in ("rpn_head.feature_adaption.conv_offset.weight",
                 "rpn_head.feature_adaption.conv_adaption.weight",
                 "rpn_head.conv_loc.weight", "rpn_head.conv_shape.weight"):
        assert float(grads[name].abs().max()) > 0, name


def test_train_step_updates_match_jax():
    """One SGD step (LR 1, momentum 0.9, weight decay 1e-2) through
    ``make_train_step`` with JAX's draws: every parameter's update against
    optax's over the JAX frozen mask."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from test_torch_port_trunks import LR, WD, _jax_step
    cfg, jm, variables = models()
    batch = train_batch()
    _, _, ref, frozen = _jax_step(cfg, jm, variables, batch, KEY, None)
    pm = port_model(cfg, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    optimizer = build_optimizer(pm, dict(type="SGD", lr=LR, momentum=0.9,
                                         weight_decay=WD))
    metrics = make_train_step(pm, optimizer, lambda s: LR)(
        {k: t(v) for k, v in batch.items()}, 0,
        jax_forward_train_draws(jm, variables, KEY, 2, ga=True))
    assert np.isfinite(float(metrics["loss"]))
    for name, p in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (p.detach() - before[name]).numpy()
        if name in frozen:
            assert not want.any() and not moved.any(), name
            continue
        assert moved.any(), name
        _close(moved, want, 1e-4, err_msg=name)


def test_train_cli_ddp_and_test_cli(tmp_path):
    """Two steps of the train CLI on two gloo ranks (DDP) from four 128^2
    synthetic tiles (every trainable tensor moves), then the test CLI
    with ``--eval bbox``."""
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.tools import test as test_cli
    from bonai_tpu_torch.tools import train as train_cli
    from test_torch_port_single_stage_files import _tiles
    cfg = ga_cfg(train=True)
    _tiles(cfg, tpc.synth_data(tmp_path / "data", n=4, size=128))
    cfg.data.update(max_gt=64, workers_per_gpu=0, samples_per_gpu=1)
    cfg.compute_dtype = "float32"
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.log_config = dict(interval=1)
    cfg_path = str(tmp_path / "ga.py")
    cfg.dump(cfg_path)
    start = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    start.init_weights(torch.Generator().manual_seed(0))
    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--n-devices", "2", "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    assert {"loss_rpn_shape", "loss_rpn_loc", "loss_cls"} <= set(rows[0])
    assert all(np.isfinite(r["loss"]) for r in rows)
    trained_sd = torch.load(latest_checkpoint(str(wd)), map_location="cpu",
                            weights_only=False)["state_dict"]
    before = start.state_dict()
    frozen = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
    for name, p in start.named_parameters():
        if p.requires_grad and not name.startswith(frozen):
            assert not torch.equal(trained_sd[name], before[name]), name
    results, metrics = test_cli.main([cfg_path, latest_checkpoint(str(wd)),
                                      "--eval", "bbox", "--device", "cpu"])
    assert len(results) == 4
    assert list(metrics) == ["bbox_mAP", "bbox_mAP_50", "bbox_mAP_75"]


# ---------------------------------------------------------------------------
# FCOS's dcn_on_last_conv
# ---------------------------------------------------------------------------

def test_fcos_dcn_on_last_conv_matches_jax():
    """FCOS with each tower's last conv a modulated deformable one (mmcv's
    keys: ``conv.weight``, ``conv.conv_offset``, no conv bias), against
    JAX: head outputs, ``simple_test``, the losses and every gradient, the
    deformable convs' offset convs among them."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables = models("fcos")
    pm = port_model(cfg, variables)
    keys = set(pm.state_dict())
    assert {"bbox_head.cls_convs.1.conv.weight",
            "bbox_head.cls_convs.1.conv.conv_offset.weight",
            "bbox_head.reg_convs.1.conv.conv_offset.bias"} <= keys
    assert "bbox_head.cls_convs.1.conv.bias" not in keys
    assert "bbox_head.cls_convs.0.conv.bias" in keys
    image = np.random.RandomState(2).randn(2, 160, 160, 3).astype(np.float32)
    ref_outs = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    for kind, (got, want) in enumerate(zip(outs, ref_outs)):
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w,
                   err_msg=f"output {kind} level {lvl}")
    shape = np.array([[160, 160], [136, 150]], np.float32)
    scale = np.array([1.0, 0.8], np.float32)
    ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
               variables, image, shape, scale)
    compare_detections(pm.simple_test(t(image), t(shape), t(scale)), ref)
    batch = train_batch(size=160)

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method="forward_train")
        return sum(losses.values()), losses
    (_, want), grads = _jit(jax.value_and_grad(total, has_aux=True),
                            variables["params"], batch)
    got = pm.forward_train({k: t(v) for k, v in batch.items()})
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    sum(got.values()).backward()
    ref_grads = state_dict_from_jax(grads, variables["batch_stats"])
    for name, p in pm.named_parameters():
        if p.requires_grad:
            _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-4,
                   err_msg=name)
    assert float(pm.bbox_head.cls_convs[1].conv.conv_offset.weight.grad
                 .abs().max()) > 0
