"""RepPoints, FSAF and FoveaBox in bonai_tpu_torch against the JAX package,
at the tiny widths of ``torch_port_common.dense_cfg`` (ResNet-18 at base
8, a 16-channel FPN with ``start_level=1``, extra convs and 5 outputs,
two 64-channel tower convs, RepPoints' point features 32 channels) in
float32 on the CPU, on their BONAI configs at 160^2: head outputs,
``simple_test``, losses and every gradient; the point assigner with
planted exact ties, FSAF's region masks, owners, TBLR targets and level
selection, FoveaBox's fovea targets at the cells' half-cell edges; the
bounded IoU loss; RepPoints' head alone under each ``transform_method``,
``use_grid_points`` and ``center_init``, and its point sets as the
deformable convs' offsets; one training step's updates; the weights; and
RepPoints through the train and test CLIs.

The training batch widens four GTs an image to 24..150 px, so that FSAF's
centre regions (a fifth of a GT's sides) hold cell centres on every
level and FoveaBox's scale ranges reach past the first level.

Tolerances: head outputs 1e-5 of their largest value, losses 1e-4
relative, gradients 1e-4 of their tensor's largest element (updates of
their largest update), detections 1e-3 px with identical keep sets,
targets, assignments, masks and owners exact, FSAF's level selection
exact where its two best levels' losses differ by more than float noise
(1e-5 of their value).
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from torch_port_common import dense_cfg, jax_model, port_model, t, train_batch

FAMILIES = ("reppoints", "fsaf", "fovea")
SIZE = 160
IMG_SHAPE = np.array([[160, 160], [136, 150]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)
LOSSES = {"reppoints": {"loss_cls", "loss_pts_init", "loss_pts_refine"},
          "fsaf": {"loss_cls", "loss_bbox"},
          "fovea": {"loss_cls", "loss_bbox"}}

_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` (weights of seed 1),
    built once."""
    if family not in _MODELS:
        cfg = dense_cfg(family)
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


def point_batch(seed=0):
    """``train_batch`` at 160^2 with each image's first four GTs widened to
    24..150 px (log-uniform), the first image's first GT the whole image:
    the one GT whose FSAF centre region (``[64, 96]`` on both axes) holds
    a cell centre of every level, so that it trains on the level it
    selects (a GT without a cell on some level selects that level, at
    mean loss 0, and trains on none: the JAX package's selection)."""
    batch = train_batch(seed=seed, size=SIZE)
    r = np.random.RandomState(seed + 10)
    wh = np.exp(r.uniform(np.log(24), np.log(150), (2, 4, 2)))
    xy = r.uniform(0, 1, (2, 4, 2)) * (SIZE - 1 - wh)
    batch["gt_bboxes"][:, :4] = np.concatenate([xy, xy + wh], -1)
    batch["gt_bboxes"][0, 0] = [0, 0, SIZE, SIZE]
    return batch


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_configs_build_at_full_width(family):
    """The shipped BONAI config with mmdetection's keys: the head's towers
    (RepPoints' with GroupNorm), outputs, deformable convs and
    ``moment_transfer``; the FPN's extra convs from C5 (RepPoints'
    ``on_input``) or from its output."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.POINT_CONFIGS[family])
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == cfg.model.type
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert not any(k.startswith(("rpn_head", "roi_head")) for k in sd)
    assert sd["neck.fpn_convs.3.conv.weight"] == (256, 2048, 3, 3)
    h = "bbox_head."
    conv = (256, 256, 3, 3)
    if family == "reppoints":
        want = {"cls_convs.2.conv.weight": conv, "reg_convs.2.gn.weight":
                (256,), "reppoints_cls_conv.weight": conv,
                "reppoints_cls_out.weight": (1, 256, 1, 1),
                "reppoints_pts_init_conv.weight": conv,
                "reppoints_pts_init_out.weight": (18, 256, 1, 1),
                "reppoints_pts_refine_conv.weight": conv,
                "reppoints_pts_refine_out.weight": (18, 256, 1, 1),
                "moment_transfer": (2,)}
        assert h + "reppoints_cls_conv.bias" not in sd
        assert model.loss_kw["init_assigner"] == "point"
    else:
        out = "retina" if family == "fsaf" else "conv"
        want = {"cls_convs.3.conv.weight": conv,
                f"{out}_cls.weight": (1, 256, 3, 3),
                f"{out}_reg.weight": (4, 256, 3, 3)}
        assert not any(".gn." in k for k in sd)
    for k, shape in want.items():
        assert sd[h + k] == shape, k
    if family == "fovea":
        assert model.focal_gamma == 1.5 and model.focal_alpha == 0.4
        assert model.loss_kw["scale_ranges"][-1] == (256, 2048)


@pytest.mark.parametrize("family", ["fovea_align", "fovea_alias"])
def test_fovea_options(family):
    """``with_deform`` (the COCO ``fovea_align`` configs) raises A6; the
    ``FOVEA`` type builds a ``FoveaBox``, with GroupNorm towers from a
    ``norm_cfg`` of type GN."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(f"{tpc.ROOT}/configs/foveabox/"
                          "fovea_align_r50_fpn_gn-head_4x4_2x_coco.py")
    assert cfg.model.bbox_head.with_deform
    if family == "fovea_align":
        with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
        return
    cfg.model.bbox_head.with_deform = False
    cfg.model.type = "FOVEA"
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == "FoveaBox"
    assert model.bbox_head.cls_convs[0].gn.num_groups == 32


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_head_outputs_and_detections_match_jax(family):
    """Every level's head outputs (RepPoints': logits, both point sets and
    ``moment_transfer``), then ``simple_test``'s detections."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(
        np.float32)
    ref_outs = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    assert len(outs) == len(ref_outs) == (4 if family == "reppoints" else 2)
    for kind, (got, want) in enumerate(zip(outs, ref_outs)):
        if kind == 3:                           # moment_transfer
            np.testing.assert_array_equal(got.detach().numpy(), want)
            continue
        assert len(got) == len(want) == 5
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(g.permute(0, 2, 3, 1).numpy(), w,
                   err_msg=f"output {kind} level {lvl}")
    ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
               variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    np.testing.assert_allclose(got["det_bboxes"].numpy()[valid],
                               np.asarray(ref["det_bboxes"])[valid],
                               rtol=0, atol=1e-3)
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
        batch = point_batch()

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


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_losses_match_jax(family):
    ref, got, _, _ = trained(family)
    assert set(got) == set(ref) == LOSSES[family]
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """Every trainable tensor's gradient (RepPoints': both deformable
    kernels, the init branch through the 0.1 gradient mix, and
    ``moment_transfer`` through the 0.01 one)."""
    _, _, ref_grads, pm = trained(family)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        _close(g.numpy(), ref, 1e-4, err_msg=name)
    nonzero = ["neck.fpn_convs.4.conv.weight",
               "bbox_head.cls_convs.0.conv.weight"]
    if family == "reppoints":
        nonzero += ["bbox_head.reppoints_cls_conv.weight",
                    "bbox_head.reppoints_pts_refine_conv.weight",
                    "bbox_head.reppoints_pts_init_out.weight",
                    "bbox_head.moment_transfer"]
    for name in nonzero:
        assert float(grads[name].abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------

def test_point_assign_matches_jax_with_exact_ties():
    """The point assigner on a two-level grid (stride 8 and 16): GT 0's
    centre lies between four stride-8 points at one distance (``pos_num``
    1 takes the lowest index, 2 the two lowest); GT 1's centre lies
    between points 35 and 36, GT 2's on point 35, which both take (GT 2,
    the nearer, wins); a padded GT never assigns; random GTs besides (away
    from these points in image 0), against JAX at ``pos_num`` 1 and 2."""
    from bonai_tpu.models.dense_heads.reppoints_head import (
        point_assign as jax_assign)
    from bonai_tpu_torch.models.dense_heads.reppoints_head import point_assign
    from bonai_tpu_torch.models.detectors.single_stage import point_centres
    centres = np.concatenate(point_centres([(8, 8), (4, 4)], (8, 16)))
    lvls = np.array([3] * 64 + [4] * 16, np.int32)
    r = np.random.RandomState(3)
    gts = np.zeros((2, 6, 4), np.float32)
    gts[0, 0] = [12, 12, 44, 44]            # centre (28, 28), 32 px: level 3
    gts[0, 1] = [20, 24, 36, 40]            # centre (28, 32)
    gts[0, 2] = [14, 22, 34, 42]            # centre (24, 32): point 35
    xy = r.uniform(0, 60, (2, 3, 2))
    xy[0] = r.uniform(60, 80, (3, 2))
    wh = r.uniform(20, 70, (2, 3, 2))
    gts[:, 3:] = np.concatenate([xy, xy + wh], -1)
    valid = np.ones((2, 6), bool)
    valid[1, -1] = False
    for pos_num in (1, 2):
        got = point_assign(t(centres), t(lvls), t(gts), t(valid),
                           pos_num=pos_num).numpy()
        for i in range(2):
            want = _jit(lambda g, v: jax_assign(
                jnp.asarray(centres), jnp.asarray(lvls), g, v,
                pos_num=pos_num), gts[i], valid[i])
            np.testing.assert_array_equal(got[i], want)
        dist = np.hypot(centres[:64, 0] - 28.0, centres[:64, 1] - 28.0)
        tied = np.flatnonzero(dist == dist.min())
        assert tied.tolist() == [27, 28, 35, 36]
        assert (got[0, tied] == 1).tolist() == [True] * pos_num + [
            False] * (4 - pos_num)
        assert got[0, 35] == 3 and got[0, 36] == (0 if pos_num == 1 else 2)
        assert not (got[1] == 6).any()


def _jax_fsaf_selection(cls_scores, reg_preds, batch, strides):
    """JAX's per-(GT, level) mean losses of FSAF's online selection, the
    first pass of ``fsaf_loss``, from the JAX package's functions."""
    from bonai_tpu.models.dense_heads.fsaf_head import (
        _iou_loss_cells, fsaf_level_masks, fsaf_tblr_targets)
    from bonai_tpu.models.losses import sigmoid_focal_loss
    g = batch["gt_bboxes"].shape[1]
    out = []
    for cs, rp, s in zip(cls_scores, reg_preds, strides):
        h, w = cs.shape[1:3]

        def one(gb, gv, gl, c, r):
            in_pos, _ = fsaf_level_masks(gb, gv, h, w, s)
            focal = sigmoid_focal_loss(
                c[None], jnp.broadcast_to(jax.nn.one_hot(gl, 1)[
                    :, None, None, :], (g, h, w, 1)), reduction="none")
            iou = _iou_loss_cells(r[None], fsaf_tblr_targets(gb, h, w, s))
            per = (jnp.sum(jnp.where(in_pos[..., None], focal, 0.0),
                           axis=(1, 2, 3))
                   + jnp.sum(jnp.where(in_pos, iou, 0.0), axis=(1, 2)))
            return per / jnp.maximum(jnp.sum(in_pos, axis=(1, 2)), 1.0)
        out.append(jax.vmap(one)(batch["gt_bboxes"], batch["gt_valid"],
                                 batch["gt_labels"], cs, rp))
    return jnp.stack(out)


def test_fsaf_targets_match_jax():
    """Each level's centre-region masks and min-area owners (a contested
    cell planted: two GTs of one area, the first wins), the TBLR targets
    and the online level selection of the tiny FSAF's outputs on the
    training batch, against JAX; a GT too small for any level's cell
    centre has equal (zero) losses everywhere and takes level 0 in both."""
    from bonai_tpu.models.dense_heads.fsaf_head import (
        fsaf_level_masks as jax_masks)
    from bonai_tpu.models.dense_heads.fsaf_head import (
        fsaf_tblr_targets as jax_tblr)
    from bonai_tpu_torch.models.dense_heads.fsaf_head import (
        fsaf_level_masks, fsaf_targets, fsaf_tblr_targets)
    cfg, jm, variables = models("fsaf")
    batch = point_batch()
    batch["gt_bboxes"][0, 4] = [40, 40, 80, 80]
    batch["gt_bboxes"][0, 5] = [44, 40, 84, 80]      # the same area, shifted
    batch["gt_bboxes"][1, 3] = [70, 70, 73, 73]      # no cell centre inside
    strides = (8, 16, 32, 64, 128)
    ref_outs = _jit(lambda v, x: jm.apply(v, x), variables, batch["image"])
    pm = port_model(cfg, variables)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(batch["image"])))
        per_level, sel = fsaf_targets(*outs, t(batch["gt_bboxes"]),
                                      t(batch["gt_valid"]),
                                      t(batch["gt_labels"]), 1, strides)
    contested = 0
    for (in_pos, owner, tblr), cs, s in zip(per_level, outs[0], strides):
        h, w = cs.shape[2:]
        for i in range(2):
            want_in, want_owner = _jit(
                lambda gb, gv: jax_masks(gb, gv, h, w, s),
                batch["gt_bboxes"][i], batch["gt_valid"][i])
            np.testing.assert_array_equal(in_pos[i].numpy(), want_in)
            np.testing.assert_array_equal(owner[i].numpy(), want_owner)
            _close(tblr[i].numpy(), _jit(lambda gb: jax_tblr(gb, h, w, s),
                                         batch["gt_bboxes"][i]), 1e-6)
        both = in_pos[0, 4] & in_pos[0, 5]
        assert bool((owner[0][both] == 4).all())
        contested += int(both.sum())
    assert contested > 0
    assert all(not in_pos[1, 3].any() for in_pos, _, _ in per_level)
    losses = np.asarray(_jit(lambda o: _jax_fsaf_selection(
        *o, batch, strides), ref_outs))                 # (L, B, G)
    want = losses.argmin(0)
    got = sel.numpy()
    best = np.sort(losses, 0)
    near = best[1] - best[0] <= 1e-5 * np.maximum(best[0], 1e-12)
    real = batch["gt_valid"] & ~((np.arange(6) == 3) & (np.arange(2) == 1)[
        :, None])
    np.testing.assert_array_equal(got[real & ~near], want[real & ~near])
    assert got[1, 3] == want[1, 3] == 0
    assert len(set(got[real].tolist())) > 1           # several levels chosen


def test_fovea_targets_match_jax():
    """Each level's fovea labels, log targets and positives against JAX,
    the BONAI config's scale ranges and ``sigma`` 0.4.  At stride 8 GT 1's
    shrunk edges less half a cell land exactly on cells 4 and 6, where
    ``ceil``/``floor`` keep them; GT 0 (cells 4..5) and GT 1 (4..6) have
    one area, and the first wins the cells they share; in image 1 GT 1,
    smaller, wins the cells it shares with GT 0."""
    from bonai_tpu.models.dense_heads.fovea_head import (
        fovea_targets_level as jax_targets)
    from bonai_tpu_torch.models.dense_heads.fovea_head import (
        fovea_targets_level)
    bh = models("fovea")[0].model.bbox_head
    r = np.random.RandomState(7)
    gts = np.zeros((2, 6, 4), np.float32)
    gts[0, 0] = [20, 20, 60, 60]
    gts[0, 1] = [24, 24, 64, 64]
    gts[1, 0] = [10, 10, 100, 100]
    gts[1, 1] = [30, 30, 50, 50]
    xy = r.uniform(0, 100, (2, 3, 2))
    wh = np.exp(r.uniform(np.log(8), np.log(150), (2, 3, 2)))
    gts[:, 2:5] = np.concatenate([xy, xy + wh], -1)
    valid = np.ones((2, 6), bool)
    valid[:, 5] = False
    valid[0, 2:5] = False                       # image 0: the planted two
    labels = np.zeros((2, 6), np.int32)
    hits = 0
    for lvl, (st, bl, bounds) in enumerate(zip(
            bh.strides, bh.base_edge_list, bh.scale_ranges)):
        h = w = int(np.ceil(SIZE / st))
        got = fovea_targets_level(t(gts), t(valid), t(labels), h, w,
                                  float(st), float(bl), tuple(bounds),
                                  bh.sigma, 1)
        for i in range(2):
            want = _jit(lambda gb, gv, gl: jax_targets(
                gb, gv, gl, h, w, float(st), float(bl), tuple(bounds),
                bh.sigma, 1), gts[i], valid[i], labels[i])
            np.testing.assert_array_equal(got[0][i].numpy(), want[0])
            np.testing.assert_array_equal(got[2][i].numpy(), want[2])
            _close(got[1][i].numpy(), want[1], 1e-6)
        hits += int(got[2].sum())
        if lvl == 0:
            pos = got[2][0].reshape(h, w).numpy()
            assert pos[4:7, 4:7].all() and pos.sum() == 9
            tgt = got[1][0].reshape(h, w, 4).numpy()
            # cell (4, 4)'s corner (32, 32): GT 0's left distance 12 px
            # over the base edge 16, not GT 1's 8
            np.testing.assert_allclose(tgt[4, 4, 0], np.log(12 / 16),
                                       rtol=1e-6)
            np.testing.assert_allclose(tgt[6, 6, 0], np.log(24 / 16),
                                       rtol=1e-6)
    assert hits > 20


def test_bounded_iou_loss_matches_jax():
    """Each term's value and the gradient with respect to the prediction
    (none reaches the target), over boxes near and far from their targets,
    inside and past ``beta``."""
    from bonai_tpu.models.losses import bounded_iou_loss as jax_loss
    from bonai_tpu_torch.models.losses import bounded_iou_loss
    r = np.random.RandomState(4)
    tgt = np.concatenate([r.uniform(0, 50, (64, 2)),
                          r.uniform(60, 120, (64, 2))], -1).astype(np.float32)
    pred = (tgt + r.normal(0, 1, (64, 4)) * np.array([1, 1, 1, 1])
            * r.choice([0.5, 5.0, 30.0], (64, 1))).astype(np.float32)
    w = r.rand(64, 4).astype(np.float32)
    want = _jit(lambda p, g: jax_loss(p, g, beta=0.2), pred, tgt)
    gp, gt = _jit(jax.grad(lambda p, g: jnp.sum(jax_loss(p, g) * w),
                           argnums=(0, 1)), pred, tgt)
    assert not np.asarray(gt).any()
    p, g = t(pred).requires_grad_(), t(tgt).requires_grad_()
    got = bounded_iou_loss(p, g, beta=0.2)
    (got * t(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-6)
    want = np.asarray(want)
    assert (want < 0.2 * 0.5).any() and (want > 0.2).any()
    _close(p.grad.numpy(), gp, 1e-5)
    assert g.grad is None or not g.grad.any()


# ---------------------------------------------------------------------------
# RepPoints' head alone
# ---------------------------------------------------------------------------

HEAD_AXES = {"moment": {}, "minmax": dict(transform_method="minmax"),
             "partial_minmax": dict(transform_method="partial_minmax"),
             "grid": dict(use_grid_points=True, transform_method="minmax"),
             "no_center_init": dict(center_init=False)}


@pytest.mark.parametrize("axis", sorted(HEAD_AXES))
def test_reppoints_head_axes_match_jax(axis):
    """``RepPointsHead`` (one 64-channel tower conv a branch: two channels
    to each GroupNorm group, whose conv bias then has a gradient) on two
    random 8-channel levels under each
    transform, the grid-points representation (with the configs'
    ``MaxIoUAssigner`` init) and ``center_init=False``: its outputs, then
    ``reppoints_loss`` on them and the head's every gradient through it,
    against JAX."""
    from bonai_tpu.models.dense_heads.reppoints_head import (
        RepPointsHead as JaxHead)
    from bonai_tpu.models.dense_heads.reppoints_head import (
        reppoints_loss as jax_loss)
    from bonai_tpu_torch.models.dense_heads.reppoints_head import (
        RepPointsHead, reppoints_loss)
    from bonai_tpu_torch.models.detectors.single_stage import point_centres
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    kw = HEAD_AXES[axis]
    r = np.random.RandomState(5)
    feats = [r.randn(2, s, s, 8).astype(np.float32) for s in (16, 8)]
    jhead = JaxHead(num_classes=2, in_channels=8, feat_channels=64,
                    point_feat_channels=8, stacked_convs=1, **kw)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), feats)
    params = tpc._random_tree(shapes["params"], r)
    sd = state_dict_from_jax({"backbone": {}, "neck": {}, "bbox_head":
                              params}, {"backbone": {}})
    head = RepPointsHead(2, 8, 64, 8, 1, **kw)
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()})
    ref = _jit(lambda p, x: jhead.apply({"params": p}, x), params, feats)
    outs = head([t(f).permute(0, 3, 1, 2) for f in feats])
    for kind in range(3):
        for g, w in zip(outs[kind], ref[kind]):
            _close(g.detach().permute(0, 2, 3, 1).numpy(), w,
                   err_msg=f"output {kind}")
    strides = (8, 16)
    centres = np.concatenate(point_centres([(16, 16), (8, 8)], strides))
    sflat = np.repeat(np.float32(strides), [256, 64])
    lvls = np.repeat(np.int32([3, 4]), [256, 64])
    batch = point_batch()
    batch["gt_labels"] = r.randint(0, 2, (2, 6)).astype(np.int32)
    args = (batch["gt_bboxes"], batch["gt_valid"], batch["gt_labels"])
    lkw = dict(num_points=9, transform_method=kw.get("transform_method",
                                                     "moment"),
               init_assigner="max_iou" if axis == "grid" else "point")

    def jax_total(p, x):
        o = jhead.apply({"params": p}, x)
        losses = jax_loss(*o, jnp.asarray(centres), jnp.asarray(sflat),
                          jnp.asarray(lvls), *map(jnp.asarray, args), 2,
                          **lkw)
        return sum(losses.values()), losses
    (_, want), grads = _jit(jax.value_and_grad(jax_total, has_aux=True),
                            params, feats)
    got = reppoints_loss(*outs, t(centres), t(sflat), t(lvls),
                         *(t(a) for a in args), 2, **lkw)
    for k, v in want.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    sum(got.values()).backward()
    ref_grads = state_dict_from_jax({"backbone": {}, "neck": {},
                                     "bbox_head": grads}, {"backbone": {}})
    for name, p in head.named_parameters():
        want_g = ref_grads["bbox_head." + name].numpy()
        if name == "moment_transfer" and axis != "moment" \
                and axis != "no_center_init":
            assert p.grad is None and not want_g.any()
            continue
        _close(p.grad.numpy(), want_g, 1e-4, err_msg=name)


def test_reppoints_point_sets_steer_the_deformable_conv_y_first():
    """A planted non-symmetric point set (point ``k`` at ``(dy, dx) =
    (0.3 k - 1, 1.1 - 0.7 k)`` strides): the port's deformable conv, fed
    ``points - base``, equals JAX's ``deform_conv2d`` fed the same y-first
    offsets; the same points read x-first give another output, so a
    swapped pair cannot pass."""
    from bonai_tpu.ops.deform_conv import deform_conv2d as jax_dcn
    from bonai_tpu_torch.models.dense_heads.reppoints_head import base_grid
    from bonai_tpu_torch.ops.deform_conv import DeformConv2d
    r = np.random.RandomState(6)
    x = r.randn(1, 9, 11, 4).astype(np.float32)
    k = np.arange(9, dtype=np.float32)
    pts = np.stack([0.3 * k - 1.0, 1.1 - 0.7 * k], 1).reshape(-1)
    kernel = r.randn(3, 3, 4, 5).astype(np.float32)
    offset = np.broadcast_to(pts - base_grid(3), (1, 9, 11, 18)).astype(
        np.float32)
    want = _jit(jax_dcn, x, offset, kernel)
    conv = DeformConv2d(4, 5, 3)
    with torch.no_grad():
        conv.weight.copy_(t(kernel.transpose(3, 2, 0, 1)))
        got = conv(t(x).permute(0, 3, 1, 2),
                   t(offset).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        swapped = pts.reshape(9, 2)[:, ::-1].reshape(-1)
        other = conv(t(x).permute(0, 3, 1, 2), t(np.broadcast_to(
            swapped - base_grid(3), (1, 9, 11, 18)).astype(np.float32))
            .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want)
    assert float((other - got).abs().max()) > 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# one training step, the weights, the CLIs
# ---------------------------------------------------------------------------

def test_reppoints_train_step_updates_match_jax():
    """One SGD step (LR 1, momentum 0.9, weight decay 1e-2, the config's
    clip) of RepPoints through ``make_train_step``: every parameter's
    update against optax's over the JAX frozen mask."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from test_torch_port_trunks import LR, WD, _jax_step
    cfg, jm, variables = models("reppoints")
    batch = point_batch()
    max_norm = cfg.optimizer_config.grad_clip.max_norm
    _, _, ref, frozen = _jax_step(cfg, jm, variables, batch,
                                  jax.random.PRNGKey(0), max_norm)
    pm = port_model(cfg, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    optimizer = build_optimizer(pm, dict(type="SGD", lr=LR, momentum=0.9,
                                         weight_decay=WD))
    metrics = make_train_step(pm, optimizer, lambda s: LR,
                              max_norm=max_norm)(
        {k: t(v) for k, v in batch.items()}, 0, None)
    assert np.isfinite(metrics["loss"])
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert {n for n, p in pm.named_parameters() if id(p) not in held} \
        == frozen
    for name, p in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (p.detach() - before[name]).numpy()
        if name in frozen:
            assert not want.any() and not moved.any(), name
            continue
        assert moved.any(), name
        _close(moved, want, 1e-4, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_weight_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys, the port
    loads them strictly, and ``init_detector`` reads an mmdet-style
    ``.pth`` (RepPoints' without its GN towers' conv biases: zeros then).
    The JAX importer reads ``rpn_head.*`` unconditionally and raises
    ``KeyError`` (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = models(family)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    pm = port_model(cfg, variables)
    assert set(pm.state_dict()) == set(sd)
    gn_biases = [k for k in sd if k.endswith(".conv.bias")
                 and k[:-len("conv.bias")] + "gn.weight" in sd]
    assert bool(gn_biases) == (family == "reppoints")
    pth = tmp_path / "mmdet.pth"
    torch.save({"state_dict": {k: v for k, v in sd.items()
                               if k not in gn_biases}, "meta": {}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, torch.zeros_like(v) if k in gn_biases
                           else sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError, match="rpn_head"):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])


def test_reppoints_train_and_test_clis_match_jax(tmp_path):
    """RepPoints trained 2 steps through the train CLI on four 128^2
    synthetic tiles from an mmdet-style ``.pth``, then the test CLI with
    ``--eval bbox``: its results per image equal the JAX package's test
    loop on the trained weights (boxes within 1e-3 px, scores 1e-5)."""
    from bonai_tpu.apis import run_inference as jax_run_inference
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    from bonai_tpu_torch.tools import train as train_cli
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    from test_torch_port_single_stage_files import _tiles, jax_variables
    data = tpc.synth_data(tmp_path / "data", n=4, size=128)
    cfg = dense_cfg("reppoints")
    _tiles(cfg, data)
    cfg.data.max_gt = 64
    cfg.compute_dtype = "float32"
    cfg.log_config = dict(interval=1)
    cfg.lr_config.warmup = None
    jm, variables = jax_model(cfg, seed=1)
    torch.save({"state_dict": state_dict_from_jax(
        variables["params"], variables["batch_stats"])},
        tmp_path / "start.pth")
    cfg.load_from = str(tmp_path / "start.pth")
    cfg_path = str(tmp_path / "reppoints.py")
    cfg.dump(cfg_path)
    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    for r in rows:
        assert LOSSES["reppoints"] <= set(r)
        assert all(np.isfinite(r[k]) for k in r if k.startswith("loss"))
    ckpt = latest_checkpoint(str(wd))
    trained_sd = torch.load(ckpt, map_location="cpu",
                            weights_only=False)["state_dict"]
    results, metrics = test_cli.main([cfg_path, ckpt, "--eval", "bbox",
                                      "--out", str(tmp_path / "r.pkl"),
                                      "--device", "cpu"])
    assert list(metrics) == ["bbox_mAP", "bbox_mAP_50", "bbox_mAP_75"]
    ref = jax_run_inference(
        jm, jax_variables(trained_sd, variables), jax_build_dataloader(
            jax_build_dataset(copy.deepcopy(dict(cfg.data.test,
                                                 test_mode=True))),
            2, shuffle=False, train=False), progress=False)
    assert len(results) == len(ref) == 4
    for got, want in zip(results, ref):
        assert len(got) == len(want) == 1 and len(got[0]) > 5
        np.testing.assert_allclose(got[0][:, :4], want[0][:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(got[0][:, 4], want[0][:, 4], rtol=0,
                                   atol=1e-5)
