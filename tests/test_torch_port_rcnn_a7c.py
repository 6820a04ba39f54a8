"""Grid R-CNN and PointRend on BONAI in bonai_tpu_torch against the JAX
package, at the tiny widths of ``torch_port_common`` in float32 on the CPU:
``configs/grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_bonai.py`` (a box head
without ``fc_reg``, the grid head on jittered positives) and
``configs/point_rend/point_rend_r50_fpn_2x_bonai.py`` (the coarse mask
head through the single-level ``GenericRoIExtractor``, the point head, the
subdivision steps); their modules and functions, and their weights.

Tolerances: boxes 1e-3 px, scores 1e-5, mask probabilities 1e-4, labels
and validity exact; each loss 1e-5 relative, each gradient 1e-4 of its
tensor's largest magnitude; the grid, coarse and point heads 1e-5 of their
output's largest magnitude; the point and RoI samplers and the resize
1e-6 of it; the targets, the uncertain points and the weights exact; the
grid vote 1e-4 px.
"""

import numpy as np
import pytest
import torch

import jax
import torch_port_common as tpc
from test_torch_port_rcnn import IMG_SHAPE, SCALE
from torch_port_common import (a7_cfg, jax_forward_train_draws, jax_model,
                               port_model, t, train_batch)

FAMILIES = ("grid", "point_rend")

_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` at the training sizes,
    weights of seed 1, built once."""
    if family not in _MODELS:
        cfg = a7_cfg(family, train=True)
        _MODELS[family] = (cfg, *jax_model(cfg, seed=1))
    return _MODELS[family]


def _jit(fn, *args):
    """``fn(*args)`` through ``jax.jit``, on the host.  The point and RoI
    samplers run op by op instead: XLA's fused code rounds their bilinear
    sums differently (fused multiply-adds) by up to 3e-6 of the largest
    value, where the port's agree with JAX's op-by-op sums to 1e-6 and its
    ties to the bit."""
    return jax.device_get(jax.jit(fn)(*args))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_build_at_full_width(family):
    """``build_detector`` builds the shipped config with mmdet's module
    layout: Grid R-CNN's box head without ``fc_reg`` and its grouped grid
    head; PointRend's coarse head behind a stride-4 ``GenericRoIExtractor``
    and its point head of ``Conv1d`` weights."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.A7_CONFIGS[family])
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    sd = model.state_dict()
    heads = {k.split(".")[1] for k in sd if k.startswith("roi_head.")}
    if family == "grid":
        assert type(model).__name__ == "GridRCNN"
        assert heads == {"bbox_head", "grid_head"}
        assert not any("fc_reg" in k for k in sd)
        g = "roi_head.grid_head."
        shapes = {"convs.0.conv.weight": (576, 256, 3, 3),
                  "convs.7.conv.bias": (576,), "convs.7.gn.weight": (576,),
                  "forder_trans.4.3.0.weight": (64, 1, 5, 5),
                  "sorder_trans.8.1.1.weight": (64, 64, 1, 1),
                  "deconv1.weight": (576, 64, 4, 4), "norm1.weight": (576,),
                  "deconv2.weight": (576, 1, 4, 4), "deconv2.bias": (9,)}
        assert "forder_trans.0.2.0.weight" not in {k[len(g):] for k in sd}
        assert sum(k.startswith(g + "forder_trans") for k in sd) == 24 * 4
        assert model.grid_extractor_cfg["roi_layer"]["output_size"] == 14
        assert model.grid_loss_weight == 15
    else:
        assert type(model).__name__ == "PointRend"
        assert heads == {"bbox_head", "mask_head", "point_head"}
        assert model.mask_extractor_cfg["type"] == "GenericRoIExtractor"
        assert model.point_stride == 4
        g = "roi_head."
        shapes = {"mask_head.downsample_conv.conv.weight": (256, 256, 2, 2),
                  "mask_head.fcs.0.weight": (1024, 256 * 49),
                  "mask_head.fc_logits.weight": (49, 1024),
                  "point_head.fcs.0.conv.weight": (256, 257, 1),
                  "point_head.fcs.2.conv.weight": (256, 257, 1),
                  "point_head.fc_logits.weight": (1, 257, 1)}
        model.init_weights(torch.Generator().manual_seed(0))
        assert bool((model.roi_head["mask_head"].fc_logits.weight
                     == 0.001).all())
    for k, shape in shapes.items():
        assert tuple(sd[g + k].shape) == shape, k


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _recording(fn, calls, jax_side):
    """``uncertainty_points_test`` that records each call's indices and
    map (in a JAX jit through an ordered debug callback)."""
    def wrapped(logits, k):
        idx, rel = fn(logits, k)
        if jax_side:
            jax.debug.callback(lambda i, m: calls.append(
                (np.asarray(i), np.asarray(m))), idx, logits, ordered=True)
        else:
            calls.append((idx.numpy(), logits.numpy()))
        return idx, rel
    return wrapped


_SERVED = {}


def served(family, monkeypatch):
    """JAX's and the port's ``simple_test`` of one batch, and for PointRend
    each subdivision step's uncertain cells and map in both, once."""
    if family not in _SERVED:
        import bonai_tpu.models.detectors.point_rend as jax_pr
        import bonai_tpu_torch.models.detectors.point_rend as port_pr
        cfg, jm, variables = models(family)
        pm = port_model(cfg, variables)
        image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(
            np.float32)
        jax_calls, port_calls = [], []
        monkeypatch.setattr(jax_pr, "uncertainty_points_test", _recording(
            jax_pr.uncertainty_points_test, jax_calls, True))
        monkeypatch.setattr(port_pr, "uncertainty_points_test", _recording(
            port_pr.uncertainty_points_test, port_calls, False))
        ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
                   variables, image, IMG_SHAPE, SCALE)
        jax.effects_barrier()
        got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
        _SERVED[family] = (ref, got, jax_calls, port_calls)
    return _SERVED[family]


def _subdivision_agrees(jax_calls, port_calls, valid):
    """The RoIs whose refined cells are the same set in both packages at
    every subdivision step.  Where a RoI's sets first differ, every cell
    in one set and not the other must lie within float noise (1e-5 of the
    map's largest magnitude) of the step's last chosen uncertainty in
    JAX's map: a tie broken the other way by the two packages' last bits,
    which then moves that cell's value from the upsampled map to the point
    head's."""
    assert len(jax_calls) == len(port_calls) == 3     # 56^2, 112^2, 224^2
    agrees = valid.copy()
    for (ji, jm), (pi, _) in zip(jax_calls, port_calls):
        assert ji.shape == pi.shape == (valid.size, 784)
        for n in np.flatnonzero(agrees):
            moved = set(ji[n]) ^ set(pi[n])
            if not moved:
                continue
            u = -np.abs(jm[n].reshape(-1))
            kth = u[ji[n][-1]]
            assert max(abs(u[c] - kth) for c in moved) \
                <= 1e-5 * np.abs(u).max(), n
            agrees[n] = False
    return agrees


@pytest.mark.parametrize("family", FAMILIES)
def test_simple_test_matches_jax(family, monkeypatch):
    """Grid R-CNN's boxes are its grid votes; PointRend's ``mask_probs``
    are 224^2, held to JAX's on every RoI whose refined cells are JAX's at
    each step (see ``_subdivision_agrees``)."""
    ref, got, jax_calls, port_calls = served(family, monkeypatch)
    keys = {"det_bboxes", "det_scores", "det_labels", "det_valid"}
    assert set(got) == set(ref) == keys | (
        {"mask_probs"} if family == "point_rend" else set())
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    np.testing.assert_allclose(got["det_bboxes"].numpy()[valid],
                               np.asarray(ref["det_bboxes"])[valid], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["det_scores"].numpy()[valid],
                               np.asarray(ref["det_scores"])[valid], rtol=0,
                               atol=1e-5)
    if family == "grid":
        return
    assert got["mask_probs"].shape == (2, 32, 224, 224)
    agrees = _subdivision_agrees(jax_calls, port_calls, valid.reshape(-1))
    assert agrees.sum() >= valid.sum() - 2
    np.testing.assert_allclose(
        got["mask_probs"].numpy().reshape(-1, 224, 224)[agrees],
        np.asarray(ref["mask_probs"]).reshape(-1, 224, 224)[agrees],
        rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_TRAINED = {}


def trained(family):
    """JAX's losses and gradients of one batch under the JAX draws, and the
    port's run with the box head's two ReLUs on JAX's activation pattern
    (the rows of that pattern the port's own pre-activations would flip,
    if any, lie within float noise of 0 in both), once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    if family in _TRAINED:
        return _TRAINED[family]
    cfg, jm, variables = models(family)
    batch = train_batch()
    key = jax.random.PRNGKey(3)

    def total(params, batch):
        losses, inter = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, method="forward_train", rngs={"sampling": key},
            capture_intermediates=lambda m, _: m.name in ("shared_fc1",
                                                          "shared_fc2"),
            mutable=["intermediates"])
        return sum(losses.values()), (losses, inter)

    (_, (ref, inter)), grads = _jit(jax.value_and_grad(total, has_aux=True),
                                    variables["params"], batch)
    ref = {k: float(v) for k, v in ref.items()}
    ref_grads = state_dict_from_jax(grads, variables["batch_stats"])
    bh = inter["intermediates"]["bbox_head"]
    ref_pre = [np.asarray(bh[f"shared_fc{i}"]["__call__"][0])
               for i in (1, 2)]

    pm = port_model(cfg, variables)
    head = pm.roi_head["bbox_head"]
    pre = []

    def forward(x):
        x = x.permute(0, 3, 1, 2).flatten(1)
        for fc, jax_pre in zip(head.shared_fcs, ref_pre):
            z = fc(x)
            pre.append(z.detach().numpy())
            x = z * torch.from_numpy(jax_pre > 0).float()
        zero = x.new_zeros((x.shape[0], head.reg_dim))
        return head.fc_cls(x), zero if head.fc_reg is None \
            else head.fc_reg(x)
    head.forward = forward
    got = pm.forward_train({k: t(v) for k, v in batch.items()},
                           jax_forward_train_draws(jm, variables, key, 2))
    sum(got.values()).backward()
    got = {k: float(v.detach()) for k, v in got.items()}
    for a, b in zip(pre, ref_pre):
        flips = (a > 0) != (b > 0)
        assert np.abs(a[flips]).max(initial=0) < 1e-5 * np.abs(b).max()
        assert np.abs(b[flips]).max(initial=0) < 1e-5 * np.abs(b).max()
    _TRAINED[family] = (ref, got, ref_grads, pm)
    return _TRAINED[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_losses_match_jax(family):
    """Grid R-CNN has no ``loss_bbox`` and adds ``loss_grid``; PointRend
    adds ``loss_point`` to the Mask R-CNN losses (7^2 mask targets)."""
    ref, got, _, _ = trained(family)
    base = {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls"}
    assert set(got) == set(ref) == base | (
        {"loss_grid"} if family == "grid"
        else {"loss_bbox", "loss_mask", "loss_point"})
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """Every trainable tensor has a gradient, within 1e-4 of the largest
    of JAX's: the grid head's every transition and both deconvs, the
    coarse and the point head."""
    _, _, ref_grads, pm = trained(family)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)
    moved = [n for n in ({"grid": ("roi_head.grid_head.sorder_trans.8.1.0"
                                   ".weight", "roi_head.grid_head.deconv1"
                                   ".weight", "roi_head.grid_head.convs.0.gn"
                                   ".bias"),
                          "point_rend": ("roi_head.point_head.fcs.0.conv"
                                         ".weight", "roi_head.mask_head"
                                         ".fc_logits.weight")}[family])]
    for n in moved:
        assert float(grads[n].abs().max()) > 0, n


# ---------------------------------------------------------------------------
# the modules and functions
# ---------------------------------------------------------------------------

def test_grid_head_matches_jax():
    """The grid head's fused and unfused heatmaps on the detector's weights
    (x-major points, grouped deconvs, shared between the two paths)."""
    from bonai_tpu.models.roi_heads.grid_head import GridHead as JaxHead
    cfg, _, variables = models("grid")
    pm = port_model(cfg, variables)
    x = np.random.RandomState(2).randn(6, 14, 14, 16).astype(np.float32)
    want = _jit(lambda p, x: JaxHead(
        num_convs=2, in_channels=16, point_feat_channels=8).apply(
            {"params": p}, x, train=True), variables["params"]["grid_head"],
        x)
    got = pm.roi_head["grid_head"](t(x), unfused=True)
    assert got["fused"].shape == (6, 9, 28, 28)
    for k in ("fused", "unfused"):
        _close(got[k].detach(), np.asarray(want[k]).transpose(0, 3, 1, 2))
    assert not np.allclose(want["fused"], want["unfused"])


def _boxes(r, n, size=96.0):
    xy = r.uniform(-10, size * 0.7, (n, 2))
    wh = r.uniform(0.5, size * 0.6, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_grid_targets_and_jitter_match_jax():
    """Targets exactly, with boxes whose 2x expansion is at most 3 px (all
    zero), at radius 1 and 2; the jitter of JAX's offsets, clipped to each
    image."""
    from bonai_tpu.models.roi_heads.grid_head import grid_targets as jax_fn
    from bonai_tpu.models.roi_heads.grid_head import jitter_boxes as jax_jit
    from bonai_tpu_torch.models.roi_heads.grid_head import (grid_targets,
                                                            jitter_boxes)
    r = np.random.RandomState(4)
    pos = _boxes(r, 40)
    pos[:3, 2:] = pos[:3, :2] + 1.0
    gt = pos + r.uniform(-8, 8, (40, 4)).astype(np.float32)
    for radius in (1, 2):
        want = _jit(lambda a, b: jax_fn(a, b, 9, 56, pos_radius=radius),
                    pos, gt)
        got = grid_targets(t(pos), t(gt), 9, 56, radius).numpy()
        np.testing.assert_array_equal(got, want)
        assert want[3:].sum() > 100 and not want[:3].any()
    boxes = np.stack([_boxes(r, 30), _boxes(r, 30)])
    shape = np.array([[96, 96], [80, 90]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    offsets = np.stack([np.asarray(jax.random.uniform(
        k, (30, 4), minval=-0.15, maxval=0.15)) for k in keys])
    want = _jit(jax.vmap(jax_jit), keys, boxes, shape)
    got = jitter_boxes(t(offsets), t(boxes), t(shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert (want[1, :, 2] == 89).any() and (want[..., :2] == 0).any()


def test_grid_decode_matches_jax_with_a_tie():
    """The vote on random heatmaps, boxes past the image clipped, and a map
    whose largest value is at two cells (the first one counts)."""
    from bonai_tpu.models.roi_heads.grid_head import (
        grid_decode_boxes as jax_fn)
    from bonai_tpu_torch.models.roi_heads.grid_head import grid_decode_boxes
    r = np.random.RandomState(6)
    boxes = _boxes(r, 24)
    heat = r.randn(24, 28, 28, 9).astype(np.float32)
    heat[0, 3, 5, 0] = heat[0, 20, 2, 0] = 9.0       # tie, first at 3*28+5
    heat[1, :, :, 4] = 0.5                            # all equal
    shape = np.array([90.0, 80.0], np.float32)
    decode = jax.jit(lambda b, h: jax_fn(b, h, 9, 56, shape))
    want = np.asarray(decode(boxes, heat))
    got = grid_decode_boxes(t(boxes), t(heat.transpose(0, 3, 1, 2)), 9, 56,
                            t(np.tile(shape, (24, 1)))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want[:, 2] == 80.0).any() or (want[:, 3] == 90.0).any()
    moved = heat.copy()
    moved[0, 3, 5, 0] = 8.0                           # the second cell wins
    assert not np.allclose(np.asarray(decode(boxes, moved))[0], want[0])


def _head_params(variables, name, **heads):
    """The port's ``state_dict`` keys of one head from the detector's JAX
    variables with that head's params replaced."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    params = dict(variables["params"], **heads)
    prefix = f"roi_head.{name}."
    return {k[len(prefix):]: v for k, v in state_dict_from_jax(
        params, variables["batch_stats"]).items() if k.startswith(prefix)}


@pytest.mark.parametrize("classes", [1, 2])
def test_coarse_and_point_heads_match_jax(classes):
    """The coarse mask head and the point head on the detector's weights,
    and on seeded two-class heads (the coarse logits' (S, S, K) order)."""
    from bonai_tpu.models.roi_heads.point_head import (
        CoarseMaskHead as JaxCoarse)
    from bonai_tpu.models.roi_heads.point_head import (
        MaskPointHead as JaxPoint)
    from bonai_tpu_torch.models.roi_heads.point_head import (CoarseMaskHead,
                                                            MaskPointHead)
    _, _, variables = models("point_rend")
    r = np.random.RandomState(7)
    x = r.randn(10, 14, 14, 16).astype(np.float32)
    fine = r.randn(10, 50, 16).astype(np.float32)
    coarse_pt = r.randn(10, 50, classes).astype(np.float32)
    jc = JaxCoarse(num_convs=1, in_channels=16, conv_out_channels=16,
                   fc_out_channels=32, num_classes=classes)
    jp = JaxPoint(in_channels=16, fc_channels=16, num_classes=classes)
    if classes == 1:
        pc = variables["params"]["mask_head"]
        pp = variables["params"]["point_head"]
    else:
        pc = _jit(jc.init, jax.random.PRNGKey(1), x)["params"]
        pp = _jit(jp.init, jax.random.PRNGKey(2), fine, coarse_pt)["params"]
        # the constant fc_logits kernel would hide the output order
        pc["fc_logits"]["kernel"] = np.asarray(r.randn(
            *pc["fc_logits"]["kernel"].shape), np.float32)
    coarse = CoarseMaskHead(1, 2, 16, 16, 32, classes)
    coarse.load_state_dict(_head_params(variables, "mask_head", mask_head=pc))
    point = MaskPointHead(3, 16, 16, classes)
    point.load_state_dict(_head_params(variables, "point_head",
                                       point_head=pp))
    want = _jit(lambda p, x: jc.apply({"params": p}, x), pc, x)
    _close(coarse(t(x)).detach(), want.transpose(0, 3, 1, 2))
    _close(point(t(fine), t(coarse_pt)).detach(),
           _jit(lambda p, f, c: jp.apply({"params": p}, f, c), pp, fine,
                coarse_pt))


def test_point_sampling_matches_jax():
    """``bilinear_point_sample`` on one- and many-channel maps and
    ``fine_grained_point_feats`` on an FPN level, with points outside the
    maps and the RoIs; ``point_targets_from_instance_masks``."""
    from bonai_tpu.models.roi_heads import point_head as J
    from bonai_tpu_torch.models.roi_heads import point_head as P
    r = np.random.RandomState(8)
    maps = r.randn(6, 9, 11, 3).astype(np.float32)
    coords = np.stack([r.uniform(-2, 12, (6, 80)), r.uniform(-2, 10, (6, 80))],
                      -1).astype(np.float32)
    for m in (maps, maps[..., 0]):
        want = jax.vmap(J.bilinear_point_sample)(m, coords)
        _close(P.bilinear_point_sample(t(m), t(coords)), want, 1e-6)
    assert not np.asarray(want)[(coords[..., 0] < -1)].any()
    feat = r.randn(2, 24, 20, 16).astype(np.float32)
    rois = np.concatenate([r.randint(0, 2, (12, 1)), _boxes(r, 12)],
                          1).astype(np.float32)
    rel = r.uniform(-0.2, 1.2, (12, 60, 2)).astype(np.float32)
    _close(P.fine_grained_point_feats(t(feat), t(rois), t(rel), 4),
           J.fine_grained_point_feats(feat, rois, rel, 4), 1e-6)
    gt = rois[:, 1:] + r.uniform(-5, 5, (12, 4)).astype(np.float32)
    masks = (r.rand(12, 28, 28) > 0.5).astype(np.float32)
    _close(P.point_targets_from_instance_masks(t(rois), t(rel), t(gt),
                                               t(masks)),
           J.point_targets_from_instance_masks(rois, rel, gt, masks), 1e-6)


@pytest.mark.parametrize("maps", ["random", "equal"])
def test_uncertainty_points_match_jax(maps):
    """Both samplers pick JAX's points, in JAX's order: on random maps, and
    on maps whose every logit is equal (the heads' initial coarse logits),
    where ties go to the lower index."""
    from bonai_tpu.models.roi_heads import point_head as J
    from bonai_tpu_torch.models.roi_heads import point_head as P
    r = np.random.RandomState(9)
    coarse = r.randn(5, 7, 7).astype(np.float32)
    fine = r.randn(5, 56, 56).astype(np.float32)
    if maps == "equal":
        coarse[:] = 0.37
        fine[:] = -1.5
    key = jax.random.PRNGKey(11)
    want = np.asarray(J.uncertainty_points_train(key, coarse, 40))
    r1, r2 = jax.random.split(key)
    pts = np.array(jax.random.uniform(r1, (5, 120, 2)))
    fresh = np.array(jax.random.uniform(r2, (5, 10, 2)))
    got = P.uncertainty_points_train(t(pts), t(fresh), t(coarse), 40)
    np.testing.assert_array_equal(got.numpy(), want)
    want_idx, want_xy = J.uncertainty_points_test(fine, 784)
    idx, xy = P.uncertainty_points_test(t(fine), 784)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(want_xy))
    if maps == "equal":
        np.testing.assert_array_equal(idx.numpy()[0], np.arange(784))


def test_upsample_matches_jax_resize():
    """A subdivision step's 2x upsample, ``F.interpolate(bilinear,
    align_corners=False)``, is ``jax.image.resize(..., "linear")``."""
    import torch.nn.functional as F
    r = np.random.RandomState(10)
    for s in (7, 28, 56):
        x = r.randn(4, s, s).astype(np.float32)
        _close(F.interpolate(t(x)[:, None], size=(2 * s, 2 * s),
                             mode="bilinear", align_corners=False)[:, 0],
               jax.image.resize(x, (4, 2 * s, 2 * s), "linear"), 1e-6)


@pytest.mark.parametrize("aggregation", ["sum", "concat"])
def test_generic_extractor_matches_jax(aggregation):
    """The ``GenericRoIExtractor``: one level (PointRend's) and four,
    summed or concatenated, padded RoIs zeroed."""
    from bonai_tpu.ops.roi_align import generic_roi_align
    cfg, _, variables = models("point_rend")
    pm = port_model(cfg, variables)
    r = np.random.RandomState(12)
    levels = [r.randn(2, 96 // s, 96 // s, 16).astype(np.float32)
              for s in (4, 8, 16, 32)]
    rois = np.concatenate([r.randint(0, 2, (30, 1)), _boxes(r, 30)],
                          1).astype(np.float32)
    valid = r.rand(30) > 0.2
    for strides in ([4], [4, 8, 16, 32]):
        ext = dict(type="GenericRoIExtractor", aggregation=aggregation,
                   roi_layer=dict(type="SimpleRoIAlign", output_size=14),
                   featmap_strides=strides)
        want = np.asarray(generic_roi_align(
            levels[:len(strides)], rois, 14, strides, roi_valid=valid,
            aggregation=aggregation))
        got = pm._roi_align_cfg(ext, [t(x) for x in levels], t(rois),
                                t(valid)).numpy()
        assert got.shape == want.shape
        _close(got, want, 1e-6)
        assert not want[~valid].any()


# ---------------------------------------------------------------------------
# weights and results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_weight_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys (mmdet's), the
    port loads them strictly and gives them back, and ``init_detector``
    reads them from an mmdet-style ``.pth``.  The JAX importer raises
    ``KeyError`` on such a ``.pth`` (256-channel neck and heads, as it
    assumes): Grid R-CNN's at the missing ``fc_reg``, PointRend's at the
    coarse head, which it reads as an FCN head (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = a7_cfg(family)
    m = cfg.model
    m.neck.out_channels = 256
    m.rpn_head.update(in_channels=256, feat_channels=32)
    for k in ("bbox_head", "mask_head", "grid_head", "point_head"):
        if m.roi_head.get(k) is not None:
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
    with pytest.raises(KeyError, match="fc_reg" if family == "grid"
                       else "mask_head.upsample"):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])


def test_224_masks_paste_as_jax():
    """``results_to_host``'s paste of PointRend's 224^2 maps into boxes
    smaller and larger than 224 px, partly outside the image, against the
    JAX package's ``paste_masks_np`` (cv2): a pixel may differ only where
    the pasted probability is within 1e-4 of the 0.5 threshold."""
    from bonai_tpu.core.masks import paste_masks_np
    from bonai_tpu_torch.core.masks import paste_mask_rle
    from bonai_tpu_torch.datasets import mask_utils
    from test_torch_port_test_cli import _pasted
    r = np.random.RandomState(13)
    h, w = 300, 400
    probs = r.rand(8, 224, 224).astype(np.float32)
    boxes = np.array([[10, 20, 50, 90], [-30, 5, 250, 260], [100, 40, 390, 299],
                      [0, 0, 400, 300], [350, 250, 460, 330],
                      [12.3, 7.8, 235.6, 231.2], [5, 5, 6, 6],
                      [60, 60, 284, 284]], np.float32)
    want = paste_masks_np(probs, boxes, h, w)
    n_px = 0
    for p, box, m in zip(probs, boxes, want):
        got = mask_utils.decode_mask(paste_mask_rle(p, box, h, w))
        diff = got != m
        if diff.any():
            assert np.abs(_pasted(p, box, h, w)[diff] - 0.5).max() <= 1e-4
        n_px += int(m.sum())
    assert n_px > 10000
