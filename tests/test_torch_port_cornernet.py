"""CornerNet in bonai_tpu_torch against the JAX package, in float32 on the
CPU: ``corner_pool``, the corner targets (shared corner cells, padded GTs),
the decode (a tie-heavy one), the gaussian focal and associative
embedding losses, a tiny hourglass CornerNet
(``torch_port_common.nas_ssd_cfg('cornernet')``: two downsamplings at 8
and 16 channels, 128^2 inputs) through its head outputs, ``simple_test``
(decode, gaussian soft-NMS), losses and every gradient, Adam and AdamW
steps against optax's chain, the weights, CornerNet's train transforms
(``RandomCenterCropPad`` in both modes, ``PhotoMetricDistortion``) and the
numpy HSV conversions against cv2 on every colour, and the train CLI on
two gloo ranks then the test CLI.

Tolerances: corner pooling, targets' cells, exact-corner masks, offsets
and decode ranks exact; gaussian heat 1e-6; head outputs 1e-4 of their
largest value (the corner branches' per-channel GroupNorms magnify the
second stack's float noise); losses 1e-5 relative (the model's 1e-4);
gradients 1e-4 of their tensor's largest element, module by module (the
whole chain's float32 gradient is ill-conditioned: see
:func:`test_gradients_match_jax`); optimizer updates 1e-4 of their
largest; detections 1e-3 px with identical keep sets, scores 1e-4;
transforms exact.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from torch_port_common import jax_model, nas_ssd_cfg, port_model, t, train_batch

SIZE = 128
_MODEL = []


def model():
    """``(cfg, JAX model, variables)`` of the tiny CornerNet (weights of
    seed 1), built once."""
    if not _MODEL:
        cfg = nas_ssd_cfg("cornernet")
        _MODEL.extend([cfg, *jax_model(cfg, seed=1, init_size=SIZE)])
    return _MODEL


def _jit(fn, *args):
    return tpc.jax_call(fn, *args)


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def corner_batch(seed=0):
    """``train_batch`` at 128^2 with image 0's GT 1 sharing GT 0's top-left
    corner cell (stride 4) and a padded row in image 1."""
    batch = train_batch(seed=seed, size=SIZE)
    batch["gt_bboxes"][0, 1, :2] = batch["gt_bboxes"][0, 0, :2] + 0.5
    return batch


# ---------------------------------------------------------------------------
# the ops, targets, decode and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["top", "bottom", "left", "right"])
def test_corner_pool_is_exact(direction):
    """``corner_pool`` equals JAX's ``associative_scan`` bit for bit, on
    random values and on a map of many ties (values of a few levels)."""
    from bonai_tpu.ops.layers import corner_pool as jax_pool
    from bonai_tpu_torch.ops.layers import corner_pool
    r = np.random.RandomState(0)
    for x in (r.randn(2, 7, 9, 3), np.round(r.randn(2, 7, 9, 3))):
        x = x.astype(np.float32)
        want = np.asarray(jax_pool(jnp.asarray(x), direction))
        got = _nhwc(corner_pool(t(x).permute(0, 3, 1, 2), direction))
        np.testing.assert_array_equal(got, want)


def test_corner_targets_match_jax():
    """Heat (gaussians, exact corners 1), offsets at the exact corners
    (the last GT of a shared cell wins) and corner cells of a batch with a
    shared cell and padded GTs, on a 32^2 map of a 128^2 input."""
    from bonai_tpu.models.dense_heads.corner_head import \
        corner_targets as jax_targets
    from bonai_tpu_torch.models.dense_heads.corner_head import corner_targets
    batch = corner_batch()
    want = _jit(jax.vmap(lambda gb, gv: jax_targets(gb, gv, 32, 32, SIZE,
                                                    SIZE)),
                batch["gt_bboxes"], batch["gt_valid"])
    got = corner_targets(t(batch["gt_bboxes"]), t(batch["gt_valid"]), 32,
                         32, SIZE, SIZE)
    assert (want["tl_pos"][0, 0] == want["tl_pos"][0, 1]).all()
    for k, v in want.items():
        g = got[k].numpy()
        if k.endswith("heat"):
            np.testing.assert_array_equal(g == 1, np.asarray(v) == 1)
            np.testing.assert_allclose(g, v, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


def test_decode_corners_with_ties_matches_jax():
    """The decode of heat logits of a few levels (local maxima and top-k
    ties) and quantised embeddings (many pairs masked to exactly -1),
    every one of the 40 x 40 pairs kept: the same boxes and scores in the
    same order as JAX's."""
    from bonai_tpu.models.dense_heads.corner_head import \
        decode_corners as jax_decode
    from bonai_tpu_torch.models.dense_heads.corner_head import decode_corners
    r = np.random.RandomState(3)
    out = {f"{s}_{k}": (np.round(r.randn(2, 32, 32, c) * 2) / 2
                        if k != "off" else r.rand(2, 32, 32, c)).astype(
        np.float32) for s in ("tl", "br") for k, c in (
        ("heat", 1), ("off", 2), ("emb", 1))}
    want_b, want_s = _jit(jax.vmap(lambda o: jax_decode(
        o, SIZE, SIZE, k=40, num_dets=1600)), out)
    got_b, got_s = decode_corners({k: t(v).permute(0, 3, 1, 2)
                                   for k, v in out.items()}, SIZE, SIZE,
                                  k=40, num_dets=1600)
    assert (np.asarray(want_s) == -1).sum() > 100
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_corner_losses_match_jax():
    """``gaussian_focal_loss`` (probabilities against a target with exact
    1s) and ``associative_embedding_loss`` (padded GTs), values and
    gradients."""
    from bonai_tpu.models.losses import (AssociativeEmbeddingLoss,
                                         GaussianFocalLoss)
    from bonai_tpu_torch.models.losses import (associative_embedding_loss,
                                               gaussian_focal_loss)
    r = np.random.RandomState(4)
    pred = r.uniform(0.01, 0.99, (2, 16, 16)).astype(np.float32)
    target = r.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    target[:, ::5, ::3] = 1.0
    want, g_want = _jit(jax.value_and_grad(lambda p: GaussianFocalLoss(
        loss_weight=1.0)(p, target, avg_factor=7.0)), pred)
    p = t(pred).requires_grad_()
    got = gaussian_focal_loss(p, t(target), 2.0, 4.0, avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(p.grad.numpy(), g_want)
    tl, br = r.randn(2, 6).astype(np.float32), r.randn(2, 6).astype(
        np.float32)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    ael = AssociativeEmbeddingLoss(0.1, 0.1)

    def terms(a, b):
        return jax.vmap(ael)(a, b, valid)
    w_pull, w_push = _jit(terms, tl, br)
    g_want = _jit(jax.grad(lambda a, b: sum(jnp.sum(x) for x in terms(a, b)),
                           argnums=(0, 1)), tl, br)
    a, b = t(tl).requires_grad_(), t(br).requires_grad_()
    pull, push = associative_embedding_loss(a, b, t(valid), 0.1, 0.1)
    (pull.sum() + push.sum()).backward()
    _close(pull.detach().numpy(), w_pull)
    _close(push.detach().numpy(), w_push)
    _close(a.grad.numpy(), g_want[0])
    _close(b.grad.numpy(), g_want[1])


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

def test_configs_build_at_full_width():
    """The shipped config: Hourglass-104 with mmdetection's keys, two
    levels of corner branches (on the meta device)."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(tpc.NAS_SSD_CONFIGS["cornernet"])
    with torch.device("meta"):
        m = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    sd = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    for k, shape in {
            "backbone.stem.0.conv.weight": (128, 3, 7, 7),
            "backbone.stem.1.0.downsample.0.weight": (256, 128, 1, 1),
            "backbone.hourglass_modules.1.low2.low2.low2.low2.low2.1.conv1"
            ".weight": (512, 512, 3, 3),
            "backbone.hourglass_modules.0.low2.low3.1.downsample.1"
            ".running_var": (256,),
            "backbone.inters.0.conv2.weight": (256, 256, 3, 3),
            "backbone.conv1x1s.0.bn.weight": (256,),
            "backbone.remap_convs.0.conv.weight": (256, 256, 1, 1),
            "backbone.out_convs.1.conv.weight": (256, 256, 3, 3),
            "bbox_head.tl_pool.1.direction1_conv.conv.weight":
                (128, 256, 3, 3),
            "bbox_head.br_pool.0.aftpool_conv.bn.weight": (256,),
            "bbox_head.tl_heat.1.1.conv.bias": (1,),
            "bbox_head.br_emb.0.1.conv.weight": (1, 256, 1, 1),
            "bbox_head.tl_off.0.0.conv.weight": (256, 256, 3, 3)}.items():
        assert sd[k] == shape, k
    assert sum(p.numel() for p in m.parameters()) == 200954000


def test_head_outputs_and_detections_match_jax():
    """Both levels' heat, offset and embedding maps, then ``simple_test``
    (the last level's decode and the gaussian soft-NMS)."""
    cfg, jm, variables = model()
    pm = port_model(cfg, variables)
    image = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(
        np.float32)
    img_shape = np.array([[SIZE, SIZE], [SIZE - 16, SIZE - 8]], np.float32)
    scale = np.array([1.0, 0.8], np.float32)
    ref = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    assert len(outs) == len(ref) == 2
    for lvl, (got, want) in enumerate(zip(outs, ref)):
        assert set(got) == set(want) == {"tl_heat", "br_heat", "tl_off",
                                         "br_off", "tl_emb", "br_emb"}
        for k in want:
            _close(_nhwc(got[k]), want[k], 1e-4, err_msg=f"{k} level {lvl}")
    ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
               variables, image, img_shape, scale)
    got = pm.simple_test(t(image), t(img_shape), t(scale))
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_allclose(got["det_bboxes"].numpy()[valid],
                               np.asarray(ref["det_bboxes"])[valid],
                               rtol=0, atol=1e-3)
    _close(got["det_scores"].numpy()[valid],
           np.asarray(ref["det_scores"])[valid], 1e-4)


def test_forward_train_losses_match_jax():
    cfg, jm, variables = model()
    batch = corner_batch()
    ref = _jit(lambda v, b: jm.apply(v, b, method="forward_train"),
               variables, batch)
    with torch.no_grad():
        got = port_model(cfg, variables).forward_train(
            {k: t(v) for k, v in batch.items()})
    assert set(got) == set(ref) == {"loss_heatmap", "loss_offset",
                                    "loss_pull", "loss_push"}
    for k in ref:
        assert float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def _running_argmax(x, direction):
    """The index along its axis of each ``corner_pool`` output's maximum
    (``(B, H, W, C)`` numpy; the first of exact ties)."""
    axis = 1 if direction in ("top", "bottom") else 2
    rev = direction in ("top", "left")
    v = np.flip(x, axis) if rev else x
    idx = np.zeros(v.shape, np.int64)
    best = np.take(v, [0], axis)
    cur = np.zeros(best.shape, np.int64)
    for i in range(v.shape[axis]):
        c = np.take(v, [i], axis)
        cur = np.where(c > best, i, cur)
        best = np.maximum(best, c)
        sl = [slice(None)] * 4
        sl[axis] = slice(i, i + 1)
        idx[tuple(sl)] = cur
    n = v.shape[axis]
    return np.flip(n - 1 - idx, axis) if rev else idx


def _head_on_jax_pattern(pm, variables, jm, feats_np):
    """The port's CornerNet head with its ReLUs on JAX's activation
    pattern and its corner pools reading JAX's running maxima, on JAX's
    stack outputs.  Each choice of the port's own that differs (a ReLU
    input's sign, a running maximum's position) must be within 1e-5 of
    its map's largest value: float noise.  Returns the head's outputs."""
    import bonai_tpu_torch.models.dense_heads.corner_head as head_mod
    inter = _jit(lambda v, f: jm.apply(
        v, f, method=lambda m, f: m.head_m(f), capture_intermediates=True,
        mutable=["intermediates"])[1], variables, feats_np)[
        "intermediates"]["bbox_head"]

    def out(name, sub=None):
        d = inter[name] if sub is None else inter[name][sub]
        return np.asarray(d["__call__"][0])
    relus, pools = [], []
    for i in range(len(feats_np)):
        for side, dirs in (("tl", ("top", "left")),
                           ("br", ("bottom", "right"))):
            pool = f"{side}_pool{i}"
            for d, direction in zip(("d1", "d2"), dirs):
                relus.append(out(pool, f"{d}_bn"))
                pools.append((np.maximum(relus[-1], 0), direction))
            relus.append(out(pool, "aftpool_bn") + out(pool, "conv1_bn"))
            relus.append(out(pool, "conv2_bn"))
            relus += [out(f"{side}_{kind}{i}_c0")
                      for kind in ("heat", "off", "emb")]
    edge = [1e-5 * np.abs(r).max() for r in relus]
    relu_q = list(zip(relus, edge))
    pool_q = list(pools)

    class Masked:
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def relu(x):
            want, e = relu_q.pop(0)
            flips = (_nhwc(x) > 0) != (want > 0)
            assert (np.abs(want)[flips] <= e).all()
            assert (np.abs(_nhwc(x))[flips] <= e).all()
            return torch.where(t(want > 0).permute(0, 3, 1, 2), x,
                               x.new_zeros(()))

    own_pool = head_mod.corner_pool

    def pooled(x, direction):
        src, d = pool_q.pop(0)
        assert d == direction
        idx = t(_running_argmax(src, d)).permute(0, 3, 1, 2)
        dim = 2 if d in ("top", "bottom") else 3
        got = x.gather(dim, idx)
        own = own_pool(x, d)
        assert float((own - got).abs().max()) <= 1e-5 * float(
            own.abs().max())
        return got

    saved = head_mod.F, head_mod.corner_pool
    head_mod.F, head_mod.corner_pool = Masked(), pooled
    try:
        feats = [t(a).permute(0, 3, 1, 2).contiguous().requires_grad_()
                 for a in feats_np]
        outs = pm.bbox_head(feats)
    finally:
        head_mod.F, head_mod.corner_pool = saved
    assert not relu_q and not pool_q
    return feats, outs


def test_gradients_match_jax():
    """Every trainable tensor's gradient, module by module: the whole
    chain's float32 gradient is ill-conditioned (the port's own float32
    gradients differ from its float64 ones by 4 % of their largest: the
    corner pools' running maxima have runners-up within 2e-6 of them), so
    the hourglass runs under JAX's cotangents of its two stack outputs,
    and the head and losses on JAX's stack outputs with the head's ReLUs
    and running maxima on JAX's choices (:func:`_head_on_jax_pattern`),
    its cotangents of the stack outputs held to JAX's too: both stacks,
    the inter-stack path and both levels' corner branches."""
    from test_torch_port_nas_ssd import _jax_grads_and_cotangents
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables = model()
    batch = corner_batch()
    grads, acts, cot = _jax_grads_and_cotangents(jm, variables, batch,
                                                 ("backbone",))
    ref_grads = state_dict_from_jax(grads, variables["batch_stats"])
    pm = port_model(cfg, variables)
    tb = {k: t(v) for k, v in batch.items()}
    feats, outs = _head_on_jax_pattern(
        pm, variables, jm, [np.asarray(a) for a in acts["backbone"]])
    sum(pm._loss(outs, feats, tb).values()).backward()
    for f, c in zip(feats, cot["backbone"]):
        _close(_nhwc(f.grad), c, 1e-4)
    outs = pm.backbone(tb["image"].permute(0, 3, 1, 2).contiguous())
    torch.autograd.backward(outs, [t(np.asarray(c)).permute(0, 3, 1, 2)
                                   for c in cot["backbone"]])
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        _close(g.numpy(), ref_grads[name].numpy(), 1e-4, err_msg=name)
    for name in ("backbone.stem.0.conv.weight", "backbone.inters.0.conv1"
                 ".weight", "bbox_head.tl_pool.0.direction2_conv.bn.weight",
                 "bbox_head.br_emb.1.1.conv.weight"):
        assert float(grads[name].abs().max()) > 0, name


_GRADS = []


@pytest.mark.parametrize("opt_type", ["Adam", "AdamW"])
def test_adam_steps_match_optax(opt_type):
    """Three steps of the config's optimizer type (LR 1e-3, weight decay
    1e-2, momentum read and ignored) through ``apply_gradients`` against
    the JAX package's optax chain (clip, decayed weights joining the
    gradient, ``scale_by_adam``, the LR) with the hourglass stem frozen,
    both fed JAX's gradients of CornerNet's losses, scaled each step:
    ``torch.optim.Adam``'s coupled decay for both types (ROADMAP.md queue
    C).  The clip (at 1e6) does not bind: where a gradient and its decay
    nearly cancel, Adam's normalised update turns a one-ulp difference of
    the clip's scale into any value, and the clip's order is the SGD
    steps' (``test_torch_port_trunks.py``)."""
    import optax
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.engine import apply_gradients, build_optimizer
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables = model()
    lr, wd = 1e-3, 1e-2
    opt = dict(type=opt_type, lr=lr, weight_decay=wd, momentum=0.9)
    params, stats = variables["params"], variables["batch_stats"]
    if not _GRADS:
        _GRADS.append(_jit(jax.grad(lambda p: sum(jm.apply(
            {"params": p, "batch_stats": stats}, corner_batch(),
            method="forward_train").values())), params))
    grads = _GRADS[0]
    # the frozen mask's form (True = frozen) on the hourglass stem
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: "backbone" in str(path[0]) and "stem" in str(
            path[1]), params)
    assert not any(jax.tree_util.tree_leaves(
        frozen_mask_from_model(params, -1)))
    tx = jax_optimizer(opt, lambda count: lr, dict(max_norm=1e6), mask)
    state, p = tx.init(params), params
    pm = port_model(cfg, variables).train()
    frozen = {k for k, v in state_dict_from_jax(jax.tree_util.tree_map(
        lambda f, x: np.full(np.shape(x), float(f), np.float32), mask,
        params), stats).items() if not k.endswith(("running_mean",
                                                   "running_var"))
        and bool(v.all())}
    assert frozen and all(k.startswith("backbone.stem.") for k in frozen)
    for name, q in pm.named_parameters():
        q.requires_grad_(name not in frozen)
    optimizer = build_optimizer(pm, opt)
    assert type(optimizer) is torch.optim.Adam
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    for step, scale in enumerate((100.0, 0.5, -2.0)):
        g = jax.tree_util.tree_map(lambda x: x * scale, grads)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        sd = state_dict_from_jax(g, stats)
        for name, q in pm.named_parameters():
            q.grad = sd[name].clone() if q.requires_grad else None
        apply_gradients(optimizer, lr, max_norm=1e6)
    ref = state_dict_from_jax(p, stats)
    for name, q in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (q.detach() - before[name]).numpy()
        if name in frozen:
            assert not want.any() and not moved.any(), name
            continue
        assert moved.any(), name
        _close(moved, want, 1e-4, err_msg=name)


def test_weight_round_trip(tmp_path):
    """``state_dict_from_jax`` gives exactly the port's keys and an
    mmdet-style ``.pth`` loads through ``init_detector`` (its BatchNorm
    statistics of the corner pools, where the port has per-channel
    GroupNorms, dropped).  The JAX importer reads ``rpn_head.*``
    unconditionally and raises ``KeyError`` (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = model()
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    pm = port_model(cfg, variables)
    assert set(pm.state_dict()) == set(sd)
    mm = dict(sd)
    norms = [k for k in sd if "_pool." in k and k.endswith(".bn.weight")]
    assert len(norms) == 20
    for k in norms:
        mm[k[:-len("weight")] + "running_var"] = torch.ones_like(sd[k])
        mm[k[:-len("weight")] + "num_batches_tracked"] = torch.tensor(0)
    torch.save({"state_dict": mm, "meta": {}}, tmp_path / "mmdet.pth")
    loaded = init_detector(cfg, str(tmp_path / "mmdet.pth"), device="cpu",
                           dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])


# ---------------------------------------------------------------------------
# the train transforms
# ---------------------------------------------------------------------------

def _sample(r, h=96, w=128):
    """A BGR image with four boxes, their labels, offsets and polygons."""
    boxes = np.array([[10, 12, 40, 50], [60, 20, 120, 90], [5, 70, 30, 94],
                      [90, 5, 126, 30]], np.float32)
    return dict(img=r.randint(0, 256, (h, w, 3)).astype(np.uint8),
                img_shape=(h, w), gt_bboxes=boxes,
                gt_labels=np.zeros(4, np.int64),
                gt_offsets=r.uniform(-5, 5, (4, 2)).astype(np.float32),
                gt_masks=[[np.array([[b[0], b[1]], [b[2], b[1]],
                                     [b[2], b[3]]], np.float32)]
                          for b in boxes])


@pytest.mark.parametrize("mode", ["train", "test_logical_or",
                                  "test_size_divisor"])
def test_random_center_crop_pad_matches_jax(mode):
    """``RandomCenterCropPad``: in train mode 30 seeds of draws (canvas
    size, centre, the boxes kept, shifted and clipped with their labels,
    offsets and polygons, the border); in test mode the ``logical_or`` and
    the ``size_divisor`` canvas and its border."""
    from bonai_tpu.datasets.pipelines.transforms import \
        RandomCenterCropPad as JaxCrop
    from bonai_tpu_torch.datasets.pipelines.transforms import \
        RandomCenterCropPad
    kw = dict(crop_size=(64, 80), ratios=(0.6, 0.8, 1.0, 1.3), border=32,
              mean=[123.675, 116.28, 103.53], to_rgb=True)
    if mode != "train":
        kw.update(test_mode=True, test_pad_mode=("logical_or", 127)
                  if mode == "test_logical_or" else ("size_divisor", 32))
    r = np.random.RandomState(7)
    for seed in range(30 if mode == "train" else 1):
        sample = _sample(r)
        want = JaxCrop(**kw)(dict(copy.deepcopy(sample),
                                  _rng=np.random.RandomState(seed)))
        got = RandomCenterCropPad(**kw)(dict(
            copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        assert got["img_shape"] == want["img_shape"]
        for key in ("img", "border", "gt_bboxes", "gt_labels",
                    "gt_offsets"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert len(got["gt_masks"]) == len(want["gt_masks"])
        for a, b in zip(got["gt_masks"], want["gt_masks"]):
            np.testing.assert_array_equal(a[0], b[0])


def test_photo_metric_distortion_matches_jax():
    """``PhotoMetricDistortion`` over 20 seeds (each of the four jitters
    on and off in turn) gives the JAX transform's image exactly: its
    brightness, contrast, saturation and hue draws, in order, and the
    uint8 HSV round trip that the JAX transform makes through cv2."""
    from bonai_tpu.datasets.pipelines.transforms import \
        PhotoMetricDistortion as JaxPMD
    from bonai_tpu_torch.datasets.pipelines.transforms import \
        PhotoMetricDistortion
    r = np.random.RandomState(8)
    for seed in range(20):
        img = r.randint(0, 256, (40, 56, 3)).astype(np.uint8)
        want = JaxPMD()(dict(img=img.copy(),
                             _rng=np.random.RandomState(seed)))
        got = PhotoMetricDistortion()(dict(img=img.copy(),
                                           _rng=np.random.RandomState(seed)))
        assert got["img"].dtype == want["img"].dtype == np.float32
        np.testing.assert_array_equal(got["img"], want["img"])


@pytest.mark.parametrize("width", [1024, 24, 100])
def test_hsv_conversions_match_cv2_on_every_colour(width):
    """``bgr_to_hsv`` and ``hsv_to_bgr`` equal ``cv2.cvtColor``'s
    ``COLOR_BGR2HSV`` and ``COLOR_HSV2BGR`` on all 2^24 uint8 triples
    (hue up to 255 for the way back), in rows of 1024 pixels (OpenCV's
    vector blocks), of 24 (its scalar tail) and of 100 (both)."""
    import cv2
    from bonai_tpu_torch.utils.color import bgr_to_hsv, hsv_to_bgr
    total = -(-(1 << 24) // width) * width      # the last row wraps round
    step = (1 << 22) // width * width
    for start in range(0, total, step):
        c = np.arange(start, min(start + step, total), dtype=np.uint32) \
            % (1 << 24)
        img = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(
            np.uint8).reshape(-1, width, 3)
        np.testing.assert_array_equal(bgr_to_hsv(img), cv2.cvtColor(
            img, cv2.COLOR_BGR2HSV))
        np.testing.assert_array_equal(hsv_to_bgr(img), cv2.cvtColor(
            img, cv2.COLOR_HSV2BGR))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_ddp_and_test_cli(tmp_path):
    """The tiny CornerNet through its own train pipeline
    (``PhotoMetricDistortion``, ``RandomCenterCropPad`` at 128^2, Resize,
    flip) for 2 steps of the train CLI on two gloo ranks (DDP, Adam), from
    four 128^2 synthetic tiles; then the test CLI with ``--eval bbox``,
    whose results per image equal the JAX package's test loop on the
    trained weights (boxes within 1e-3 px, scores 1e-5)."""
    from bonai_tpu.apis import run_inference as jax_run_inference
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    from bonai_tpu_torch.tools import train as train_cli
    from test_torch_port_single_stage_files import _tiles, jax_variables
    _, jm, variables = model()
    cfg = nas_ssd_cfg("cornernet")
    _tiles(cfg, tpc.synth_data(tmp_path / "data", n=4, size=SIZE))
    for step in cfg.data.train.pipeline:
        if step.type == "RandomCenterCropPad":
            step.crop_size = (SIZE, SIZE)
    cfg.data.update(max_gt=64, workers_per_gpu=0, samples_per_gpu=1)
    cfg.compute_dtype = "float32"
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.log_config = dict(interval=1)
    cfg_path = str(tmp_path / "cornernet.py")
    cfg.dump(cfg_path)
    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--n-devices", "2", "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    for r in rows:
        assert {"loss_heatmap", "loss_offset", "loss_pull",
                "loss_push"} <= set(r)
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
