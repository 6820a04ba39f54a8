"""bonai_tpu_torch training pieces against the JAX package, one function
at a time: box and offset encoding, the max-IoU assigner, the random
sampler (fed the uniforms ``jax.random`` draws from the same key), mask,
RPN, box and FOA offset targets, the losses, the block RoIAlign's
gradient, the LR schedule and three optimizer steps.

float32 on the CPU.  Assignments, samples, mask targets and labels must be
identical, IoUs agree to 1e-6 relative, encodings and losses to 1e-5,
gradients and parameters after the optimizer steps to 1e-4 of their
largest magnitude.
The JAX functions run under ``jit``, as the JAX train step compiles them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bonai_tpu.core import boxes as jax_boxes
from bonai_tpu.core.assigners import max_iou_assign as jax_assign
from bonai_tpu.core.masks import \
    mask_targets_from_instance_masks as jax_mask_targets
from bonai_tpu.core.samplers import random_sample as jax_sample
from bonai_tpu.engine.optim import build_lr_schedule as jax_schedule
from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
from bonai_tpu.engine.optim import frozen_mask_from_model
from bonai_tpu.models import losses as jax_losses
from bonai_tpu.models.dense_heads.rpn_head import rpn_targets as jax_rpn_t
from bonai_tpu.models.roi_heads.bbox_head import \
    bbox_targets_single as jax_bbox_t
from bonai_tpu.models.roi_heads.offset_heads import \
    foa_offset_targets as jax_foa_t
from bonai_tpu.ops.pallas_roi_align_block import pallas_block_roi_align
from bonai_tpu_torch.core import boxes
from bonai_tpu_torch.core.assigners import max_iou_assign
from bonai_tpu_torch.core.masks import mask_targets_from_instance_masks
from bonai_tpu_torch.core.samplers import generator_draws, random_sample
from bonai_tpu_torch.engine import (apply_gradients, build_lr_schedule,
                                    build_optimizer)
from bonai_tpu_torch.models import losses
from bonai_tpu_torch.models.dense_heads.rpn_head import rpn_targets
from bonai_tpu_torch.models.roi_heads.bbox_head import bbox_targets
from bonai_tpu_torch.models.roi_heads.offset_heads import foa_offset_targets
from bonai_tpu_torch.ops import roi_align_block
from bonai_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_common import (jax_model, jax_uniforms, port_model, t,
                               tiny_cfg)
from test_torch_port_roi_align import STRIDES
from test_torch_port_roi_align import _fixture as roi_fixture


def _boxes(r, n, size=128.0):
    xy = r.uniform(0, size * 0.7, (n, 2))
    wh = r.uniform(6, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _gt(r, g=6, valid_g=4):
    gt = _boxes(r, g)
    valid = np.arange(g) < valid_g
    gt[~valid] = 0.0
    return gt, valid


def _candidates(r, gt, n):
    """Boxes around the GTs (jittered copies, some exact, so ties and
    low-quality matches happen) and random ones."""
    near = gt[r.randint(0, 4, n // 2)] + r.normal(0, 4, (n // 2, 4))
    near[:3] = gt[:3]
    return np.concatenate([near, _boxes(r, n - n // 2)]).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("bbox2delta", ((0.0, 0.1, 0.0, -0.1), (0.1, 0.1, 0.2, 0.2))),
    ("offset2delta", ((0.0, 0.0), (0.5, 0.5))),
    ("offset_rotate", (90,)),
    ("offset_rotate", (270,))])
def test_encodings_match_jax(fn, args):
    r = np.random.RandomState(0)
    a, b = _boxes(r, 50), _boxes(r, 50)
    b[:5] = 0.0                                 # padded GT rows
    other = r.normal(0, 20, (50, 2)).astype(np.float32) \
        if fn != "bbox2delta" else b
    if fn == "offset_rotate":
        got = boxes.offset_rotate(t(other), *args)
        ref = jax_boxes.offset_rotate(other, *args)
    else:
        got = getattr(boxes, fn)(t(a), t(other), *args)
        ref = jax.jit(getattr(jax_boxes, fn), static_argnums=(2, 3))(
            a, other, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign_matches_jax(low_quality):
    r = np.random.RandomState(1)
    gts, valids, cands, cvalid = [], [], [], []
    for _ in range(2):
        gt, valid = _gt(r)
        gts.append(gt)
        valids.append(valid)
        cands.append(_candidates(r, gt, 80))
        cvalid.append(r.uniform(size=80) > 0.1)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3,
              match_low_quality=low_quality)
    got, got_ov = max_iou_assign(t(np.stack(cands)), t(np.stack(gts)),
                                 t(np.stack(valids)),
                                 box_valid=t(np.stack(cvalid)), **kw)
    fn = jax.jit(lambda c, g, v, bv: jax_assign(c, g, v, box_valid=bv, **kw))
    for i in range(2):
        ref, ref_ov = fn(cands[i], gts[i], valids[i], cvalid[i])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
        # XLA's compiled IoU can sit an ulp or two off the plain float32
        # ops (the port's and JAX's eager ones agree to the bit)
        np.testing.assert_allclose(got_ov[i].numpy(), np.asarray(ref_ov),
                                   rtol=1e-6, atol=0)
    assert (got > 0).sum() > 5 and (got == 0).sum() > 5


@pytest.mark.parametrize("num,n", [(16, 120), (64, 40)])
def test_random_sample_matches_jax(num, n):
    """The top-k path (``num <= n``) and the padding path (``num > n``),
    with the uniforms JAX draws from the same key."""
    r = np.random.RandomState(2)
    assigned = r.choice([-1, 0, 0, 0, 1, 2, 3], size=(2, n)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    u = [jax_uniforms(k, n) for k in keys]
    got = random_sample(t(assigned), num, 0.25,
                        t(np.stack([p for p, _ in u])),
                        t(np.stack([q for _, q in u])))
    fn = jax.jit(lambda k, a: jax_sample(k, a, num, 0.25))
    for i in range(2):
        ref = fn(keys[i], assigned[i])
        for k in ("inds", "is_pos", "valid", "pos_gt_inds"):
            np.testing.assert_array_equal(got[k][i].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
    assert int(got["is_pos"].sum(1).max()) == int(num * 0.25)


def test_generator_draws_are_in_range():
    u_pos, u_neg = generator_draws(torch.Generator().manual_seed(0))(
        (3, 1000), torch.device("cpu"))
    assert u_pos.shape == u_neg.shape == (3, 1000)
    assert float(torch.minimum(u_pos, u_neg).min()) >= 1e-4
    assert float(torch.maximum(u_pos, u_neg).max()) < 1.0
    assert not torch.equal(u_pos, u_neg)


def test_mask_targets_match_jax():
    """Including GT boxes sampled as their own proposals, whose cells sit
    exactly on the 0.5 threshold."""
    r = np.random.RandomState(3)
    gt = _boxes(r, 60)
    props = (gt + r.normal(0, 6, (60, 4))).astype(np.float32)
    props[:20] = gt[:20]
    masks = (r.rand(60, 112, 112) > 0.4).astype(np.float32)
    got = mask_targets_from_instance_masks(t(props), t(gt), t(masks), 28)
    ref = jax.jit(jax_mask_targets, static_argnums=3)(props, gt, masks, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.2 < float(got.mean()) < 0.8


def test_rpn_targets_match_jax():
    r = np.random.RandomState(4)
    anchors = _boxes(r, 500)
    gts, valids = zip(*[_gt(r) for _ in range(2)])
    gts, valids = np.stack(gts), np.stack(valids)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    u = [jax_uniforms(k, 500) for k in keys]
    assigner = dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.2)
    sampler = dict(num=64, pos_fraction=0.5)
    got = rpn_targets(t(anchors), t(gts), t(valids),
                      t(np.stack([p for p, _ in u])),
                      t(np.stack([q for _, q in u])), assigner, sampler)
    fn = jax.jit(lambda k, a, g, v: jax_rpn_t(k, a, g, v, assigner,
                                              sampler))
    for i in range(2):
        ref = fn(keys[i], anchors, gts[i], valids[i])
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
    assert float(got[0].sum()) > 4


def test_bbox_and_offset_targets_match_jax():
    r = np.random.RandomState(6)
    gt, valid = _gt(r)
    cand = _candidates(r, gt, 40)
    assigned = np.asarray(jax_assign(cand, gt, valid, 0.5, 0.5, 0.5)[0])
    key = jax.random.PRNGKey(9)
    res = jax_sample(key, assigned, 32, 0.25)
    u_pos, u_neg = jax_uniforms(key, 40)
    got_res = random_sample(t(assigned[None]), 32, 0.25, t(u_pos[None]),
                            t(u_neg[None]))
    sampled = cand[np.asarray(res["inds"])]
    labels = np.zeros(6, np.int32)
    means, stds = (0., 0., 0., 0.), (0.1, 0.1, 0.2, 0.2)
    ref = jax_bbox_t(sampled, res, gt, labels, 1, means, stds)
    got = bbox_targets(t(sampled[None]), got_res, t(gt[None]),
                       t(labels[None]), 1, means, stds)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    offsets = r.uniform(-20, 20, (32, 2)).astype(np.float32)
    rot = (0, 90, 180, 270)
    np.testing.assert_allclose(
        foa_offset_targets(t(sampled), t(offsets), rot).numpy(),
        np.asarray(jax.jit(jax_foa_t, static_argnums=2)(sampled, offsets,
                                                        rot)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["cross_entropy", "binary_cross_entropy",
                                  "l1_loss", "smooth_l1_loss"])
@pytest.mark.parametrize("reduce", ["avg_factor", "weight", "mean"])
def test_losses_match_jax(name, reduce):
    r = np.random.RandomState(7)
    pred = r.normal(0, 2, (40, 3)).astype(np.float32)
    if name == "cross_entropy":
        target = r.randint(0, 3, 40)
        weight = (r.uniform(size=40) > 0.3).astype(np.float32)
    else:
        target = (r.uniform(size=(40, 3)) > 0.5).astype(np.float32) \
            if name == "binary_cross_entropy" else \
            r.normal(0, 2, (40, 3)).astype(np.float32)
        weight = (r.uniform(size=(40, 3)) > 0.3).astype(np.float32)
    kw = {"avg_factor": dict(weight=weight, avg_factor=17.0),
          "weight": dict(weight=weight), "mean": {}}[reduce]
    kw_t = {k: t(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    if name == "smooth_l1_loss":
        kw, kw_t = dict(kw, beta=0.5), dict(kw_t, beta=0.5)
    got = getattr(losses, name)(t(pred).requires_grad_(), t(target), **kw_t)
    ref = getattr(jax_losses, name)(pred, target, **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert got.dtype == torch.float32


def test_block_roi_align_gradient_matches_pallas_interpret():
    """The block RoIAlign on CPU levels (the plain version, differentiated
    by autograd) against ``jax.grad`` of the Pallas kernel in interpret
    mode, with pushed, border and invalid RoIs (in the range where the two
    level rules agree, ROADMAP.md queue C)."""
    feats, rois, valid = roi_fixture(seed=1, n=12)
    ct = np.random.RandomState(2).randn(12, 7, 7, 32).astype(np.float32)

    def f(fs):
        out = pallas_block_roi_align(fs, jnp.asarray(rois), 7, STRIDES,
                                     sampling_ratio=2,
                                     roi_valid=jnp.asarray(valid),
                                     interpret=True)
        return jnp.sum(out * ct)

    ref = jax.grad(f)([jnp.asarray(x) for x in feats])
    levels = [t(x).requires_grad_() for x in feats]
    out = roi_align_block(levels, t(rois), 7, STRIDES, sampling_ratio=2,
                          roi_valid=t(valid))
    (out * t(ct)).sum().backward()
    for lv, g, s in zip(levels, ref, STRIDES):
        np.testing.assert_allclose(lv.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"stride {s}")
    assert float(levels[2].grad.abs().sum()) > 0     # the pushed RoI's level


@pytest.mark.parametrize("step", [0, 1, 150, 299, 300, 1000, 2500, 4000])
def test_lr_schedule_matches_jax(step):
    args = (0.005, 100, [16, 22])
    ref = jax_schedule(*args, 24, warmup="linear", warmup_iters=300,
                       warmup_ratio=0.001)(step)
    got = build_lr_schedule(*args, warmup="linear", warmup_iters=300,
                            warmup_ratio=0.001)(step)
    assert got == float(ref)


def test_three_optimizer_steps_match_optax():
    """SGD with momentum, weight decay, clipping at 35 and a linear warmup,
    the frozen stem and ``layer1`` left alone: three steps against the
    optax chain of ``build_optimizer``.  The first two gradients are large
    enough that the clip binds, the third is not."""
    cfg = tiny_cfg()
    _, variables = jax_model(cfg)
    params = variables["params"]
    stats = variables["batch_stats"]
    schedule_args = (2.0, 100, [16, 22])
    warm = dict(warmup="linear", warmup_iters=4, warmup_ratio=0.1)
    opt_cfg = dict(type="SGD", lr=2.0, momentum=0.9, weight_decay=1e-4)
    tx = jax_optimizer(opt_cfg, jax_schedule(*schedule_args, 24, **warm),
                       dict(max_norm=35), frozen_mask_from_model(params, 1))
    r = np.random.RandomState(8)
    grads = [jax.tree_util.tree_map(
        lambda p, s=scale: (r.normal(0, 1, p.shape) * s).astype(np.float32),
        params) for scale in (1.0, 0.5, 1e-3)]
    state = tx.init(params)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    ref = state_dict_from_jax(jax.device_get(jp), stats)

    pm = port_model(cfg, variables)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    opt = build_optimizer(pm, opt_cfg)
    schedule = build_lr_schedule(*schedule_args, **warm)
    norms = []
    for step, g in enumerate(grads):
        sd = state_dict_from_jax(g, stats)
        for name, p in pm.named_parameters():
            if p.requires_grad:
                p.grad = sd[name].clone()
        norms.append(float(apply_gradients(opt, schedule(step), 35.0)))
    assert norms[0] > 35 and norms[1] > 35 and norms[2] < 35
    for name, p in pm.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        if not p.requires_grad:
            assert torch.equal(p, before[name]), name
        moved = np.abs(want - before[name].numpy()).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(moved, 1e-6),
                                   err_msg=name)
