"""Item 6's A7 part in bonai_tpu_torch against the JAX package, second
half: the R-CNN's samplers, PISA's R-CNN losses, the IoU-family box
losses and GRoIE, at tiny widths in float32 on the CPU
(``torch_port_common.rcnn_option_cfg``), the JAX variables carried
across by ``state_dict_from_jax`` and the samplers' uniforms drawn by
``jax.random`` (``jax_forward_train_draws``):

- the samplers alone, on the same uniforms: ``InstanceBalancedPosSampler``,
  ``CombinedSampler`` (its three streams ``pos``, ``neg``, ``fill``),
  ``OHEMSampler``'s ranking and ``ScoreHLRSampler`` with its ISR-N
  weights, each with more and with fewer candidates than slots;
- the detectors, one training step each under JAX's draws: ``ohem``
  (``configs/faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py``),
  ``score_hlr`` (that config with ``ScoreHLRSampler``: no config uses
  it), ``libra`` (Libra's COCO config: ``CombinedSampler`` of the
  instance-balanced and IoU-balanced samplers), ``pisa``
  (``configs/pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py``: ISR-P and CARL),
  ``iou``, ``giou``, ``bounded_iou`` (``reg_decoded_bbox=True``) and
  ``groie`` (``configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py``);
- their ``simple_test``: the training options leave the serve path of
  ``ohem``, ``score_hlr``, ``iou``, ``giou`` and ``bounded_iou`` that of
  one Faster R-CNN (served once, as ``ohem``); ``libra``, ``pisa`` and
  ``groie`` each serve their own.

Selections under float noise (ROADMAP.md): OHEM ranks the candidates by
a squashed loss, ScoreHLR by a softmax score and ISR-P by IoUs, each
computed from the float32 heads of its package (the IoUs of decoded boxes
agree within 2e-5 of their largest).  The tests record each package's
keys and choices, hold the keys to each other within 1e-4, and accept a
differing choice only where its key lies that close to the last chosen
one (``_same_choice_or_near_tie``).

JAX's float32 gradients of the GRoIE mask extractor's attention block,
and of what trains through its backward, lie up to 8e-4 of their
largest magnitude off the float64 ones (the port's float32 within 2e-6):
the ``groie`` step holds those tensors to the port's float64 run of the
R-CNN, and the attention block alone to JAX's in float64
(``test_groie_modules_match_jax_in_float64``).

Tolerances: ``simple_test`` outputs within 1e-4 of each output's largest
magnitude, validity and labels exact; each loss 1e-5 relative; each
gradient 1e-4 of its tensor's largest magnitude; the samplers exact (the
ISR-N weights 1e-6); the GRoIE extractor in float64 1e-5 (its attention
takes float32 pieces).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from test_torch_port_rcnn import IMG_SHAPE, SCALE
from test_torch_port_rcnn_a7 import compare_outputs
from test_torch_port_rcnn_c4 import (jax_losses_and_grads, jax_simple_test,
                                     port_losses)
from torch_port_common import (jax_forward_train_draws, jax_model,
                               jax_uniforms, port_model, t, train_batch)

TRAINED = ("ohem", "score_hlr", "libra", "pisa", "iou", "giou",
           "bounded_iou", "groie")
SERVED = ("ohem", "libra", "pisa", "groie")
SCORE_HLR = dict(type="ScoreHLRSampler", num=64, pos_fraction=0.25,
                 neg_pos_ub=-1, add_gt_as_proposals=True, k=0.5, bias=0.0)


def family_cfg(family):
    """The tiny training config of ``family``; the hard-mining samplers
    fill 16 slots an image, fewer than the 38 candidates (32 proposals
    and 6 GTs), so that their ranking chooses."""
    if family not in ("ohem", "score_hlr"):
        return tpc.rcnn_option_cfg(family, train=True)
    cfg = tpc.rcnn_option_cfg("ohem", train=True)
    if family == "score_hlr":
        cfg.train_cfg.rcnn.sampler = dict(SCORE_HLR)
    cfg.train_cfg.rcnn.sampler.num = 16
    return cfg


_MODELS, _RUNS = {}, {}


def models(family):
    if family not in _MODELS:
        cfg = family_cfg(family)
        _MODELS[family] = (cfg, *jax_model(cfg, seed=1))
    return _MODELS[family]


# ---------------------------------------------------------------------------
# the samplers alone
# ---------------------------------------------------------------------------

def _assignment(n, seed, b=2, g=6):
    """A batch's assignment ``(B, N)`` (-1 ignored, 0 negative, GT index +
    1), each GT matched by a different share of the positives, and the
    candidates' max IoU."""
    r = np.random.RandomState(seed)
    u = r.rand(b, n)
    assigned = np.where(u < 0.1, -1, np.where(
        u < 0.55, 0, 1 + np.minimum((r.rand(b, n) ** 2 * g).astype(int),
                                    g - 1))).astype(np.int32)
    max_ov = np.where(assigned > 0, r.uniform(0.5, 1.0, (b, n)),
                      r.uniform(0.0, 0.5, (b, n))).astype(np.float32)
    return assigned, max_ov


def _per_image(fn, key, b, *arrays):
    """``fn(key_i, *row_i)`` of JAX over the images, stacked."""
    keys = jax.random.split(key, b)
    outs = [fn(keys[i], *(a[i] for a in arrays)) for i in range(b)]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def _uniforms(key, b, n, streams):
    per = [jax_uniforms(k, n, streams) for k in jax.random.split(key, b)]
    return [t(np.stack(u)) for u in zip(*per)]


SAMPLERS = ("instance_balanced", "combined_iou", "combined_random",
            "combined_floor", "ohem", "score_hlr")


@pytest.mark.parametrize("num", [64, 300])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_sampler_matches_jax(sampler, num):
    """Each sampler of a batch of 200 candidates into 64 slots, and into
    300 (fewer candidates than slots: the padding path), on the uniforms
    JAX draws from the same key (OHEM on seeded losses, ScoreHLR on
    seeded scores, some under its ``score_thr``): every output equal."""
    import bonai_tpu.core.samplers as jax_samplers
    from bonai_tpu_torch.core import samplers
    n, b = 200, 2
    assigned, max_ov = _assignment(n, seed=num)
    key = jax.random.PRNGKey(num)
    r = np.random.RandomState(7)
    kw = dict(num=num, pos_fraction=0.25)
    if sampler == "instance_balanced":
        want = _per_image(lambda k, a: jax_samplers.
                          instance_balanced_pos_sample(k, a, **kw), key, b,
                          assigned)
        got = samplers.instance_balanced_pos_sample(
            t(assigned), num, 0.25, *_uniforms(key, b, n, 2))
    elif sampler.startswith("combined"):
        neg = {"combined_iou": dict(type="IoUBalancedNegSampler",
                                    floor_thr=-1, floor_fraction=0,
                                    num_bins=3),
               "combined_random": dict(type="RandomSampler"),
               "combined_floor": dict(type="IoUBalancedNegSampler",
                                      floor_thr=0.1, floor_fraction=0.5,
                                      num_bins=2)}[sampler]
        pos = dict(type="InstanceBalancedPosSampler" if sampler !=
                   "combined_random" else "RandomSampler")
        want = _per_image(lambda k, a, m: jax_samplers.combined_sample(
            k, a, m, pos_cfg=pos, neg_cfg=neg, **kw), key, b, assigned,
            max_ov)
        got = samplers.combined_sample(t(assigned), t(max_ov), num, 0.25,
                                       *_uniforms(key, b, n, 3), pos, neg)
    elif sampler == "ohem":
        loss = r.exponential(1.0, (b, n)).astype(np.float32)
        want = _per_image(lambda k, l, a: jax_samplers.ohem_sample(
            l, a, **kw), key, b, loss, assigned)
        got = samplers.ohem_sample(t(loss), t(assigned), num, 0.25)
    else:
        score = r.beta(0.5, 2.0, (b, n)).astype(np.float32)
        want = _per_image(lambda k, a, s: jax_samplers.score_hlr_neg_sample(
            k, a, s, score_thr=0.05, k=0.5, **kw), key, b, assigned, score)
        got = samplers.score_hlr_neg_sample(
            t(assigned), t(score), num, 0.25, *_uniforms(key, b, n, 2),
            score_thr=0.05, k=0.5)
        np.testing.assert_allclose(got.pop("neg_label_weights").numpy(),
                                   want.pop("neg_label_weights"), rtol=0,
                                   atol=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want["is_pos"].any() and (want["valid"] & ~want["is_pos"]).any()


def test_within_group_rank_matches_jax_batched():
    """The batched rank (the instance-balanced quota, ISR-P) equals JAX's
    ``_within_group_rank`` row by row, ties among equal keys by index."""
    from bonai_tpu.core.samplers import _within_group_rank
    from bonai_tpu_torch.core.samplers import within_group_rank
    r = np.random.RandomState(0)
    groups = r.randint(0, 5, (3, 50)).astype(np.int32)
    keys = np.round(r.rand(3, 50), 1).astype(np.float32)     # many ties
    got = within_group_rank(t(groups), t(keys)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(_within_group_rank(groups[i], keys[i])))


# ---------------------------------------------------------------------------
# the detectors
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_choices(family):
    """Record each package's ranking keys and choices (OHEM's losses,
    ScoreHLR's scores, ISR-P's IoUs and weights) into the dict yielded:
    ``'jax'`` and ``'port'``, each a list of ``(keys, chosen)`` numpy
    pairs."""
    import bonai_tpu.core.samplers as jax_samplers
    import bonai_tpu.models.losses as jax_losses
    from bonai_tpu_torch.models.detectors import two_stage
    rec = {"jax": [], "port": []}

    def store(keys, chosen):
        rec["jax"].append((np.asarray(keys), np.asarray(chosen)))

    saved = []
    if family in ("ohem", "score_hlr"):
        name = "ohem_sample" if family == "ohem" else "score_hlr_neg_sample"
        key_arg = 0 if family == "ohem" else 2
        jax_fn, port_fn = getattr(jax_samplers, name), getattr(two_stage,
                                                               name)

        def jax_rec(*args, **kw):
            out = jax_fn(*args, **kw)
            jax.debug.callback(store, args[key_arg], out["inds"])
            return out

        def port_rec(*args, **kw):
            out = port_fn(*args, **kw)
            key_pos = 0 if family == "ohem" else 1
            rec["port"].append((args[key_pos].detach().numpy(),
                                out["inds"].numpy()))
            return out
        saved = [(jax_samplers, name, jax_fn), (two_stage, name, port_fn)]
        setattr(jax_samplers, name, jax_rec)
        setattr(two_stage, name, port_rec)
    elif family == "pisa":
        jax_fn, port_fn = jax_losses.isr_p, two_stage.isr_p

        def jax_isr(label_w, ious, *args, **kw):
            out = jax_fn(label_w, ious, *args, **kw)
            jax.debug.callback(store, ious, out)
            return out

        def port_isr(label_w, ious, *args, **kw):
            out = port_fn(label_w, ious, *args, **kw)
            rec["port"].append((ious.detach().numpy(),
                                out.detach().numpy()))
            return out
        saved = [(jax_losses, "isr_p", jax_fn), (two_stage, "isr_p",
                                                  port_fn)]
        jax_losses.isr_p = jax_isr
        two_stage.isr_p = port_isr
    try:
        yield rec
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _same_choice_or_near_tie(rec, family, tol=1e-4):
    """The packages' keys within ``tol`` of their largest (each package
    derives them from its float32 heads: losses, scores, IoUs of decoded
    boxes), and their choices equal, or each differing choice's key within
    ``tol`` of the last key chosen (OHEM, ScoreHLR: per image; ISR-P: the
    weights equal within 1e-5 of their largest, or the IoU of each
    differing positive tied within ``tol`` with another's)."""
    assert len(rec["port"]) == 1, family
    (pk, pc), = rec["port"]
    # a callback under vmap (the samplers') is called once an image, and
    # the JAX sampler's inner call (fewer candidates than slots) records
    # too: the outer calls are those of the port's slot count
    jk, jc = (np.stack(x) for x in zip(*[
        r for r in rec["jax"] if r[1].shape[-1] == pc.shape[-1]]))
    jk = jk.reshape(pk.shape)
    np.testing.assert_allclose(pk, jk, rtol=0,
                               atol=tol * max(np.abs(jk).max(), 1e-12))
    if family == "pisa":
        diff = np.abs(pc - jc.reshape(pc.shape)) > 1e-5 * np.abs(jc).max()
        for i in np.nonzero(diff)[0]:
            near = np.abs(jk - jk[i]) <= tol
            assert near.sum() > 1, f"ISR-P weight {i} differs off a tie"
        return
    assert pc.shape[-1] < pk.shape[-1]      # fewer slots than candidates
    for img in range(pk.shape[0]):
        jsel, psel = set(jc.reshape(pc.shape)[img]), set(pc[img])
        if jsel == psel:
            continue
        last = min(jk[img][sorted(jsel)])
        for i in jsel ^ psel:
            assert abs(jk[img][i] - last) <= tol, (family, img, i)


def trained(family):
    """JAX's and the port's losses and gradients of one batch under the
    JAX draws, with each package's recorded ranking choices, once."""
    if family not in _RUNS:
        cfg, jm, variables = models(family)
        batch, key = train_batch(), jax.random.PRNGKey(3)
        with recorded_choices(family) as rec:
            ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
            pm = port_model(cfg, variables)
            got = port_losses(pm, batch, jax_forward_train_draws(
                jm, variables, key, 2, hlr=family == "score_hlr"))
        _RUNS[family] = (ref, got, ref_grads, pm, rec)
    return _RUNS[family]


@pytest.mark.parametrize("family", SERVED)
def test_simple_test_matches_jax(family):
    """Libra's serve path is its BFP neck's, PISA's a plain Mask R-CNN's,
    GRoIE's every level's RoIs through the plugins, OHEM's that of the
    training options' shared Faster R-CNN."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = jax_simple_test(jm, variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {
        "det_bboxes", "det_scores", "det_labels", "det_valid"} | (
        {"mask_probs"} if family in ("pisa", "groie") else set())
    compare_outputs(got, ref)


def _groie_float64_grads(family):
    """The port's gradients of the R-CNN's losses in float64 (the same
    features in float64, the float32 run's proposals and JAX's draws),
    by parameter name, for the ``roi_head`` tensors."""
    cfg, jm, variables = models(family)
    batch, key = train_batch(), jax.random.PRNGKey(3)
    pm32 = port_model(cfg, variables)
    pm = port_model(cfg, variables).double()
    tb = {k: t(v) for k, v in batch.items()}
    tb64 = {k: v.double() if v.is_floating_point() else v
            for k, v in tb.items()}
    jdraw = jax_forward_train_draws(jm, variables, key, 2)

    def draw(shape, device, n=2):
        return tuple(u.double() for u in jdraw(shape, device, n))
    with torch.no_grad():
        _, props, valid = pm32._rpn_train(pm32.extract_feat(tb["image"]),
                                          tb, draw)
    losses = pm._roi_forward_train(pm.extract_feat(tb64["image"]),
                                   props.double(), valid, tb64, draw)
    sum(losses.values()).backward()
    return {n: p.grad for n, p in pm.named_parameters()
            if n.startswith("roi_head") and p.grad is not None}


@pytest.mark.parametrize("family", TRAINED)
def test_forward_train_matches_jax(family):
    """The step's losses (PISA's ``loss_carl`` among them), every
    gradient, and the rankings' choices.  GRoIE's tensors whose JAX
    float32 gradient lies more than 1e-4 off the float64 one (its mask
    extractor's attention block and what trains through its backward)
    are held to the port's float64 gradient within 1e-5 instead."""
    ref, got, ref_grads, pm, rec = trained(family)
    rpn = {"loss_rpn_cls", "loss_rpn_bbox"}
    assert set(got) == set(ref) == rpn | {"loss_cls", "loss_bbox"} | (
        {"loss_mask"} if family in ("pisa", "groie") else set()) | (
        {"loss_carl"} if family == "pisa" else set())
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    if family in ("ohem", "score_hlr", "pisa"):
        _same_choice_or_near_tie(rec, family)
    ill = {}
    if family == "groie":
        f64 = _groie_float64_grads(family)
        for name, e in f64.items():
            e = e.numpy()
            scale = np.abs(e).max()
            if np.abs(ref_grads[name].numpy() - e).max() > 1e-4 * scale:
                ill[name] = e
                np.testing.assert_allclose(
                    dict(pm.named_parameters())[name].grad.double().numpy(),
                    e, rtol=0, atol=1e-5 * scale, err_msg=name)
        assert ill and all(n.startswith(("roi_head.mask_roi_extractor.",
                                         "roi_head.mask_head."))
                           for n in ill), sorted(ill)
    grads = dict(pm.named_parameters())
    if family == "libra":
        # phi's bias shifts every pairwise logit of a row alike, which the
        # softmax cancels: its gradient is 0 but for float noise in both
        phi = "neck.1.refine.phi.conv"
        scale = float(grads[f"{phi}.weight"].grad.abs().max())
        for g in (grads[f"{phi}.bias"].grad.numpy(),
                  ref_grads[f"{phi}.bias"].numpy()):
            assert np.abs(g).max() < 1e-6 * scale
        ill[f"{phi}.bias"] = None
    held = 0
    for name, p in grads.items():
        want = ref_grads[name].numpy()
        if name in ill:
            continue
        if p.grad is None:      # frozen; GRoIE's query conv, unused by
            assert not np.abs(want).any(), name     # attention type 0100
            continue
        held += 1
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(),
                                                   1e-12), err_msg=name)
    assert held > 30


def test_groie_modules_match_jax_in_float64():
    """GRoIE's extractor alone in float64 in both packages, on seeded FPN
    levels, RoIs and the ``groie`` detector's mask-extractor weights:
    every level's 14x14 RoIAlign, the shared 5x5 ``pre`` conv, the sum,
    the attention block (type ``0100``, 6 heads, ``kv_stride`` 2), invalid
    RoIs zeroed.  Outputs, and the gradients of a seeded projection with
    respect to the levels and every parameter, within 1e-5 of each one's
    largest: both packages take the attention's position embedding and
    softmax in float32 whatever the dtype, and their rounding shows at
    1e-6."""
    import flax
    from bonai_tpu.models.detectors.two_stage import GroieConvModule
    from bonai_tpu.ops.layers import GeneralizedAttention as JaxAttention
    from bonai_tpu.ops.roi_align import generic_roi_align as jax_generic
    from bonai_tpu_torch.ops.roi_align import generic_roi_align
    cfg, _, variables = models("groie")
    pm = port_model(cfg, variables).double()
    ext = pm.roi_head["mask_roi_extractor"]
    post_cfg = dict(cfg.model.roi_head.mask_roi_extractor.post_cfg)
    for k in ("type", "in_channels"):
        post_cfg.pop(k)
    r = np.random.RandomState(5)
    strides = [4, 8, 16, 32]
    levels = [r.randn(2, 64 // s, 64 // s, 16) for s in strides]
    xy = r.uniform(0, 50, (12, 2))
    rois = np.concatenate([r.randint(0, 2, (12, 1)), xy,
                           xy + r.uniform(4, 40, (12, 2))], 1)
    valid = r.rand(12) > 0.2
    cot = r.randn(12, 14, 14, 16)
    params = {k: variables["params"][f"mask_groie_{k}"]
              for k in ("pre", "post")}
    with jax.enable_x64(True):
        f64 = jnp.float64
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, f64),
                                        params)
        pre = GroieConvModule(features=16, kernel=5, dtype=f64)
        post = JaxAttention(dtype=f64, **post_cfg)

        def fn(p, lv):
            return jax_generic(
                lv, jnp.asarray(rois), 14, strides, sampling_ratio=2,
                roi_valid=jnp.asarray(valid),
                pre=lambda x: pre.apply({"params": p["pre"]}, x),
                post=lambda x: post.apply({"params": p["post"]}, x))
        want, vjp = jax.vjp(fn, params, [jnp.asarray(x) for x in levels])
        want = np.asarray(want)
        want_p, want_l = vjp(jnp.asarray(cot))
        want_p = flax.traverse_util.flatten_dict(jax.device_get(want_p))
    lv = [t(x).requires_grad_() for x in levels]
    got = generic_roi_align(lv, t(rois), 14, strides, 2, t(valid), "sum",
                            ext.pre, ext.post)
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for g, w in zip(lv, want_l):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    grad_tree = dict(variables["params"], **{
        f"mask_groie_{k}": v for k, v in flax.traverse_util.unflatten_dict(
            want_p).items()})
    prefix = "roi_head.mask_roi_extractor."
    grads = {k[len(prefix):]: v for k, v in state_dict_from_jax(
        grad_tree, variables["batch_stats"]).items()
        if k.startswith(prefix)}
    own = dict(ext.named_parameters())
    assert set(grads) == set(own)
    for name, w in grads.items():
        w = w.double().numpy()
        if own[name].grad is None:      # the query conv, unused by 0100
            assert name.endswith("query_conv.weight") and not w.any()
            continue
        np.testing.assert_allclose(own[name].grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
