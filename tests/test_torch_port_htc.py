"""Hybrid Task Cascade (``configs/htc/htc_r50_fpn_1x_bonai.py``) in
bonai_tpu_torch against the JAX package, at the tiny widths of
``torch_port_common.htc_cfg`` (ResNet-18 at base 8, 16 channels) in
float32 on the CPU: the single-level ``roi_align``, ``HTCMaskHead`` with
and without the previous stage's feature, ``FusedSemanticHead`` (its
antialiased level-0 resize), the detector's ``simple_test``, and
``forward_train``'s losses and every gradient with a planted
``gt_semantic_seg``, interleaved with the info flow and without either.

Tolerances: module outputs to 1e-5 of their largest value, gradients to
1e-4 of their tensor's largest; detections as in
``test_torch_port_rcnn.py`` (boxes 1e-3 px, scores and mask
probabilities 1e-4); losses to 1e-4 relative (each a mean of float32
sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_rcnn import (IMG_SHAPE, SCALE, check_gradients,
                                  compare_detections, jax_losses_and_grads,
                                  port_losses)
import torch_port_common as tpc
from torch_port_common import (htc_cfg, jax_forward_train_draws, jax_model,
                               jax_uniforms, port_model, t, train_batch)

STAGES = 3


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _sd(params, prefix):
    """A head's flax variables through ``state_dict_from_jax`` under the
    detector's name ``params`` gives it, keyed relative to ``prefix``."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    sd = state_dict_from_jax({"backbone": {}, "neck": {}, **params},
                             {"backbone": {}})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _random(shapes, r):
    return jax.tree_util.tree_map(
        lambda s: r.normal(0.0, 0.3, s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("size", [7, 14])
def test_roi_align_matches_jax(size):
    """The single-level RoIAlign at stride 8 and its gradient, on RoIs
    inside, across and outside the map's border."""
    from bonai_tpu.ops.roi_align import roi_align as jax_roi_align
    from bonai_tpu_torch.ops.roi_align import roi_align
    r = np.random.RandomState(size)
    feat = r.randn(2, 20, 24, 8).astype(np.float32)
    xy = r.uniform(-40, 200, (40, 2))
    wh = r.uniform(2, 120, (40, 2))
    rois = np.concatenate([r.randint(0, 2, (40, 1)), xy, xy + wh],
                          1).astype(np.float32)
    g = r.randn(40, size, size, 8).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_roi_align(f, rois, size, 1 / 8.0),
                        feat)
    f = t(feat).requires_grad_()
    got = roi_align(f, t(rois), size, 1 / 8.0)
    (got * t(g)).sum().backward()
    _close(got.detach(), want, what="features")
    _close(f.grad, vjp(g)[0], rel=1e-4, what="gradient")


def test_htc_mask_head_matches_jax():
    """Stage 0's head (no ``conv_res``) and a later stage's (the previous
    feature through ``conv_res``): logits and the feature passed on."""
    from bonai_tpu.models.roi_heads.mask_head import HTCMaskHead as JaxHead
    from bonai_tpu_torch.models.roi_heads.mask_head import HTCMaskHead
    r = np.random.RandomState(0)
    x = r.randn(6, 14, 14, 16).astype(np.float32)
    res = r.randn(6, 14, 14, 16).astype(np.float32)
    jh = JaxHead(num_convs=2, in_channels=16, conv_out_channels=16,
                 num_classes=2)
    for stage, feat in ((0, None), (1, res)):
        shapes = jax.eval_shape(jh.init, jax.random.PRNGKey(0), x, feat)
        variables = _random(shapes, r)
        logits, out_feat = jh.apply(variables, x, feat, return_logits=True,
                                    return_feat=True)
        head = HTCMaskHead(2, 16, 16, 2, with_conv_res=stage > 0)
        head.load_state_dict(_sd({f"mask_head_{stage}": variables["params"]},
                                 f"roi_head.mask_head.{stage}."))
        prev = None if feat is None else t(feat).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = head(t(x), prev)
            got_feat = head(t(x), prev, return_logits=False)
        _close(got.permute(0, 2, 3, 1), logits, what=f"stage {stage}")
        _close(got_feat.permute(0, 2, 3, 1), out_feat,
               what=f"stage {stage} feature")


def test_fused_semantic_head_matches_jax():
    """Five levels fused onto level 1: level 0 shrinks (``jax.image.resize``
    antialiases, which ``F.interpolate`` does only with ``antialias=True``:
    without it level 0's lateral differs from JAX's by far more than the
    bound), the others grow."""
    import torch.nn.functional as F
    from bonai_tpu.models.roi_heads.mask_head import (
        FusedSemanticHead as JaxSemantic)
    from bonai_tpu_torch.models.roi_heads.mask_head import (
        FusedSemanticHead, resize_bilinear)
    r = np.random.RandomState(1)
    feats = [r.randn(2, 48 // 2 ** i, 40 // 2 ** i, 16).astype(np.float32)
             for i in range(5)]
    jh = JaxSemantic(num_ins=5, fusion_level=1, num_convs=2, in_channels=16,
                     conv_out_channels=16, num_classes=4)
    variables = _random(jax.eval_shape(jh.init, jax.random.PRNGKey(0),
                                       feats), r)
    logits, embedding = jh.apply(variables, feats)
    head = FusedSemanticHead(5, 1, 2, 16, 16, 4)
    head.load_state_dict(_sd({"semantic_head": variables["params"]},
                             "roi_head.semantic_head."))
    with torch.no_grad():
        got_logits, got_embedding = head([t(f) for f in feats])
    _close(got_logits.permute(0, 2, 3, 1), logits, what="logits")
    _close(got_embedding, embedding, what="embedding")

    level0 = feats[0].transpose(0, 3, 1, 2)
    want = np.asarray(jax.image.resize(jnp.asarray(feats[0]),
                                       (2, 24, 20, 16), "bilinear"))
    want = want.transpose(0, 3, 1, 2)
    _close(resize_bilinear(t(level0), (24, 20)), want, what="antialiased")
    plain = F.interpolate(t(level0), size=(24, 20), mode="bilinear",
                          align_corners=False)
    assert np.abs(plain.numpy() - want).max() > 100 * 1e-5 * np.abs(
        want).max()


@pytest.fixture(scope="module")
def models():
    cfg = htc_cfg(train=True)
    jm, variables = jax_model(cfg)
    return cfg, jm, variables


def test_simple_test_matches_jax(models):
    cfg, jm, variables = models
    pm = port_model(cfg, variables)
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {"det_bboxes", "det_scores",
                                    "det_labels", "det_valid", "mask_probs"}
    compare_detections(got, ref)


@pytest.fixture(scope="module", params=["interleaved", "plain"])
def trained(request, models):
    """Both packages' losses and gradients of one batch with a planted
    ``gt_semantic_seg`` at stride 4 (the logits, at stride 8, grow to
    it): the BONAI config (interleaved, info flow), and without either
    (``plain``, the cascade's draws)."""
    plain = request.param == "plain"
    if plain:
        cfg = htc_cfg(train=True, interleaved=False, mask_info_flow=False)
        jm, variables = jax_model(cfg)
    else:
        cfg, jm, variables = models
    batch = train_batch(semantic=4)
    key = jax.random.PRNGKey(3)
    ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
    pm = port_model(cfg, variables)
    got = port_losses(pm, batch, jax_forward_train_draws(
        jm, variables, key, 2, cascade=True, htc=not plain))
    return ref, got, ref_grads, pm, plain


def test_forward_train_losses_match_jax(trained):
    ref, got, _, _, _ = trained
    assert set(got) == set(ref) == {
        "loss_rpn_cls", "loss_rpn_bbox", "loss_semantic"} | {
        f"s{i}.loss_{k}" for i in range(STAGES)
        for k in ("cls", "bbox", "mask")}
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_gradients_match_jax(trained):
    """Every gradient, the semantic head's and the info-flow
    ``conv_res``'s (which only the interleaved config has) among them."""
    _, _, ref_grads, pm, plain = trained
    assert check_gradients(pm, ref_grads) > 100
    heads = pm.roi_head["mask_head"]
    assert all(hasattr(h, "conv_res") == (i > 0 and not plain)
               for i, h in enumerate(heads))
    for name in ("roi_head.semantic_head.conv_logits.weight",
                 "roi_head.semantic_head.lateral_convs.0.conv.weight"):
        assert float(dict(pm.named_parameters())[name].grad.abs().max()) > 0


def test_draws_interleave_the_mask_keys(models):
    """``htc=True`` hands out stage ``i``'s box uniforms from the R-CNN
    key folded with ``i``, then its mask uniforms from the key folded
    with ``100 + i`` (``bonai_tpu/models/detectors/htc.py:155, 197``)."""
    _, jm, variables = models
    key = jax.random.PRNGKey(3)
    draw = jax_forward_train_draws(jm, variables, key, 2, htc=True)
    rng = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": key})
    rcnn = jax.random.split(rng)[1]
    draw((2, 5), "cpu")
    for i in range(STAGES):
        for fold in (i, 100 + i):
            u_pos, _ = draw((2, 7), "cpu")
            want = jax_uniforms(jax.random.split(
                jax.random.fold_in(rcnn, fold), 2)[1], 7)[0]
            np.testing.assert_array_equal(u_pos[1].numpy(), want)
