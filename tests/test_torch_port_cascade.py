"""Cascade Mask R-CNN
(``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py``) in
bonai_tpu_torch against the JAX package, at the tiny widths of
``torch_port_common`` in float32 on the CPU: each stage on the JAX stage's
own input boxes, the whole ``forward_train`` (losses and every gradient),
``simple_test``, the weight keys of the stage heads, and
``train_detector``.

Tolerances: each stage's sampled boxes and their validity equal to JAX's
(the boxes to 1e-4 px), its head outputs to 1e-4 of their largest, its
refined boxes to 1e-3 px; each loss 1e-4 relative and each gradient 1e-4
of its tensor's largest magnitude, as in ``test_torch_port_train.py``;
detections as in ``test_torch_port_detector.py`` (boxes 1e-3 px, scores
and mask probabilities 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_port_rcnn import (IMG_SHAPE, SCALE, check_gradients,
                                  compare_detections, jax_losses_and_grads,
                                  port_losses)
import torch_port_common as tpc
from torch_port_common import (CASCADE_CONFIG, jax_forward_train_draws,
                               jax_model, jax_uniforms, port_model, t,
                               tiny_train_cfg, train_batch)

STAGES = 3


@pytest.fixture(scope="module")
def models():
    cfg = tiny_train_cfg(CASCADE_CONFIG)
    jm, variables = jax_model(cfg)
    return cfg, jm, variables


@pytest.fixture(scope="module")
def jax_stages(models):
    """The JAX ``forward_train`` of ``train_batch()`` under ``PRNGKey(3)``,
    with its cascade module's ``boxes_to_rois`` and ``delta2bbox`` recorded
    (ordered host callbacks): each stage's sampled boxes and their
    validity, and each refined stage's deltas and decoded boxes; with the
    proposals and each stage head's outputs."""
    import bonai_tpu.models.detectors.cascade_rcnn as jax_cascade
    _, jm, variables = models
    batch = train_batch()
    key = jax.random.PRNGKey(3)
    calls = {"rois": [], "decode": []}
    to_rois, decode = jax_cascade.boxes_to_rois, jax_cascade.delta2bbox

    def record(name, *xs):
        jax.debug.callback(lambda *a: calls[name].append(
            tuple(np.asarray(x) for x in a)), *xs, ordered=True)

    def rec_rois(boxes, valid=None):
        record("rois", boxes, valid)
        return to_rois(boxes, valid)

    def rec_decode(rois, deltas, *args, **kw):
        out = decode(rois, deltas, *args, **kw)
        record("decode", deltas, out)
        return out
    jax_cascade.boxes_to_rois, jax_cascade.delta2bbox = rec_rois, rec_decode
    try:
        _, inter = jax.jit(lambda v, b: jm.apply(
            v, b, method="forward_train", rngs={"sampling": key},
            capture_intermediates=True, mutable=["intermediates"]))(
            variables, batch)
        jax.effects_barrier()
    finally:
        jax_cascade.boxes_to_rois, jax_cascade.delta2bbox = to_rois, decode
    heads = [tuple(np.asarray(x) for x in inter["intermediates"][
        f"bbox_head_{i}"]["__call__"][0]) for i in range(STAGES)]

    def props(m, img, shape):
        feats = m.extract_feat(img)
        return m._rpn_and_proposals(
            feats, shape, dict(m.train_cfg["rpn_proposal"]))[3::2]
    proposals, prop_valid = (np.asarray(x) for x in jax.jit(
        lambda v, i, s: jm.apply(v, i, s, method=props))(
        variables, batch["image"], batch["img_shape"]))
    return dict(batch=batch, key=key, heads=heads, proposals=proposals,
                prop_valid=prop_valid, **calls)


def test_each_stage_matches_jax_on_the_jax_stage_inputs(models, jax_stages):
    """Stage by stage, the port is fed what the JAX stage was fed: the
    proposals, then JAX's refined boxes of the stage before.  Its sampling
    (JAX's draws for that stage) picks the boxes JAX picked, its head gives
    JAX's outputs on them, and its refinement of JAX's deltas gives JAX's
    boxes.  A positive/negative flip of a box within float noise of an IoU
    threshold would show here, with the box."""
    from bonai_tpu_torch.core.boxes import clip_boxes
    from bonai_tpu_torch.models.detectors.two_stage import (
        assign_and_sample_rcnn)
    cfg, jm, variables = models
    st = jax_stages
    batch = {k: t(v) for k, v in st["batch"].items()}
    pm = port_model(cfg, variables)
    draw = jax_forward_train_draws(jm, variables, st["key"], 2, cascade=True)
    hw = (batch["img_shape"][:, 0, None], batch["img_shape"][:, 1, None])
    with torch.no_grad():
        feats = pm.extract_feat(batch["image"])
        draw((2, 1), "cpu")                         # the RPN's draw
        boxes, valid = t(st["proposals"]), t(st["prop_valid"])
        for i in range(STAGES):
            rcnn = dict(cfg.train_cfg.rcnn[i])
            res, sampled = assign_and_sample_rcnn(
                draw, boxes, valid, batch["gt_bboxes"], batch["gt_valid"],
                dict(rcnn["assigner"]), dict(rcnn["sampler"]))
            want, want_valid = st["rois"][i]
            got_valid = res["valid"].numpy()
            np.testing.assert_array_equal(got_valid, want_valid,
                                          err_msg=f"stage {i}")
            diff = np.abs(sampled.numpy() - want)[want_valid].max(1)
            worst = diff.argmax()
            assert diff[worst] <= 1e-4, (
                f"stage {i}: sampled box "
                f"{sampled.numpy()[want_valid][worst]} vs JAX "
                f"{want[want_valid][worst]}")
            rois, roi_valid = (torch.cat([torch.arange(2.0).repeat_interleave(
                want.shape[1])[:, None], t(want).reshape(-1, 4)], 1),
                t(want_valid).reshape(-1))
            cls_score, bbox_pred = pm.roi_head["bbox_head"][i](
                pm._roi_align_cfg(pm.bbox_extractor_cfg, feats, rois,
                                  roi_valid))
            for got, ref in zip((cls_score, bbox_pred), st["heads"][i]):
                ref = ref.reshape(got.shape)
                np.testing.assert_allclose(
                    got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                    err_msg=f"stage {i} head")
            if i == STAGES - 1:
                break
            deltas, refined = st["decode"][i]
            got = pm._decode(i, rois, t(deltas), batch["img_shape"], 2)
            np.testing.assert_allclose(
                got.numpy(), clip_boxes(t(refined).reshape(2, -1, 4),
                                        hw).numpy(),
                rtol=0, atol=1e-3, err_msg=f"stage {i} refinement")
            boxes = clip_boxes(t(refined).reshape(2, -1, 4), hw)
            valid = t(want_valid)


@pytest.fixture(scope="module")
def trained(models):
    cfg, jm, variables = models
    batch = train_batch()
    key = jax.random.PRNGKey(3)
    ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
    pm = port_model(cfg, variables)
    got = port_losses(pm, batch, jax_forward_train_draws(
        jm, variables, key, 2, cascade=True))
    return ref, got, ref_grads, pm


def test_forward_train_losses_match_jax(trained):
    ref, got, _, _ = trained
    assert set(got) == set(ref) == {
        "loss_rpn_cls", "loss_rpn_bbox", "loss_mask"} | {
        f"s{i}.loss_{k}" for i in range(STAGES) for k in ("cls", "bbox")}
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_gradients_match_jax(trained):
    _, _, ref_grads, pm = trained
    assert check_gradients(pm, ref_grads) > 40
    for head in pm.roi_head["bbox_head"]:
        assert float(head.fc_reg.weight.grad.abs().max()) > 0


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


def test_stage_head_weight_keys(models, tmp_path):
    """The JAX stage heads ``bbox_head_<i>`` carry to mmdet's
    ``roi_head.bbox_head.<i>.*``; the port loads them strictly and gives
    them back unchanged, and ``init_detector`` loads them from an
    mmdet-style ``.pth``.  (The JAX importer reads only a single
    ``bbox_head``: ROADMAP.md queue C.)"""
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = models
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    stage_keys = sorted(k for k in sd if k.startswith("roi_head.bbox_head."))
    assert stage_keys == sorted(
        f"roi_head.bbox_head.{i}.{m}.{w}" for i in range(STAGES)
        for m in ("shared_fcs.0", "shared_fcs.1", "fc_cls", "fc_reg")
        for w in ("weight", "bias"))
    assert {k.split(".")[1] for k in sd if k.startswith("roi_head.")} == {
        "bbox_head", "mask_head"}
    for i in range(STAGES):
        np.testing.assert_array_equal(
            sd[f"roi_head.bbox_head.{i}.fc_reg.weight"].numpy(),
            np.asarray(variables["params"][f"bbox_head_{i}"]["fc_reg"]
                       ["kernel"]).T)
    pm = port_model(cfg, variables)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    pth = tmp_path / "cascade.pth"
    torch.save({"state_dict": sd, "meta": {}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_train_detector_lowers_the_loss(tmp_path):
    """Six steps on one repeated batch at a constant LR."""
    from bonai_tpu_torch.apis import train_detector
    cfg = tiny_train_cfg(CASCADE_CONFIG)
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.optimizer.lr = 0.01
    cfg.log_config = dict(interval=1)
    _, hist = train_detector(cfg, [train_batch(seed=1)], str(tmp_path),
                             max_steps=6, device="cpu", log_interval=1)
    loss = [h["loss"] for h in hist]
    assert len(loss) == 6 and all(np.isfinite(loss))
    assert max(loss[-2:]) < 0.7 * loss[0], loss
    assert all(f"s{i}.loss_bbox" in hist[0] for i in range(STAGES))


def test_jax_uniforms_of_a_stage_are_its_folded_key(models):
    """The cascade draw source's stage ``i`` hands out the uniforms of the
    splits of the R-CNN key folded with ``i``
    (``bonai_tpu/models/detectors/cascade_rcnn.py:92``)."""
    _, jm, variables = models
    key = jax.random.PRNGKey(3)
    draw = jax_forward_train_draws(jm, variables, key, 2, cascade=True)
    rng = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": key})
    rcnn = jax.random.split(rng)[1]
    draw((2, 5), "cpu")
    for i in range(STAGES):
        u_pos, _ = draw((2, 7), "cpu")
        want = jax_uniforms(jax.random.split(
            jax.random.fold_in(rcnn, i), 2)[1], 7)[0]
        np.testing.assert_array_equal(u_pos[1].numpy(), want)
