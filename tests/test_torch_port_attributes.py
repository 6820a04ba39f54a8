"""LOFT's attribute heads and the semi-supervised RPN in bonai_tpu_torch
against the JAX package, at ``torch_port_common.attr_cfg``'s tiny widths
(the head widths of ``tests/test_attribute_heads.py::_attr_cfg``) in
float32 on the CPU: every head, the height coder, the reweight and the
field aggregation, the FOA head with its own FCs per branch,
``simple_test``, one training step's losses and every gradient with JAX's
draws, the semi-RPN's boxes and regression weight on both sides of the
angle gate, the weights; the dense maps through the pipeline, the packed
batch, and the train and test CLIs on two 128^2 tiles.

Tolerances: each head output, ``simple_test`` output and gradient 1e-4 of
its largest magnitude; each loss 1e-4 relative; the data path exact.
"""

import copy
import os.path as osp

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (CONFIG, attr_batch, attr_cfg,
                               jax_forward_train_draws, jax_model,
                               port_model, synth_data, t)

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)


def _close(got, ref, what, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(
        float(np.abs(ref).max()), 1e-12), err_msg=what)


@pytest.fixture(scope="module")
def models():
    """The tiny attribute LOFT in both packages.  The height head's output
    bias is raised so that its decoded heights are not all clamped to 0."""
    cfg = attr_cfg(train=True)
    jm, variables = jax_model(cfg)
    variables["params"]["height_head"]["fc_height"]["bias"] += 2.0
    return cfg, jm, variables, port_model(cfg, variables)


def test_full_width_config_builds():
    """The full-width ``attr`` derivation (``chip_smoke.py``): every head
    at the widths the JAX modules default to, the offset head's shared
    FCs, and the semi-RPN."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(CONFIG)
    rh = cfg.model.roi_head
    cfg.model.rpn_head.type = "SemiRPNHead"
    rh.update(height_head=dict(num_convs=4, num_fcs=2),
              offset_height_head=dict(num_convs=4, num_fcs=2),
              angle_head=dict(in_channels=256, num_convs=2),
              side_face_head=dict(num_convs=4),
              offset_field_head=dict(num_convs=4), offset_reweight=True)
    with torch.device("meta"):
        m = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert m.semi_rpn and m.reweights
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes["roi_head.height_head.convs.3.weight"] == (256, 256, 3, 3)
    assert shapes["roi_head.height_head.fcs.0.weight"] == (1024, 256 * 49)
    assert shapes["roi_head.offset_height_head.fc_offset.weight"] == (2,
                                                                     1024)
    assert shapes["roi_head.angle_head.convs.1.weight"] == (256, 256, 3, 3)
    assert shapes["roi_head.angle_head.fc_angle.weight"] == (1, 256)
    for h, out in (("side_face_head", "conv_logits"),
                   ("offset_field_head", "conv_field")):
        assert shapes[f"roi_head.{h}.upsample.weight"] == (256, 256, 2, 2)
        assert shapes[f"roi_head.{h}.{out}.weight"][1:] == (256, 1, 1)
    assert m.side_face_extractor_cfg["roi_layer"]["output_size"] == 14


HEADS = ("height_head", "offset_height_head", "side_face_head",
         "offset_field_head")


@pytest.mark.parametrize("name", HEADS)
def test_roi_head_matches_jax(models, name):
    _, jm, variables, pm = models
    size = 7 if "height" in name else 14
    x = np.random.RandomState(1).randn(23, size, size, 16).astype(
        np.float32)
    ref = jm.apply(variables, x, method=lambda m, x: getattr(
        m, name + "_m")(x))
    with torch.no_grad():
        got = pm.roi_head[name](t(x))
    if name == "side_face_head":                # NCHW logits, as the masks'
        got = got.permute(0, 2, 3, 1)
    for i, (g, r) in enumerate(zip(*[o if isinstance(o, tuple) else (o,)
                                     for o in (got, ref)])):
        _close(g.numpy(), r, f"{name} output {i}")


def test_angle_head_matches_jax(models):
    _, jm, variables, pm = models
    r = np.random.RandomState(2)
    feats = [r.randn(2, s, s, 16).astype(np.float32) for s in (16, 8, 4)]
    ref = jm.apply(variables, feats,
                   method=lambda m, f: m.angle_head_m(f))
    with torch.no_grad():
        got = pm.roi_head["angle_head"]([t(f) for f in feats])
    _close(got.numpy(), ref, "angle")


@pytest.mark.parametrize("share", [False, True])
def test_foa_head_fcs_match_jax(share):
    """The tiny LOFT-FOA with each branch's own FCs (the JAX default) and
    with shared ones, through ``state_dict_from_jax``: the head's output,
    and the keys ``expand_fcs.<e>.<i>``/``expand_fc_offsets.<e>`` or
    ``fcs``/``fc_offset``."""
    from torch_port_common import tiny_cfg
    cfg = tiny_cfg()
    cfg.model.roi_head.offset_head.share_expand_fc = share
    jm, variables = jax_model(cfg)
    pm = port_model(cfg, variables)
    keys = {k.split(".")[2] for k in pm.state_dict()
            if k.startswith("roi_head.offset_head.")}
    assert keys == ({"expand_convs", "fcs", "fc_offset"} if share else
                    {"expand_convs", "expand_fcs", "expand_fc_offsets"})
    x = np.random.RandomState(3).randn(5, 7, 7, 16).astype(np.float32)
    ref = jm.apply(variables, x, method=lambda m, x: m.offset_head_m(x))
    with torch.no_grad():
        got = pm.roi_head["offset_head"](t(x))
    assert got.shape == (4, 5, 2)
    _close(got.numpy(), ref, "FOA output")


def test_coders_reweight_and_aggregation_match_jax():
    """``height2delta``/``delta2height`` (negatives clamp to 0),
    ``reweight_roi_feats`` (28^2 logits onto the 7^2 grid, antialiased as
    ``jax.image.resize`` shrinks) and ``offset_field_to_offsets`` (28^2
    logits on a 28^2 field, and 14^2 ones resized up)."""
    import bonai_tpu.models.roi_heads.attribute_heads as ja
    import bonai_tpu_torch.models.roi_heads.attribute_heads as pa
    r = np.random.RandomState(5)
    h = r.uniform(-5, 40, (9, 1)).astype(np.float32)
    for means, stds in (((0.0,), (4.0,)), ((1.5,), (5.0,))):
        enc = pa.height2delta(t(h), means, stds)
        _close(enc.numpy(), ja.height2delta(h, means, stds), "height2delta")
        _close(pa.delta2height(enc, means, stds).numpy(),
               ja.delta2height(np.asarray(enc), means, stds), "decode")
    assert float(pa.delta2height(t(np.float32([-3.0])))[0]) == 0.0
    feats = r.randn(6, 7, 7, 8).astype(np.float32)
    mask, side = (r.randn(6, 28, 28, 1).astype(np.float32) * 3
                  for _ in range(2))
    nchw = lambda a: t(a).permute(0, 3, 1, 2)     # noqa: E731
    _close(pa.reweight_roi_feats(t(feats), nchw(mask), nchw(side)).numpy(),
           ja.reweight_roi_feats(feats, mask, side), "reweight")
    field = r.uniform(-9, 9, (6, 28, 28, 2)).astype(np.float32)
    for logits in (mask, r.randn(6, 14, 14, 1).astype(np.float32)):
        _close(pa.offset_field_to_offsets(t(field), nchw(logits)).numpy(),
               ja.offset_field_to_offsets(field, logits), "field offsets")


def test_simple_test_matches_jax(models):
    """Every output of ``simple_test``, each to 1e-4 of its largest
    magnitude on the valid detections (the same detections in both)."""
    _, jm, variables, pm = models
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {
        "det_bboxes", "det_scores", "det_labels", "det_valid", "mask_probs",
        "offsets", "heights", "offset_height_offsets",
        "offset_height_heights", "angle", "side_face_probs",
        "offset_field_offsets"}
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() >= 4
    assert float(got["heights"][valid].max()) > 0
    for k in ref:
        if k in ("det_valid", "angle"):
            continue
        _close(got[k].numpy()[valid], np.asarray(ref[k])[valid], k)
    _close(got["angle"].numpy(), ref["angle"], "angle")


@pytest.fixture(scope="module")
def trained(models):
    """JAX's and the port's losses and gradients of one batch, once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, jm, variables, _ = models
    batch = attr_batch()
    key = jax.random.PRNGKey(3)

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method="forward_train",
                          rngs={"sampling": key})
        return sum(losses.values()), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"], batch)
    ref_grads = state_dict_from_jax(jax.device_get(grads),
                                    variables["batch_stats"])
    pm = port_model(cfg, variables)
    got = pm.forward_train({k: t(v) for k, v in batch.items()},
                           jax_forward_train_draws(jm, variables, key, 2))
    sum(got.values()).backward()
    return (jax.device_get(ref), {k: float(v.detach()) for k, v in
                                  got.items()}, ref_grads, pm)


def test_forward_train_losses_match_jax(trained):
    ref, got, _, _ = trained
    assert set(got) == set(ref) >= {
        "loss_angle", "loss_height", "loss_offset_height", "loss_side_face",
        "loss_offset_field", "loss_offset", "loss_rpn_bbox"}
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax(trained):
    """Every trainable tensor's gradient; each new head's is nonzero."""
    _, _, ref_grads, pm = trained
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        _close(p.grad.numpy(), ref_grads[name].numpy(), name)
    for head in ("height_head", "offset_height_head", "angle_head",
                 "side_face_head", "offset_field_head"):
        for name, p in pm.roi_head[head].named_parameters():
            assert float(p.grad.abs().max()) > 0, (head, name)


@pytest.mark.parametrize("angle", [-0.2, 0.17, 0.18, 0.5])
def test_semi_rpn_gt_and_weight_match_jax(models, angle):
    """The RPN's GT boxes and per-image regression weight under
    ``SemiRPNHead``: the footprint boxes of the flagged image, its weight
    0 where the predicted angle is 10 degrees or more (0.18 rad, 10.3; and
    -0.2) and 1 below (0.17 rad, 9.7; the unflagged image 1 always), as
    the JAX step hands them to ``rpn_loss``.  The angle head's output is
    pinned to ``angle`` (its FC weight 0, its bias the angle)."""
    import bonai_tpu.models.detectors.two_stage as jax_two_stage
    from bonai_tpu_torch.models.detectors import two_stage
    cfg, jm, variables, _ = models
    variables = copy.deepcopy(variables)
    fc = variables["params"]["angle_head"]["fc_angle"]
    fc["kernel"] *= 0
    fc["bias"][:] = angle
    batch = attr_batch()
    seen = {}

    class Stop(Exception):
        pass

    def record(pkg):
        def fake(cls, bbox, anchors, gt, gt_valid, rng, train_cfg,
                 reg_weight=None, legacy=False):     # the port's v1.x flag
            seen[pkg] = (np.asarray(gt), np.asarray(reg_weight))
            raise Stop
        return fake

    def no_proposals(self, feats, img_shape, proposal_cfg):
        return None, None, [np.zeros((1, 4), np.float32)], None, None, None

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_two_stage, "rpn_loss", record("jax"))
        mp.setattr(jax_two_stage.TwoStageDetector, "_rpn_and_proposals",
                   no_proposals)
        mp.setattr(two_stage, "rpn_loss", record("port"))
        with pytest.raises(Stop):
            jm.apply(variables, batch, method="forward_train",
                     rngs={"sampling": jax.random.PRNGKey(0)})
        with pytest.raises(Stop), torch.no_grad():
            port_model(cfg, variables).forward_train(
                {k: t(v) for k, v in batch.items()}, None)
    finally:
        mp.undo()
    gated = abs(angle) * 180 / np.pi >= 10
    np.testing.assert_array_equal(seen["port"][1], [0.0 if gated else 1.0,
                                                    1.0])
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(seen["port"][0][0],
                                  batch["gt_footprint_bboxes"][0])
    np.testing.assert_array_equal(seen["port"][0][1], batch["gt_bboxes"][1])


def test_rpn_loss_reg_weight_matches_jax():
    """``rpn_loss``'s per-image regression weight against the JAX
    function's on the same draws: off for both images, one, none."""
    import bonai_tpu.models.dense_heads.rpn_head as jax_rpn
    from bonai_tpu.core.anchors import AnchorGenerator
    from bonai_tpu_torch.models.dense_heads.rpn_head import rpn_loss
    from torch_port_common import jax_uniforms
    r = np.random.RandomState(0)
    anchors = AnchorGenerator(scales=[2], ratios=[1.0],
                              strides=[8]).grid_anchors([(4, 4)])[0]
    cls = r.randn(2, 4, 4, 1).astype(np.float32)
    reg = r.randn(2, 4, 4, 4).astype(np.float32)
    gt = np.array([[[4.0, 4.0, 20.0, 20.0]]] * 2, np.float32)
    gv = np.ones((2, 1), bool)
    cfg = dict(assigner=dict(pos_iou_thr=0.7, neg_iou_thr=0.3,
                             min_pos_iou=0.3),
               sampler=dict(num=16, pos_fraction=0.5))
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 2)

    def draw(shape, device, n=2):
        return tuple(torch.from_numpy(np.stack(u)) for u in zip(
            *[jax_uniforms(k, shape[-1], n) for k in keys]))
    for w in ([0.0, 0.0], [0.0, 1.0], [1.0, 1.0]):
        ref = jax_rpn.rpn_loss([cls], [reg], jax.numpy.asarray(anchors), gt,
                               gv, key, cfg, reg_weight=np.float32(w))
        got = rpn_loss([t(cls).permute(0, 3, 1, 2)],
                       [t(reg).permute(0, 3, 1, 2)], t(anchors), t(gt),
                       t(gv), draw, cfg, reg_weight=t(np.float32(w)))
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-5, err_msg=f"{w} {k}")
        assert (float(got["loss_rpn_bbox"]) == 0.0) == (max(w) == 0)


def test_weights_round_trip(models, tmp_path):
    """``state_dict_from_jax`` gives each new head its keys and the port
    loads them strictly; a checkpoint the port saves loads back through
    ``load_mmdet_checkpoint`` unchanged.  The JAX importer reads none of
    the attribute heads (the reference has no such modules): their
    leaves stay at their zeros (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.engine import latest_checkpoint, save_checkpoint
    from bonai_tpu_torch.utils.weights import (load_mmdet_checkpoint,
                                               state_dict_from_jax)
    cfg, _, variables, pm = models
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    heads = ("height_head", "offset_height_head", "angle_head",
             "side_face_head", "offset_field_head")
    keys = {h: sorted(k[len(h) + 10:] for k in sd
                      if k.startswith(f"roi_head.{h}.")) for h in heads}
    assert keys["height_head"] == ["convs.0.bias", "convs.0.weight",
                                   "fc_height.bias", "fc_height.weight",
                                   "fcs.0.bias", "fcs.0.weight"]
    assert keys["offset_height_head"] == sorted(
        keys["height_head"] + ["fc_offset.bias", "fc_offset.weight"])
    assert keys["angle_head"] == ["convs.0.bias", "convs.0.weight",
                                  "fc_angle.bias", "fc_angle.weight"]
    for h, out in (("side_face_head", "conv_logits"),
                   ("offset_field_head", "conv_field")):
        assert keys[h] == sorted(["convs.0.bias", "convs.0.weight",
                                  f"{out}.bias", f"{out}.weight",
                                  "upsample.bias", "upsample.weight"])
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    save_checkpoint(str(tmp_path), 0, pm,
                    torch.optim.SGD(pm.parameters(), lr=0.1))
    back = load_mmdet_checkpoint(latest_checkpoint(str(tmp_path)))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the JAX importer's first-FC reorder assumes 256 channels
    wide = attr_cfg()
    m = wide.model
    m.neck.out_channels = 256
    m.rpn_head.update(in_channels=256, feat_channels=32)
    rh = m.roi_head
    rh.bbox_head.in_channels = rh.mask_head.in_channels = 256
    rh.offset_head.update(in_channels=256, conv_out_channels=256,
                          num_convs=1)
    for k in ("bbox_roi_extractor", "mask_roi_extractor",
              "offset_roi_extractor"):
        rh[k].out_channels = 256
    rh.angle_head.in_channels = 256
    _, variables = jax_model(wide)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, _ = mmdet_checkpoint_to_params(
        {k: v.numpy() for k, v in sd.items()}, zeros["params"],
        zeros["batch_stats"])
    for h in heads:
        assert not any(np.any(x) for x in jax.tree_util.tree_leaves(
            params[h])), h
    np.testing.assert_array_equal(params["offset_head"]["fc0"]["kernel"],
                                  variables["params"]["offset_head"]["fc0"]
                                  ["kernel"])


# ---------------------------------------------------------------------------
# the dense maps through the data path, and the CLIs
# ---------------------------------------------------------------------------

def _files_cfg(data, size=128, pipeline_size=None):
    """``attr_cfg(train=True)`` on the tiles of ``data`` (with
    ``write_attribute_maps``' maps): the train pipeline loads heights, the
    angle, footprint boxes and flag, the side-face maps and the offset
    fields; both splits read the tiles at ``pipeline_size``^2."""
    cfg = attr_cfg(train=True)
    for split in (cfg.data.train, cfg.data.test):
        split.update(ann_file=f"{data}/train/train.json",
                     img_prefix=f"{data}/train/images/",
                     side_face_prefix=f"{data}/train/side_face/",
                     offset_field_prefix=f"{data}/train/offset_field/")
        for step in split.pipeline:
            if step.type in ("Resize", "MultiScaleFlipAug"):
                step.img_scale = (pipeline_size or size,) * 2
    load = cfg.data.train.pipeline[1]
    assert load.type == "LoadAnnotations"
    load.update(with_building_height=True, with_angle=True,
                with_footprint_bbox=True, with_only_footprint_flag=True,
                with_side_face=True, with_offset_field=True)
    cfg.data.update(max_gt=64, workers_per_gpu=0, samples_per_gpu=1)
    return cfg


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Two synthetic 128^2 tiles with their maps; the second tile's field
    holds both sentinels and its side-face PNG is RGB, so that
    ``IMREAD_UNCHANGED``'s three channels ride along."""
    from bonai_tpu_torch.tools.make_synthetic_bonai import (
        write_attribute_maps)
    from bonai_tpu_torch.utils.png import read_png, write_png
    data = synth_data(tmp_path_factory.mktemp("attr"), n=2, size=128)
    side, field = write_attribute_maps(data, "train")
    f = np.load(osp.join(field, "train_00001.npy"))
    f[:16, :, 1] = 500.0
    np.save(osp.join(field, "train_00001.npy"), f)
    gray = read_png(osp.join(side, "train_00001.png"), unchanged=True)
    rgb = np.stack([gray, gray // 2, 255 - gray], -1)
    write_png(osp.join(side, "train_00001.png"), rgb)
    return data


def test_nearest_resize_matches_cv2():
    import cv2
    from bonai_tpu_torch.datasets.pipelines.transforms import resize_nearest
    r = np.random.RandomState(0)
    for (h, w), (nh, nw) in [((128, 128), (96, 96)), ((100, 77), (333, 41)),
                             ((1024, 1024), (819, 1024)), ((37, 53), (5, 9)),
                             ((3, 7), (2048, 2047))]:
        for img in (r.randint(0, 256, (h, w)).astype(np.uint8),
                    r.randn(h, w, 2).astype(np.float32),
                    r.randint(0, 256, (h, w, 3)).astype(np.uint8)):
            np.testing.assert_array_equal(
                resize_nearest(img, nh, nw),
                cv2.resize(img, (nw, nh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("size", [128, 96, 160])
def test_dense_maps_through_the_pipeline_match_jax(tiles, size):
    """``LoadAnnotations`` (the PNG read without cv2, the sentinels
    zeroed), ``Resize`` (nearest, at the identity, shrunk and grown),
    ``RandomFlip`` (both directions, the field's sentinels re-marked),
    ``Pad``, ``Collect`` and ``pack_sample`` against the JAX pipeline,
    exact, under seeds that flip both ways.  The image itself is compared
    at the identity size only (the port's bilinear resize is not cv2's)."""
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu.datasets.builder import pack_sample as jax_pack_sample
    from bonai_tpu_torch.datasets import build_dataset, pack_sample
    train = _files_cfg(tiles, pipeline_size=size).data.train
    port = build_dataset(copy.deepcopy(train))
    ref = jax_build_dataset(copy.deepcopy(dict(train)))
    flips = set()
    for seed in range(4):
        for i in range(2):
            got = port.prepare(i, np.random.RandomState(seed))
            want = ref.prepare(i, np.random.RandomState(seed))
            flips.add(got["flip_direction"])
            for k in ("gt_side_face_maps", "gt_offset_field", "gt_bboxes",
                      "gt_footprint_bboxes", "gt_building_heights",
                      "gt_angle", "gt_only_footprint_flag", "gt_offsets",
                      "pad_shape") + (("img",) if size == 128 else ()):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            assert got["gt_side_face_maps"].shape[:2] == got["img"].shape[:2]
            packed, _ = pack_sample(got, 64, 28)
            packed_ref, _ = jax_pack_sample(want, 64, 28)
            assert packed.keys() == packed_ref.keys()
            for k in packed:
                if k != "image" or size == 128:
                    np.testing.assert_array_equal(packed[k], packed_ref[k],
                                                  err_msg=k)
    assert flips == {None, "horizontal", "vertical"}


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_random_flip_remarks_field_sentinels_as_jax(direction):
    """``RandomFlip`` on maps that still hold the 400/500 sentinels (the
    loader zeroes them first): the negated component's sentinels come
    back as 500, the other component's stay, as in the JAX transform."""
    from bonai_tpu.datasets.pipelines.transforms import RandomFlip as JaxFlip
    from bonai_tpu_torch.datasets.pipelines.transforms import RandomFlip
    r = np.random.RandomState(6)
    field = r.uniform(-9, 9, (12, 10, 2)).astype(np.float32)
    field[r.rand(12, 10, 2) < 0.2] = 400.0
    field[r.rand(12, 10, 2) < 0.2] = 500.0
    sample = dict(img=r.randint(0, 256, (12, 10, 3)).astype(np.uint8),
                  img_shape=(12, 10), flip=True, flip_direction=direction,
                  gt_offset_field=field, offset_field_fields=[
                      "gt_offset_field"],
                  gt_side_face_maps=r.randint(0, 2, (12, 10)).astype(
                      np.uint8), side_face_fields=["gt_side_face_maps"])
    got = RandomFlip()(copy.deepcopy(sample))
    want = JaxFlip()(copy.deepcopy(sample))
    for k in ("img", "gt_offset_field", "gt_side_face_maps"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    comp = 0 if direction == "horizontal" else 1
    assert (got["gt_offset_field"][..., comp] == 500.0).sum() == np.isin(
        field[..., comp], (400.0, 500.0)).sum()


def test_train_and_test_clis(tiles, tmp_path):
    """Two steps of the train CLI on the two tiles with their maps (every
    attribute loss finite), then the BONAI test CLI on the checkpoint:
    (bbox, segm, offsets) a tile."""
    import json
    import pickle
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.tools import bonai_test
    from bonai_tpu_torch.tools import train as train_cli
    cfg = _files_cfg(tiles)
    cfg.compute_dtype = "float32"
    cfg.log_config = dict(interval=1)
    cfg_path = str(tmp_path / "attr.py")
    cfg.dump(cfg_path)
    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    for k in ("loss_side_face", "loss_offset_field", "loss_height",
              "loss_angle", "loss_offset_height", "loss"):
        assert all(np.isfinite(r[k]) for r in rows), k
    out = tmp_path / "r.pkl"
    bonai_test.main([cfg_path, latest_checkpoint(str(wd)), "--out",
                     str(out), "--city", "config", "--device", "cpu"])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert len(payload["results"]) == 2
    assert all(len(r) == 3 for r in payload["results"])


@pytest.mark.parametrize("train", [False, True])
def test_roi_align_calls_a_batch_and_a_step(models, train):
    """The multi-level RoIAlign calls (each a B1 launch on the card under
    ``'block'``, B1 and B2 in a step) of a serve batch: 8 (box, mask,
    offset, the reweighting's mask and side-face calls, the side-face
    head, the offset-field head and its aggregation's mask call); of a
    training step: 7 (the aggregation runs at test only)."""
    from bonai_tpu_torch.models.detectors import two_stage
    cfg, jm, variables, _ = models
    pm = port_model(cfg, variables)
    calls = []
    plain = two_stage.multilevel_roi_align

    def counted(*args, **kw):
        calls.append(args[2])                   # the output size
        return plain(*args, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(two_stage, "multilevel_roi_align", counted)
    try:
        if train:
            pm.forward_train({k: t(v) for k, v in attr_batch().items()},
                             jax_forward_train_draws(
                                 jm, variables, jax.random.PRNGKey(3), 2))
        else:
            image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(
                np.float32)
            pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    finally:
        mp.undo()
    assert sorted(calls) == sorted(
        [7, 14, 7, 14, 14, 14, 14] + ([] if train else [14]))
