"""Item 6's A7 part in bonai_tpu_torch against the JAX package, first half:
the C4 layout and the RoI pooling layers, at tiny widths in float32 on the
CPU, the JAX variables carried across by ``state_dict_from_jax``:

- ``c4``: the C4 Mask R-CNN (``configs/mask_rcnn/
  mask_rcnn_r50_caffe_c4_1x_coco.py``, ``torch_port_common.c4_cfg``): a
  three-stage caffe trunk at base 8 without a neck, the RPN on its one
  stride-16 map, the shared res5 head (``ResLayerSharedHead``) at base 8,
  the average-pooled ``BBoxHead``, and the mask head on the box branch's
  shared-head features (no mask extractor); ``rpn_c4``, the C4 RPN;
- ``roipool``, ``dpool``, ``mdpool``: the Faster R-CNN with ``RoIPool``,
  ``DeformRoIPoolPack`` and ``ModulatedDeformRoIPoolPack``
  (``configs/dcn/faster_rcnn_r50_fpn_{dpool,mdpool}_1x_coco.py``;
  ``RoIPool`` in the dpool config's place, as no config uses it), every
  level pooled and the FPN rule's kept.

Each family's ``simple_test`` and one training step's losses and
gradients under JAX's draws; the pooling functions alone; the packs'
weights through mmdet's names and layout; the configs at full width.

JAX's jitted ``roi_pool`` computes its sample grid in another float order
than the function run op by op (XLA fuses it): a grid point that lies
exactly on a cell edge lands one cell lower
(``test_jitted_jax_roi_pool_floors_exact_edges_low``; ROADMAP.md queue
C).  The port computes the grid op by op, so the ``roipool`` family's
JAX reference takes its grid from the op-by-op arithmetic
(:func:`eager_roi_pool_grid`), the rest jitted.

Tolerances: ``simple_test`` outputs within 1e-4 of each output's largest
magnitude, validity and labels exact; each loss 1e-5 relative; each
gradient 1e-4 of its tensor's largest magnitude (a caffe BN affine, behind
its gradient stop, has none in the port and a zero one in JAX); the
pooling functions' outputs and gradients 1e-5 of their largest; weights
exact.
"""

import contextlib
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from test_torch_port_rcnn import IMG_SHAPE, SCALE, jax_losses_and_grads
from test_torch_port_rcnn_a7 import compare_outputs
from torch_port_common import (ROOT, jax_forward_train_draws, jax_model,
                               port_model, t, train_batch)

FAMILIES = ("c4", "rpn_c4", "roipool", "dpool", "mdpool")
C4_CONFIGS = ("mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py",
              "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py",
              "rpn/rpn_r50_caffe_c4_1x_coco.py")


def family_cfg(family):
    """The tiny training config of ``family``."""
    from bonai_tpu_torch import Config
    if family == "c4":
        return tpc.c4_cfg(train=True)
    if family == "rpn_c4":
        cfg = tpc.c4_cfg(train=True)
        rpn = Config.fromfile(osp.join(ROOT, "configs", C4_CONFIGS[2]))
        cfg.model.type, cfg.model.roi_head = "RPN", None
        cfg.train_cfg, cfg.test_cfg = (
            dict(rpn=cfg.train_cfg.rpn),
            dict(rpn=dict(rpn.test_cfg.rpn, nms_pre=100, nms_post=64,
                          max_num=64)))
        return cfg
    cfg = tpc.rcnn_option_cfg("dpool" if family == "roipool" else family,
                              train=True)
    if family == "roipool":
        cfg.model.roi_head.bbox_roi_extractor.roi_layer = dict(
            type="RoIPool", output_size=7)
    return cfg


@contextlib.contextmanager
def eager_roi_pool_grid(on=True):
    """Within it (``on``), JAX's ``roi_pool`` and ``deform_roi_pool`` take
    their sample grid (a function of the RoIs alone, no gradient) from
    ``_bin_grid`` run op by op on the host, as the port computes it."""
    import bonai_tpu.ops.roi_pool as jax_pool
    grid = jax_pool._bin_grid

    def host_grid(rois, out_size, samples, quantise):
        shape = jax.ShapeDtypeStruct((rois.shape[0], out_size, samples),
                                     jnp.float32)

        def run(r):
            with jax.disable_jit():
                return tuple(np.asarray(g) for g in grid(
                    jnp.asarray(r), out_size, samples, quantise))
        return jax.pure_callback(run, (shape, shape), rois)
    if on:
        jax_pool._bin_grid = host_grid
    try:
        yield
    finally:
        jax_pool._bin_grid = grid


def jax_simple_test(jm, variables, *args):
    return tpc.jax_call(lambda v, *a: jm.apply(
        v, *a, method="simple_test"), variables, *args)


def port_losses(pm, batch, draw):
    """The port's loss dict (floats) after the backward of its sum."""
    got = pm.forward_train({k: t(v) for k, v in batch.items()}, draw)
    sum(got.values()).backward()
    return {k: float(v.detach()) for k, v in got.items()}


def check_gradients(pm, ref_grads):
    """Every trainable tensor's gradient within 1e-4 of JAX's largest; a
    frozen one (the trunk's stem and first stage) and a BN affine behind
    its gradient stop have none, and JAX's are zero.  Returns the counts
    of the held and of the stopped trainable tensors."""
    held = stopped = 0
    for name, p in pm.named_parameters():
        ref = ref_grads[name].numpy()
        if p.grad is None:
            assert not np.abs(ref).any(), name
            stopped += p.requires_grad
            continue
        held += 1
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)
    return held, stopped


_MODELS, _RUNS = {}, {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family``, weights of seed 1,
    built once."""
    if family not in _MODELS:
        cfg = family_cfg(family)
        _MODELS[family] = (cfg, *jax_model(cfg, seed=1))
    return _MODELS[family]


def trained(family):
    """JAX's and the port's losses and gradients of one batch under the
    JAX draws, once."""
    if family not in _RUNS:
        cfg, jm, variables = models(family)
        batch, key = train_batch(), jax.random.PRNGKey(3)
        with eager_roi_pool_grid(family == "roipool"):
            ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
        pm = port_model(cfg, variables)
        got = port_losses(pm, batch, jax_forward_train_draws(
            jm, variables, key, 2, unsplit=family == "rpn_c4"))
        _RUNS[family] = (ref, got, ref_grads, pm)
    return _RUNS[family]


@pytest.mark.parametrize("config", C4_CONFIGS, ids=lambda c: c.split("/")[0])
def test_c4_configs_build_at_full_width(config):
    """The three C4 configs: the caffe ResNet-50's three stages (1024
    channels at stride 16), no neck, the RPN on those 1024, and but for
    the RPN the shared res5 head under mmdet's ``roi_head.shared_head.
    layer4.<b>`` names (its BN affines behind their gradient stop), the
    avg-pooled ``BBoxHead`` on 2048 channels, the Mask R-CNN's mask head
    on the same features (no mask extractor); parameters equal the JAX
    detector's in number and size."""
    from bonai_tpu.models import build_detector as jax_build
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.models.backbones.resnet import ResLayerSharedHead
    cfg = Config.fromfile(osp.join(ROOT, "configs", config))
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    sd = model.state_dict()
    assert model.neck is None and "layer4.0.conv1.weight" not in {
        k[len("backbone."):] for k in sd}
    assert sd["backbone.layer3.5.conv3.weight"].shape == (1024, 256, 1, 1)
    assert sd["rpn_head.rpn_conv.weight"].shape[1:] == (1024, 3, 3)
    shapes = jax.eval_shape(
        jax_build(cfg.model, cfg.train_cfg, cfg.test_cfg,
                  compute_dtype="float32").init, jax.random.PRNGKey(0),
        jnp.zeros((1, 128, 128, 3)))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    params = list(model.parameters())
    assert len(params) == len(leaves)
    assert sum(p.numel() for p in params) == sum(
        int(np.prod(x.shape)) for x in leaves)
    if cfg.model.type == "RPN":
        assert "roi_head.shared_head.layer4.0.conv1.weight" not in sd
        return
    head = model.roi_head["shared_head"]
    assert isinstance(head, ResLayerSharedHead)
    assert sd["roi_head.shared_head.layer4.0.conv1.weight"].shape == (
        512, 1024, 1, 1)
    assert head.layer4[0].conv1.stride == (2, 2)            # caffe style
    assert head.layer4[0].norm1.stops_gradient
    assert sd["roi_head.shared_head.layer4.0.downsample.0.weight"].shape \
        == (2048, 1024, 1, 1)
    assert sd["roi_head.bbox_head.fc_cls.weight"].shape == (81, 2048)
    assert not model.roi_head["bbox_head"].shared_fcs
    assert model.roi_head["bbox_head"].with_avg_pool
    if cfg.model.type == "MaskRCNN":
        assert model.mask_extractor_cfg is None
        assert sd["roi_head.mask_head.upsample.weight"].shape == (
            2048, 256, 2, 2)


@pytest.mark.parametrize("family", FAMILIES)
def test_simple_test_matches_jax(family):
    """The C4 Mask R-CNN's masks are 14x14 (the 7x7 shared-head map
    upsampled once); the C4 RPN's detections are its proposals."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    with eager_roi_pool_grid(family == "roipool"):
        ref = jax_simple_test(jm, variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {
        "det_bboxes", "det_scores", "det_labels", "det_valid"} | (
        {"mask_probs"} if family == "c4" else set())
    if family == "c4":
        assert got["mask_probs"].shape[2:] == (14, 14)
    compare_outputs(got, ref)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_matches_jax(family):
    """One step's losses and every gradient: of the C4 trunk (its caffe
    BN affines behind the gradient stop have none), the shared head, the
    pooling packs' offset and mask FCs."""
    ref, got, ref_grads, pm = trained(family)
    rpn = {"loss_rpn_cls", "loss_rpn_bbox"}
    assert set(got) == set(ref) == rpn | (
        set() if family == "rpn_c4" else {"loss_cls", "loss_bbox"}) | (
        {"loss_mask"} if family == "c4" else set())
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    held, stopped = check_gradients(pm, ref_grads)
    assert held > 30
    assert (stopped > 0) == family.endswith("c4")
    own = {"c4": "roi_head.shared_head.layer1.2.conv2.weight",
           "dpool": "roi_head.bbox_roi_extractor.roi_layers.0.offset_fc.0."
                    "weight",
           "mdpool": "roi_head.bbox_roi_extractor.roi_layers.0.mask_fc.0."
                     "weight"}.get(family)
    if own is not None:
        assert float(dict(pm.named_parameters())[own].grad.abs().max()) > 0


def _pool_inputs(seed=0):
    r = np.random.RandomState(seed)
    feat = r.randn(2, 12, 10, 8).astype(np.float32)
    xy = r.uniform(-8, 60, (20, 2))
    wh = r.uniform(1, 50, (20, 2))
    rois = np.concatenate([r.randint(0, 2, (20, 1)), xy, xy + wh],
                          1).astype(np.float32)
    offsets = r.uniform(-1.5, 1.5, (20, 7, 7, 2)).astype(np.float32)
    return feat, rois, offsets


@pytest.mark.parametrize("op", ["roi_pool", "deform_roi_pool"])
def test_pooling_functions_match_jax(op):
    """``roi_pool`` (quantised bins, a 4x4 nearest grid) and
    ``deform_roi_pool`` (offsets moving samples off the map's edge) at
    stride 8 on RoIs partly outside the map: outputs, and the gradients
    of a seeded projection of them with respect to the map (and the
    offsets)."""
    import bonai_tpu.ops.roi_pool as jax_pool
    from bonai_tpu_torch.ops import roi_pool as pool
    feat, rois, offsets = _pool_inputs()
    cot = np.random.RandomState(1).randn(20, 7, 7, 8).astype(np.float32)
    if op == "roi_pool":
        args = (feat,)

        def jfn(f):
            return jax_pool.roi_pool(f, rois, 7, 0.125, 4)

        def pfn(f):
            return pool.roi_pool(f, t(rois), 7, 0.125, 4)
    else:
        args = (feat, offsets)

        def jfn(f, o):
            return jax_pool.deform_roi_pool(f, rois, o, 7, 0.125, 0.1)

        def pfn(f, o):
            return pool.deform_roi_pool(f, t(rois), o, 7, 0.125, 0.1)
    want, vjp = jax.vjp(jfn, *args)
    want_grads = vjp(cot)
    inputs = [t(a).requires_grad_() for a in args]
    got = pfn(*inputs)
    (got * t(cot)).sum().backward()
    for g, w in [(got.detach(), want)] + [
            (i.grad, w) for i, w in zip(inputs, want_grads)]:
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_jitted_jax_roi_pool_floors_exact_edges_low():
    """A RoI of 8 cells at stride 4 puts grid points exactly on cell edges
    (``2 + 8 * (2 * 1 + 1 + 0.5) / 14 = 4``): JAX's ``roi_pool`` run op by
    op and the port floor them exactly and agree; jitted, JAX's fused
    grid arithmetic lands some a cell lower, and its output differs."""
    import bonai_tpu.ops.roi_pool as jax_pool
    from bonai_tpu_torch.ops import roi_pool as pool
    feat = np.random.RandomState(4).randn(1, 24, 24, 4).astype(np.float32)
    rois = np.array([[0, 9.58, 9.58, 35.66, 35.66]], np.float32)
    got = pool.roi_pool(t(feat), t(rois), 7, 0.25, 2).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_pool.roi_pool(feat, rois, 7, 0.25, 2))
    jitted = np.asarray(jax.jit(lambda f, r: jax_pool.roi_pool(
        f, r, 7, 0.25, 2))(feat, rois))
    np.testing.assert_array_equal(got, eager)
    assert not np.array_equal(jitted, eager)
    with eager_roi_pool_grid():
        np.testing.assert_array_equal(np.asarray(jax.jit(
            lambda f, r: jax_pool.roi_pool(f, r, 7, 0.25, 2))(feat, rois)),
            eager)


def test_deform_pool_pack_weights_in_mmdet_layout(tmp_path):
    """The mdpool pack's FCs after ``state_dict_from_jax`` hold mmcv's
    layout: the offsets computed from them as mmcv does (the first pass
    flattened ``(C, S, S)``, the output read ``(2, S, S)``) equal the JAX
    pack's ``(S, S, 2)`` offsets.  Through a ``.pth`` with mmcv's one pack
    a level (``roi_layers.0..3``, equal), ``load_mmdet_checkpoint`` gives
    the port's shared pack and the detector loads it; levels that differ
    raise ``ValueError``.  The JAX importer leaves the pack's variables at
    their initial values."""
    import flax.linen as nn
    import bonai_tpu.ops.roi_pool as jax_pool
    from bonai_tpu_torch.utils.weights import (load_mmdet_checkpoint,
                                               mmdet_state_dict,
                                               state_dict_from_jax)
    cfg, jm, variables = models("mdpool")
    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        variables["params"], variables["batch_stats"]).items()}
    pack = "roi_head.bbox_roi_extractor.roi_layers.0"
    feat, rois, _ = _pool_inputs()
    feat = np.random.RandomState(3).randn(2, 12, 10, 16).astype(np.float32)
    first = np.asarray(jax_pool.deform_roi_pool(
        feat, rois, np.zeros((20, 7, 7, 2), np.float32), 7, 0.125))
    x = first.transpose(0, 3, 1, 2).reshape(20, -1)          # (C, S, S)
    for i in (0, 2, 4):
        x = x @ sd[f"{pack}.offset_fc.{i}.weight"].T + \
            sd[f"{pack}.offset_fc.{i}.bias"]
        x = np.maximum(x, 0) if i < 4 else x
    dp = variables["params"]["bbox_dpool"]
    y = first.reshape(20, -1)                                 # (S, S, C)
    for i in range(3):
        y = np.asarray(nn.Dense(dp[f"offset_fc{i}"]["kernel"].shape[1])
                       .apply({"params": dp[f"offset_fc{i}"]}, y))
        y = np.maximum(y, 0) if i < 2 else y
    np.testing.assert_allclose(
        x.reshape(20, 2, 7, 7).transpose(0, 2, 3, 1),
        y.reshape(20, 7, 7, 2), rtol=0, atol=1e-5 * np.abs(y).max())

    per_level = dict(sd)
    for k in [k for k in sd if k.startswith(pack)]:
        for level in (1, 2, 3):
            per_level[k.replace("roi_layers.0", f"roi_layers.{level}")] = \
                sd[k]
    path = str(tmp_path / "mdpool.pth")
    torch.save({"state_dict": {k: t(v) for k, v in per_level.items()}}, path)
    loaded = load_mmdet_checkpoint(path)
    assert set(loaded) == set(sd)
    pm = port_model(cfg, variables)
    pm.load_state_dict(mmdet_state_dict(pm, loaded))
    bad = dict(per_level)
    key = f"{pack.replace('.0', '.2')}.mask_fc.0.bias"
    bad[key] = bad[key] + 1.0
    torch.save({"state_dict": {k: t(v) for k, v in bad.items()}}, path)
    with pytest.raises(ValueError, match="roi_layers.2.mask_fc.0.bias"):
        load_mmdet_checkpoint(path)
    _jax_importer_leaves(cfg, ("bbox_dpool",))


def _jax_importer_leaves(cfg, names):
    """``mmdet_checkpoint_to_params`` on the port's state dict of ``cfg``
    widened to the importer's 256 channels leaves the JAX variables
    ``names`` at their initial values (it reads no key of theirs)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    m = cfg.copy().model
    m.neck.out_channels = m.rpn_head.in_channels = 256
    m.roi_head.bbox_roi_extractor.out_channels = 256
    layer = m.roi_head.bbox_roi_extractor.roi_layer
    if "output_channels" in layer:
        layer.output_channels = 256
    m.roi_head.bbox_head.in_channels = 256
    wide = cfg.copy()
    wide.model = m
    _, variables = jax_model(wide, seed=2)
    _, start = jax_model(wide, seed=3)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        variables["params"], variables["batch_stats"]).items()}
    params, _ = mmdet_checkpoint_to_params(sd, start["params"],
                                           start["batch_stats"])
    for name in names:
        for a, b in zip(jax.tree_util.tree_leaves(params[name]),
                        jax.tree_util.tree_leaves(start["params"][name])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert not np.array_equal(params["rpn_head"]["rpn_conv"]["kernel"],
                              start["params"]["rpn_head"]["rpn_conv"][
                                  "kernel"])


def test_c4_weights_through_a_checkpoint(tmp_path):
    """The C4 detector's state dict (the shared head under ``layer1`` at
    the tiny base, the avg-pooled box head's ``fc_cls``/``fc_reg``, the
    mask head without convs) through a ``.pth`` and
    ``load_mmdet_checkpoint`` into a fresh detector: every tensor equal.
    The JAX importer reads no C4 checkpoint: it needs a neck
    (``KeyError``)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import (load_mmdet_checkpoint,
                                               mmdet_state_dict)
    cfg, _, variables = models("c4")
    pm = port_model(cfg, variables)
    sd = pm.state_dict()
    assert sd["roi_head.shared_head.layer1.0.conv1.weight"].shape == (
        64, 128, 1, 1)
    assert not any(k.startswith("roi_head.mask_head.convs") for k in sd)
    path = str(tmp_path / "c4.pth")
    torch.save({"state_dict": sd}, path)
    fresh = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    fresh.load_state_dict(mmdet_state_dict(fresh, load_mmdet_checkpoint(path)))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="neck"):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   variables["params"],
                                   variables["batch_stats"])


@pytest.mark.parametrize("change", [
    dict(strides=(1, 2, 2)), dict(dilations=(1, 1, 1)),
    dict(strides=(1, 2, 1)), dict(dilations=(1, 1, 2))],
    ids=["strides", "dilations", "strides-1-2-1", "dilations-1-1-2"])
def test_resnet_strides_and_dilations(change):
    """The values the JAX ``ResNet`` computes (it reads neither key) build;
    others raise A7."""
    from bonai_tpu_torch.models.detectors.two_stage import _build_backbone
    cfg = dict(tpc.c4_cfg().model.backbone, **change)
    if 2 in change.get("dilations", ()) or change.get("strides") == (
            1, 2, 1):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md item A7"):
            _build_backbone(cfg)
    else:
        assert len(_build_backbone(cfg).stages) == 3
