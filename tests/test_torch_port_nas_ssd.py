"""NAS-FPN RetinaNet, NAS-FCOS and SSD300 in bonai_tpu_torch against the JAX
package, in float32 on the CPU at the tiny widths of
``torch_port_common.nas_ssd_cfg`` (ResNet-18 at base 8 with a 16-channel
NAS-FPN of two stacks or NAS-FCOS FPN, 64-channel towers; SSD's VGG at
the stage widths ``TINY_VGG``, both packages' module constants set for
this file, its fc6, fc7 and extras at full width): the merge cells'
resize, the NAS-FCOS concat cell's grouped 1x1 conv, both necks, the
SSD VGG at 300^2 and 512^2, the SSD anchors, ``ssd_loss``'s hard-negative
mining on exact ties, each detector's head outputs, ``simple_test``,
losses and every gradient, one training step's updates, and the weights.

NAS-FPN runs on 224^2 images: P5 is 7x7 and P6 3x3, so the merge cells
upsample by non-integer ratios (3 -> 14, 1 -> 3), where JAX's half-pixel
nearest differs from torch's ``'nearest'``.  NAS-FCOS's gradients are held
module by module, its neck's ReLUs on JAX's activation pattern
(:func:`nasfcos_modulewise`).

Tolerances: resizes, anchors and the concat cell's grouping exact; neck
levels and head outputs 1e-5 of their largest value (NAS-FCOS's GroupNorms
over 2x2 maps: 1e-4); losses 1e-4 relative; gradients 1e-4 of their
tensor's largest element (updates of their largest update); detections
1e-3 px with identical keep sets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_port_common as tpc
from torch_port_common import jax_model, nas_ssd_cfg, port_model, t, train_batch

FAMILIES = ("nasfpn", "nasfcos", "ssd")
SIZE = {"nasfpn": 224, "nasfcos": 160, "ssd": 300}
HEAD_TOL = {"nasfpn": 1e-5, "nasfcos": 1e-4, "ssd": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _tiny_vgg():
    with tpc.tiny_vgg():
        yield


_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family`` (weights of seed 1),
    built once."""
    if family not in _MODELS:
        cfg = nas_ssd_cfg(family)
        jm, variables = jax_model(cfg, seed=1, init_size=SIZE[family])
        _MODELS[family] = (cfg, jm, variables)
    return _MODELS[family]


def _jit(fn, *args):
    return tpc.jax_call(fn, *args)


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=err_msg)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def batch_of(family, seed=0):
    """``train_batch`` at the family's size; SSD's with each image's first
    four GTs made 16..260 px wide and high (log-uniform) and the first
    one 280 px, so that every level's anchors (21..261 px) take
    positives."""
    batch = train_batch(seed=seed, size=SIZE[family])
    if family == "ssd":
        r = np.random.RandomState(seed + 10)
        wh = np.exp(r.uniform(np.log(16), np.log(260), (2, 4, 2)))
        xy = r.uniform(0, 1, (2, 4, 2)) * (SIZE["ssd"] - 1 - wh)
        batch["gt_bboxes"][:, :4] = np.concatenate([xy, xy + wh], -1)
        batch["gt_bboxes"][0, 0] = [10, 12, 290, 286]   # the 1x1 level's
    return batch


# ---------------------------------------------------------------------------
# the builder and the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_configs_build_at_full_width(family):
    """The shipped BONAI config with mmdetection's keys (on the meta
    device, SSD at VGG16's own widths)."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    import bonai_tpu_torch.models.backbones.ssd_vgg as vgg
    cfg = Config.fromfile(tpc.NAS_SSD_CONFIGS[family])
    saved, vgg.STAGE_CHANNELS = vgg.STAGE_CHANNELS, (64, 128, 256, 512, 512)
    try:
        with torch.device("meta"):
            model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    finally:
        vgg.STAGE_CHANNELS = saved
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {
        "nasfpn": {"neck.lateral_convs.0.conv.weight": (256, 512, 1, 1),
                   "neck.extra_downsamples.1.0.conv.weight":
                       (256, 256, 1, 1),
                   "neck.fpn_stages.6.gp_75_6.out_conv.conv.weight":
                       (256, 256, 3, 3),
                   "bbox_head.retina_cls.weight": (720, 256, 3, 3)},
        "nasfcos": {"neck.adapt_convs.2.conv.weight": (256, 2048, 1, 1),
                    "neck.adapt_convs.2.bn.weight": (256,),
                    "neck.fpn.c32.input1_conv.conv.weight": (256, 256, 3, 3),
                    "neck.fpn.c61.out_conv.bn.weight": (512,),
                    "neck.fpn.c61.out_conv.conv.weight": (256, 2, 1, 1),
                    "neck.extra_downsamples.1.conv.weight": (256, 256, 3, 3),
                    "bbox_head.cls_convs.0.conv.weight": (256, 256, 3, 3),
                    "bbox_head.cls_convs.0.conv.bias": (256,),
                    "bbox_head.cls_convs.2.conv.conv_offset.weight":
                        (27, 256, 3, 3),
                    "bbox_head.reg_convs.3.conv.weight": (256, 256, 1, 1),
                    "bbox_head.reg_convs.3.gn.weight": (256,),
                    "bbox_head.fcos_centerness.weight": (1, 256, 3, 3)},
        "ssd": {"backbone.features.0.weight": (64, 3, 3, 3),
                "backbone.features.21.weight": (512, 512, 3, 3),
                "backbone.features.31.weight": (1024, 512, 3, 3),
                "backbone.features.33.weight": (1024, 1024, 1, 1),
                "backbone.extra.7.weight": (256, 128, 3, 3),
                "backbone.l2_norm.weight": (512,),
                "bbox_head.cls_convs.0.weight": (8, 512, 3, 3),
                "bbox_head.reg_convs.1.weight": (24, 1024, 3, 3)}}[family]
    for k, shape in want.items():
        assert sd[k] == shape, k
    assert "neck.fpn.c32.input2_conv.conv.weight" not in sd
    assert not any(k.startswith(("rpn_head", "roi_head")) for k in sd)


def test_merge_cell_resize_matches_jax():
    """``resize_to`` equals JAX's ``_resize_to`` exactly: the half-pixel
    nearest upsample (3 -> 14, 1 -> 3, 12 -> 25 rows by 21 -> 42
    columns) and the VALID max-pool down (14 -> 7, 25 -> 6); torch's
    ``'nearest'`` differs at 12 -> 25."""
    from bonai_tpu.models.necks.nasfcos_fpn import _resize_to
    from bonai_tpu_torch.models.necks.nas_fpn import resize_to
    r = np.random.RandomState(0)
    for (h, w), (th, tw) in (((3, 3), (14, 14)), ((1, 1), (3, 3)),
                             ((12, 21), (25, 42)), ((14, 14), (7, 7)),
                             ((25, 42), (6, 10)), ((7, 7), (7, 7))):
        x = r.randn(2, h, w, 3).astype(np.float32)
        want = np.asarray(_resize_to(jnp.asarray(x), th, tw))
        got = _nhwc(resize_to(t(x).permute(0, 3, 1, 2), th, tw))
        np.testing.assert_array_equal(got, want, err_msg=f"{h}->{th}")
    x = t(r.randn(1, 3, 12, 21).astype(np.float32))
    plain = torch.nn.functional.interpolate(x, size=(25, 42), mode="nearest")
    assert not torch.equal(plain, resize_to(x, 25, 42))


def test_concat_cell_grouped_conv_reads_channel_pairs():
    """The NAS-FCOS concat cell (both input convs, inputs of 5x5 and
    10x10) equals JAX's from the converted weights; output ``g`` of the
    grouped 1x1 conv reads channels ``2g`` and ``2g + 1``: swapping each
    group's two weights changes the output."""
    from bonai_tpu.models.necks.nasfcos_fpn import ConcatCell as JaxCell
    from bonai_tpu_torch.models.necks.nasfcos_fpn import ConcatCell
    r = np.random.RandomState(1)
    x1 = r.randn(2, 5, 5, 6).astype(np.float32)
    x2 = r.randn(2, 10, 10, 6).astype(np.float32)
    jc = JaxCell(channels=6)
    shapes = jax.eval_shape(jc.init, jax.random.PRNGKey(0), x1, x2)
    params = tpc._random_tree(shapes["params"], r)
    want = _jit(lambda p, a, b: jc.apply({"params": p}, a, b), params, x1,
                x2)
    kernel = params["out_conv"]["kernel"]
    assert kernel.shape == (1, 1, 2, 6)
    cell = ConcatCell(6)
    sd = {"input1_conv.conv.weight": params["in1_conv"]["kernel"].transpose(
        3, 2, 0, 1), "input1_conv.conv.bias": params["in1_conv"]["bias"],
        "input2_conv.conv.weight": params["in2_conv"]["kernel"].transpose(
            3, 2, 0, 1), "input2_conv.conv.bias": params["in2_conv"]["bias"],
        "out_conv.bn.weight": params["out_norm"]["scale"],
        "out_conv.bn.bias": params["out_norm"]["bias"],
        "out_conv.conv.weight": kernel.transpose(3, 2, 0, 1)}
    cell.load_state_dict({k: t(v) for k, v in sd.items()})
    with torch.no_grad():
        got = cell(t(x1).permute(0, 3, 1, 2), t(x2).permute(0, 3, 1, 2))
        _close(_nhwc(got), want)
        cell.out_conv.conv.weight.copy_(cell.out_conv.conv.weight.flip(1))
        swapped = cell(t(x1).permute(0, 3, 1, 2), t(x2).permute(0, 3, 1, 2))
    assert float((swapped - got).abs().max()) > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("family", ["nasfpn", "nasfcos"])
def test_necks_match_jax(family):
    """Every level of the neck on the backbone's outputs of a
    ``SIZE``^2 batch (NAS-FCOS at 168x200: bilinear fusion with
    antialiased shrinking onto odd sizes)."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    h, w = (SIZE[family],) * 2 if family == "nasfpn" else (168, 200)
    image = np.random.RandomState(4).randn(2, h, w, 3).astype(np.float32)
    want = _jit(lambda v, x: jm.apply(v, x, method="extract_feat"),
                variables, image)
    with torch.no_grad():
        got = pm.extract_feat(t(image))
    assert len(got) == len(want) == 5
    for lvl, (g, w_) in enumerate(zip(got, want)):
        _close(_nhwc(g), w_, HEAD_TOL[family], err_msg=f"level {lvl}")


@pytest.mark.parametrize("input_size", [300, 512])
def test_ssd_vgg_matches_jax(input_size):
    """SSD's VGG at 300^2 (six levels: 38, 19, 10, 5, 3, 1) and 512^2
    (seven, the last through the 4x4 conv): every level, the first through
    the L2Norm."""
    from bonai_tpu.models.backbones.ssd_vgg import SSDVGG as JaxVGG
    from bonai_tpu_torch.models.backbones.ssd_vgg import SSDVGG
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    r = np.random.RandomState(input_size)
    x = r.randn(1, input_size, input_size, 3).astype(np.float32)
    jv = JaxVGG(input_size=input_size)
    shapes = jax.eval_shape(jv.init, jax.random.PRNGKey(0), x)
    params = tpc._random_tree(shapes["params"], r)
    want = _jit(lambda p, a: jv.apply({"params": p}, a), params, x)
    vgg = SSDVGG(input_size)
    sd = state_dict_from_jax({"backbone": params}, {})
    vgg.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = vgg(t(x).permute(0, 3, 1, 2))
    assert [g.shape[-1] for g in got] == (
        [38, 19, 10, 5, 3, 1] if input_size == 300
        else [64, 32, 16, 8, 4, 2, 1])
    for lvl, (g, w) in enumerate(zip(got, want)):
        _close(_nhwc(g), w, err_msg=f"level {lvl}")


@pytest.mark.parametrize("legacy", [False, True])
def test_ssd_anchors_match_jax(legacy):
    """``SSDAnchorGenerator`` (and the legacy one) at 300^2 and 512^2,
    exactly; at the BONAI test scale, 1024^2, the 300 anchors' last two
    levels (strides 100 and 300) reach past the image."""
    from bonai_tpu.core import anchors as jax_anchors
    from bonai_tpu_torch.core.anchors import SSDAnchorGenerator
    cls = (jax_anchors.LegacySSDAnchorGenerator if legacy
           else jax_anchors.SSDAnchorGenerator)
    for size, rng, strides, ratios, maps in (
            (300, (0.15, 0.9), [8, 16, 32, 64, 100, 300],
             [[2], [2, 3], [2, 3], [2, 3], [2], [2]],
             [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]),
            (512, (0.1, 0.9), [8, 16, 32, 64, 128, 256, 512],
             [[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]],
             [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2),
              (1, 1)])):
        kw = dict(strides=strides, ratios=ratios, basesize_ratio_range=rng,
                  input_size=size, scale_major=False)
        want = cls(**kw).grid_anchors(maps)
        got = SSDAnchorGenerator(legacy=legacy, **kw).grid_anchors(maps)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    big = SSDAnchorGenerator(strides=[8, 16, 32, 64, 100, 300],
                             ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
                             basesize_ratio_range=(0.15, 0.9)).grid_anchors(
        [(128, 128), (64, 64), (32, 32), (16, 16), (14, 14), (12, 12)])
    assert big[4][:, 2].max() > 1024 and big[5][:, 0].max() > 3000


def test_ssd_loss_mines_exact_ties_as_jax():
    """``ssd_loss`` on logits of a few distinct values (every negative of
    a value ties exactly with the others), 4 of 9 images' worth of
    positives: the losses equal JAX's and the gradient reaches exactly
    the negatives JAX mines (ties to the lower anchor index), with the
    same values."""
    from bonai_tpu.models.dense_heads.ssd_head import ssd_loss as jax_loss
    from bonai_tpu_torch.core.anchors import SSDAnchorGenerator
    from bonai_tpu_torch.models.dense_heads.ssd_head import ssd_loss
    gen = SSDAnchorGenerator(strides=[8, 16, 32, 64, 100, 300],
                             ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
                             basesize_ratio_range=(0.15, 0.9))
    maps = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    anchors = np.concatenate(gen.grid_anchors(maps))
    r = np.random.RandomState(5)
    cls = [np.round(r.randn(2, h, w, a * 2)).astype(np.float32) / 2
           for (h, w), a in zip(maps, (4, 6, 6, 6, 4, 4))]
    reg = [r.randn(2, h, w, a * 4).astype(np.float32) * 0.1
           for (h, w), a in zip(maps, (4, 6, 6, 6, 4, 4))]
    batch = batch_of("ssd")
    args = (batch["gt_bboxes"], batch["gt_valid"], batch["gt_labels"])
    train_cfg = dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                   min_pos_iou=0.0), neg_pos_ratio=3,
                     smoothl1_beta=1.0)

    def jax_total(c, g):
        losses = jax_loss(c, g, anchors, *args, 1, train_cfg)
        return sum(losses.values()), losses
    (_, want), (g_cls, _) = _jit(jax.value_and_grad(jax_total, argnums=(0, 1),
                                                    has_aux=True), cls, reg)
    tc = [t(c).permute(0, 3, 1, 2).requires_grad_() for c in cls]
    tr = [t(g).permute(0, 3, 1, 2).requires_grad_() for g in reg]
    got = ssd_loss(tc, tr, t(anchors), *(t(a) for a in args), 1, train_cfg)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    sum(got.values()).backward()
    ties = 0
    for c, g, w in zip(cls, tc, g_cls):
        got_g = _nhwc(g.grad)
        np.testing.assert_array_equal(got_g != 0, np.asarray(w) != 0)
        _close(got_g, w, 1e-5)
        ties += len(c.reshape(-1, 2)) - len(np.unique(c.reshape(-1, 2), axis=0))
    assert ties > 1000


# ---------------------------------------------------------------------------
# the detectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_head_outputs_and_detections_match_jax(family):
    """Every level's head outputs, then ``simple_test``'s detections on a
    batch of two (the second image a resized, padded one)."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    size = SIZE[family]
    image = np.random.RandomState(2).randn(2, size, size, 3).astype(
        np.float32)
    img_shape = np.array([[size, size], [size - 24, size - 10]], np.float32)
    scale = np.array([1.0, 0.8], np.float32)
    ref_outs = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    assert len(outs) == len(ref_outs)
    for kind, (got, want) in enumerate(zip(outs, ref_outs)):
        assert len(got) == len(want) == (6 if family == "ssd" else 5)
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(_nhwc(g), w, HEAD_TOL[family],
                   err_msg=f"output {kind} level {lvl}")
    ref = _jit(lambda v, *a: jm.apply(v, *a, method="simple_test"),
               variables, image, img_shape, scale)
    got = pm.simple_test(t(image), t(img_shape), t(scale))
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


def test_nasfcos_fcoshead_branch_matches_jax():
    """NAS-FCOS with a ``bbox_head`` of type ``FCOSHead`` (the COCO
    ``nas_fcos_fcoshead`` configs' branch): FCOS's GN towers on the
    searched FPN, every level's outputs against JAX's."""
    cfg = nas_ssd_cfg("nasfcos")
    cfg.model.bbox_head.update(type="FCOSHead", stacked_convs=2)
    jm, variables = jax_model(cfg, seed=3, init_size=SIZE["nasfcos"])
    pm = port_model(cfg, variables)
    assert type(pm.bbox_head).__name__ == "FCOSHead"
    image = np.random.RandomState(5).randn(1, 160, 160, 3).astype(
        np.float32)
    ref = _jit(lambda v, x: jm.apply(v, x), variables, image)
    with torch.no_grad():
        outs = pm.bbox_head(pm.extract_feat(t(image)))
    for kind, (got, want) in enumerate(zip(outs, ref)):
        for lvl, (g, w) in enumerate(zip(got, want)):
            _close(_nhwc(g), w, 1e-4, err_msg=f"output {kind} level {lvl}")


_TRAINED = {}


def _jax_grads_and_cotangents(jm, variables, batch, names):
    """JAX's loss gradients of one batch, and the cotangents of the
    outputs of the detector's submodules ``names`` (flax names) with
    their values: each output gets a zero perturbation through
    ``nn.intercept_methods``, whose gradient is its cotangent."""
    import flax.linen as nn
    stats = variables["batch_stats"]

    def run(params, deltas, record):
        top = None

        def intercept(next_fun, args, kwargs, context):
            nonlocal top
            if top is None:                     # the detector's own call
                top = context.module
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__" \
                    and context.module.name in names \
                    and context.module.parent is top:
                record[context.module.name] = out
                if deltas is not None:
                    out = jax.tree_util.tree_map(jnp.add, out,
                                                 deltas[context.module.name])
            return out
        with nn.intercept_methods(intercept):
            losses = jm.apply({"params": params, "batch_stats": stats},
                              batch, method="forward_train")
        return sum(losses.values())

    def values(params):
        record = {}
        run(params, None, record)
        return record
    acts = _jit(values, variables["params"])
    zeros = jax.tree_util.tree_map(np.zeros_like, acts)
    grads, cot = _jit(jax.grad(lambda p, d: run(p, d, {}), argnums=(0, 1)),
                      variables["params"], zeros)
    return grads, acts, cot


def _relu_on(masks):
    """``F`` of a module with its ``relu`` on the given masks, in call
    order."""
    import torch.nn.functional as F

    class Masked:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x):
            return torch.where(masks.pop(0), x, x.new_zeros(()))
    return Masked()


def nasfcos_modulewise(cfg, jm, variables, batch):
    """NAS-FCOS's gradients module by module: its float32 gradient through
    the whole chain is ill-conditioned (the neck's per-channel GroupNorms
    put ReLU inputs within float noise of 0: the port's own float32
    gradients differ from its float64 ones by 1e-3 of their largest).  The
    backbone runs under JAX's cotangents of its outputs, the neck on JAX's
    backbone outputs under JAX's cotangents of its outputs with its ReLUs
    on JAX's activation pattern (each ReLU input whose sign differs lies
    within 1e-5 of its map's largest value of 0 in both), and the head and
    loss on JAX's neck outputs.  Returns the port's gradients, JAX's, and
    JAX's cotangents of the neck outputs against the port's."""
    import bonai_tpu_torch.models.necks.nasfcos_fpn as neck_mod
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    grads, acts, cot = _jax_grads_and_cotangents(jm, variables, batch,
                                                 ("backbone", "neck"))
    inter = _jit(lambda v, x: jm.apply(
        v, x, method="extract_feat", capture_intermediates=True,
        mutable=["intermediates"])[1], variables, batch["image"])[
        "intermediates"]["neck"]
    pre = [inter[f"adapt_bn{i}"]["__call__"][0] for i in (1, 2, 3)]
    for name, _, _, w1, w2 in neck_mod.CELLS:
        pre += [inter[name][f"in{k}_conv"]["__call__"][0]
                for k, w in ((1, w1), (2, w2)) if w]
        pre.append(inter[name]["out_norm"]["__call__"][0])
    pre.append(inter["extra0"]["__call__"][0])
    pm = port_model(cfg, variables)
    tb = {k: t(v) for k, v in batch.items()}

    def leaf(a):
        return t(np.asarray(a)).permute(0, 3, 1, 2).contiguous() \
            .requires_grad_()

    feats = [leaf(a) for a in acts["neck"]]
    sum(pm._loss(pm.bbox_head(feats), feats, tb).values()).backward()
    masks = [t(np.asarray(p) > 0).permute(0, 3, 1, 2) for p in pre]
    seen = []
    saved = neck_mod.F
    neck_mod.F = _relu_on(masks)
    try:
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append(o)) for m in pm.neck.modules()
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.Conv2d))]
        outs = pm.neck([leaf(a) for a in acts["backbone"]])
    finally:
        neck_mod.F = saved
        for h in hooks:
            h.remove()
    assert not masks
    for want in pre:
        got = next(o for o in seen if tuple(o.shape) == (
            want.shape[0], want.shape[3], want.shape[1], want.shape[2])
            and float((_nhwc(o) - want).__abs__().max())
            <= 1e-4 * np.abs(want).max())
        flips = (_nhwc(got) > 0) != (np.asarray(want) > 0)
        edge = 1e-5 * np.abs(want).max()
        assert (np.abs(np.asarray(want))[flips] <= edge).all()
        assert (np.abs(_nhwc(got))[flips] <= edge).all()
    torch.autograd.backward(list(outs), [t(np.asarray(c)).permute(
        0, 3, 1, 2) for c in cot["neck"]])
    pairs = [(o, t(np.asarray(c)).permute(0, 3, 1, 2))
             for o, c in zip(pm.backbone(tb["image"].permute(
                 0, 3, 1, 2).contiguous()), cot["backbone"])
             if o.requires_grad]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return (pm, state_dict_from_jax(grads, variables["batch_stats"]),
            [(f.grad, c) for f, c in zip(feats, cot["neck"])])


def trained(family):
    """JAX's losses and gradients of one batch and the port's, once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    if family not in _TRAINED:
        cfg, jm, variables = models(family)
        batch = batch_of(family)

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
    assert set(got) == set(ref) == {"loss_cls", "loss_bbox"} | (
        {"loss_centerness"} if family == "nasfcos" else set())
    for k in ref:
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """Every trainable tensor's gradient: through the whole chain for
    NAS-FPN and SSD, module by module for NAS-FCOS
    (:func:`nasfcos_modulewise`; its head's deformable convs' kernels,
    biases and ``conv_offset`` included, and the head and loss's
    cotangents of the neck outputs against JAX's)."""
    if family == "nasfcos":
        cfg, jm, variables = models(family)
        pm, ref_grads, cots = nasfcos_modulewise(cfg, jm, variables,
                                                 batch_of(family))
        for got, want in cots:
            _close(_nhwc(got), want, 1e-4)
    else:
        _, _, ref_grads, pm = trained(family)
    grads = {n: p.grad for n, p in pm.named_parameters() if p.requires_grad}
    assert all(g is not None for g in grads.values())
    for name, g in grads.items():
        _close(g.numpy(), ref_grads[name].numpy(), 1e-4, err_msg=name)
    nonzero = {"nasfpn": ["neck.fpn_stages.0.gp_64_4.out_conv.conv.weight",
                          "neck.extra_downsamples.0.0.conv.weight"],
               "nasfcos": ["neck.fpn.c02.out_conv.conv.weight",
                           "neck.extra_downsamples.1.norm.weight",
                           "bbox_head.cls_convs.2.conv.conv_offset.weight",
                           "bbox_head.reg_convs.0.conv.bias"],
               "ssd": ["backbone.l2_norm.weight", "backbone.extra.7.weight",
                       "backbone.features.0.weight",
                       "bbox_head.cls_convs.5.weight"]}[family]
    for name in nonzero:
        assert float(grads[name].abs().max()) > 0, name


def test_nasfpn_train_step_updates_match_jax():
    """One SGD step (LR 1, momentum 0.9, weight decay 1e-2, a clip at 35)
    of NAS-FPN RetinaNet through ``make_train_step``: every parameter's
    update against optax's over the JAX frozen mask."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from test_torch_port_trunks import LR, WD, _jax_step
    cfg, jm, variables = models("nasfpn")
    batch = batch_of("nasfpn")
    max_norm = 35.0
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
    ``.pth`` (NAS-FCOS's without its plain tower convs' biases: zeros
    then; its BatchNorm statistics where the port has per-channel
    GroupNorms are dropped).  A NAS-FCOS head of mmdetection's two
    deformable offset groups raises ``ValueError``; the JAX importer
    reads ``rpn_head.*`` unconditionally and raises ``KeyError``
    (ROADMAP.md queue C)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, _, variables = models(family)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    pm = port_model(cfg, variables)
    assert set(pm.state_dict()) == set(sd)
    biases = [k for k in sd if k.endswith(".conv.bias")
              and k[:-len("conv.bias")] + "gn.weight" in sd
              and k[:-len("bias")] + "conv_offset.weight" not in sd]
    assert bool(biases) == (family == "nasfcos")
    mm = {k: v for k, v in sd.items() if k not in biases}
    for k in [k for k in sd if k.endswith(".bn.weight")]:   # NAS-FCOS's
        mm[k[:-len("weight")] + "running_mean"] = torch.zeros_like(sd[k])
        mm[k[:-len("weight")] + "num_batches_tracked"] = torch.tensor(0)
    pth = tmp_path / "mmdet.pth"
    torch.save({"state_dict": mm, "meta": {}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, torch.zeros_like(v) if k in biases
                           else sd[k]), k
    if family == "nasfcos":
        key = "bbox_head.cls_convs.0.conv.conv_offset.weight"
        mm[key] = torch.cat([mm[key], mm[key]])
        torch.save({"state_dict": mm}, pth)
        with pytest.raises(ValueError, match="two offset groups|2 offset"):
            init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    with pytest.raises(KeyError):
        mmdet_checkpoint_to_params({k: v.numpy() for k, v in sd.items()},
                                   zeros["params"], zeros["batch_stats"])
