"""The R-CNN trunk variants' modules in bonai_tpu_torch against the JAX
package, in float32 on the CPU with the same numpy-seeded weights:
deformable convolution v1/v2 (``ops/deform_conv.py``), GCNet's
``ContextBlock`` and the ``GeneralizedAttention`` block
(``ops/layers.py``), tiny ResNet-50 (DCN, plugins), Res2Net and RegNet
backbones and a tiny PAFPN, RegNetX-3.2GF's stage plan, the mmdet keys of
each module and their round trip, the JAX importer's reading of such
checkpoints, and the build sweep over the BONAI configs.

Tolerances: ``deform_conv2d``'s forward 1e-5 and its gradients (input,
offset, mask, kernel) 1e-4 of each one's largest magnitude; the attention
blocks' outputs 1e-5 and gradients 1e-4 of the largest magnitude; every
backbone stage and neck level 1e-5 of its largest magnitude; the stage
plan and the weight round trip exact.
"""

import glob
import os.path as osp
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_port_common import (ROOT, TINY_REGNET, TRUNK_CONFIGS, _random_tree,
                               jax_model, meta_device, t, trunk_cfg)


def _close(got, want, tol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def nchw(x):
    return t(x).permute(0, 3, 1, 2).contiguous()


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

def _planted_offsets(r, b, ho, wo, groups, kk, h, w, stride, pad):
    """Random offsets (about +-1.5 px) with samples planted in both border
    bands, ``(-1, 0)`` and ``(h - 1, h)`` (and ``w``'s), exactly on the
    clip bounds and past the map; ``(B, Ho, Wo, G*2*KK)`` (mmcv's
    layout)."""
    off = r.normal(0, 1.5, (b, ho, wo, groups, kk, 2))
    base_y = np.arange(ho) * stride - pad        # kernel point 0
    base_x = np.arange(wo) * stride - pad
    planted = (-0.5, h - 0.5, -0.25, h - 0.75, 0.0, h - 1.0, -1.5, h + 0.3)
    for j, target in enumerate(planted):
        i, k = j % ho, (j // ho) % wo
        off[:, i, k, :, 0, 0] = target - base_y[i]
        off[:, i, k, :, 0, 1] = (target if target < h else w - 0.5) \
            - base_x[k]
    return off.reshape(b, ho, wo, -1).astype(np.float32)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("groups,stride,dil", [
    (1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 1, 2)])
def test_deform_conv2d_matches_jax(v2, groups, stride, dil):
    """Forward and the gradients with respect to the input, the offsets,
    the mask logits and the kernel, with samples inside the map, in both
    border bands (clipped before the interpolation, the JAX rule), on the
    bounds and past the map; ``deform_groups`` 1 and 2, stride 1 and 2,
    dilation 1 and 2 (padding as the dilation)."""
    from bonai_tpu.ops.deform_conv import deform_conv2d as jax_dcn
    from bonai_tpu_torch.ops.deform_conv import deform_conv2d
    r = np.random.RandomState(groups * 10 + stride + 100 * v2 + 1000 * dil)
    b, h, w, cin, cout, k = 2, 7, 9, 4, 3, 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = r.randn(b, h, w, cin).astype(np.float32)
    off = _planted_offsets(r, b, ho, wo, groups, k * k, h, w, stride, dil)
    mask = r.randn(b, ho, wo, groups * k * k).astype(np.float32) \
        if v2 else None
    ker = r.randn(k, k, cin, cout).astype(np.float32)
    gy = r.randn(b, ho, wo, cout).astype(np.float32)

    def jax_loss(x, off, ker, mask):
        out = jax_dcn(x, off, ker, None, stride, dil, dil, mask=mask,
                      deform_groups=groups)
        return jnp.sum(out * gy), out

    args = (x, off, ker) + ((mask,) if v2 else (None,))
    (_, ref), grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3) if v2 else (0, 1, 2),
        has_aux=True))(*args)
    tx, to = nchw(x).requires_grad_(), nchw(off).requires_grad_()
    tm = nchw(mask).requires_grad_() if v2 else None
    tk = t(ker).permute(3, 2, 0, 1).contiguous().requires_grad_()
    out = deform_conv2d(tx, to, tk, None, stride, dil, dil, tm, groups)
    _close(nhwc(out), ref, 1e-5)
    (out * nchw(gy)).sum().backward()
    _close(nhwc(tx.grad), grads[0], 1e-4)
    _close(nhwc(to.grad), grads[1], 1e-4)
    _close(tk.grad.permute(2, 3, 1, 0).numpy(), grads[2], 1e-4)
    if v2:
        _close(nhwc(tm.grad), grads[3], 1e-4)
    assert np.abs(np.asarray(grads[1])).max() > 0


def test_deform_border_band_reads_the_edge_at_full_weight():
    """The JAX border rule (ROADMAP.md queue C): a sample at ``y = -0.5``
    (or ``h - 0.5``) is clipped to the edge row, then interpolated, so it
    reads that row at full weight; mmcv's per-corner zeros would give it
    half.  Past ``-1`` or ``h`` it reads 0."""
    from bonai_tpu.ops.deform_conv import deform_conv2d as jax_dcn
    from bonai_tpu_torch.ops.deform_conv import deform_conv2d
    x = np.arange(1.0, 13.0, dtype=np.float32).reshape(1, 3, 4, 1)
    ker = np.ones((1, 1, 1, 1), np.float32)
    dy = np.array([-0.5, 2.5, -1.0, 3.0], np.float32)   # h = 3
    off = np.zeros((1, 3, 4, 2), np.float32)
    off[0, 0, :, 0] = dy - 0.0                          # output row 0
    ref = np.asarray(jax_dcn(x, off, ker, None, 1, 0, 1))
    got = nhwc(deform_conv2d(nchw(x), nchw(off), t(ker).permute(
        3, 2, 0, 1).contiguous(), None, 1, 0, 1))
    np.testing.assert_array_equal(got, ref)
    row = got[0, 0, :, 0]
    np.testing.assert_array_equal(row, [x[0, 0, 0, 0], x[0, 2, 1, 0],
                                        0.0, 0.0])


def test_zero_offset_conv_offset_gradient_matches_jax():
    """A fresh DCNv2 layer (``conv_offset`` at zero): every sample lies on
    the integer grid, the edge rows and columns exactly on a clip bound.
    The first step's ``conv_offset`` gradient is JAX's (``jnp.clip``'s 0.5
    at a bound; ``torch.clamp``'s 1 would differ there)."""
    from bonai_tpu.ops.deform_conv import ModulatedDeformConv2d
    from bonai_tpu_torch.ops.deform_conv import ModulatedDeformConv2dPack
    from bonai_tpu_torch.utils.weights import _conv
    r = np.random.RandomState(3)
    x = r.randn(2, 6, 5, 4).astype(np.float32)
    gy = r.randn(2, 6, 5, 3).astype(np.float32)
    jm = ModulatedDeformConv2d(features=3, deform_groups=2)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    params = {"kernel": r.randn(3, 3, 4, 3).astype(np.float32),
              "conv_offset": {"kernel": np.zeros((3, 3, 4, 54), np.float32),
                              "bias": np.zeros(54, np.float32)}}

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, x) * gy)
    ref = jax.jit(jax.grad(loss))(params)["conv_offset"]
    m = ModulatedDeformConv2dPack(4, 3, deform_groups=2)
    m.load_state_dict({"weight": t(_conv(params["kernel"])),
                       "conv_offset.weight": torch.zeros(54, 4, 3, 3),
                       "conv_offset.bias": torch.zeros(54)})
    (m(nchw(x)) * nchw(gy)).sum().backward()
    _close(m.conv_offset.weight.grad.numpy(), _conv(ref["kernel"]), 1e-4)
    _close(m.conv_offset.bias.grad.numpy(), ref["bias"], 1e-4)
    assert np.abs(np.asarray(ref["kernel"])).max() > 0


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------

def _plugin_state_dict(params):
    """A JAX plugin's variables as the port module's ``state_dict``,
    through ``state_dict_from_jax``'s plugin mapping."""
    from bonai_tpu_torch.utils import weights
    sd = {}

    def layer(key, p, weight=weights._conv):
        sd[f"{key}.weight"] = weight(p["kernel"])
        if "bias" in p:
            sd[f"{key}.bias"] = np.asarray(p["bias"])
    weights._plugin("m", {"after_conv3_plugin0": params},
                    "after_conv3_plugin0", sd, layer)
    return {k.split(".", 2)[2]: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _block_matches_jax(jax_block, port_block, x, seed):
    """The block's output and the gradients of the input and every
    parameter, JAX against the port, from the same seeded variables."""
    r = np.random.RandomState(seed)
    shapes = jax.eval_shape(jax_block.init, jax.random.PRNGKey(0), x)
    params = _random_tree(shapes["params"], r)
    port_block.load_state_dict(_plugin_state_dict(params))
    gy = r.randn(*x.shape).astype(np.float32)

    def loss(p, x):
        out = jax_block.apply({"params": p}, x)
        return jnp.sum(out * gy), out
    (_, ref), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    tx = nchw(x).requires_grad_()
    out = port_block(tx)
    _close(nhwc(out), ref, 1e-5)
    (out * nchw(gy)).sum().backward()
    _close(nhwc(tx.grad), g_x, 1e-4)
    want = _plugin_state_dict(jax.device_get(g_params))
    got = dict(port_block.named_parameters())
    assert set(want) == set(got)
    top = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        if k == "conv_mask.bias":
            # shifts every logit of the softmax alike: its gradient is 0
            # but for float noise
            assert max(float(v.abs().max()),
                       float(got[k].grad.abs().max())) <= 1e-5 * top
            continue
        # a conv of no term ('0100' builds query_conv, as JAX, unread)
        grad = got[k].grad
        _close(np.zeros(v.shape, np.float32) if grad is None
               else grad.numpy(), v.numpy(), 1e-4)


@pytest.mark.parametrize("pooling,fusion", [
    ("att", ("channel_add",)), ("avg", ("channel_add",)),
    ("att", ("channel_mul",)), ("avg", ("channel_add", "channel_mul"))])
def test_context_block_matches_jax(pooling, fusion):
    from bonai_tpu.ops.layers import ContextBlock as JaxBlock
    from bonai_tpu_torch.ops.layers import ContextBlock
    x = np.random.RandomState(0).randn(2, 5, 7, 16).astype(np.float32)
    _block_matches_jax(
        JaxBlock(ratio=1. / 4, pooling_type=pooling, fusion_types=fusion),
        ContextBlock(16, 1. / 4, pooling, fusion), x, 1)


def test_context_block_layer_norm_epsilon_is_flax():
    """flax's LayerNorm adds 1e-6 (ROADMAP.md queue C; mmcv's, torch's
    default, 1e-5): on a context transform of small variance the two
    differ by far more than the port's tolerance."""
    from bonai_tpu.ops.layers import ContextBlock as JaxBlock
    from bonai_tpu_torch.ops.layers import ContextBlock
    x = (np.random.RandomState(0).randn(1, 4, 4, 8) * 1e-3).astype(
        np.float32)
    jb = JaxBlock(ratio=1. / 2, pooling_type="avg")
    params = _random_tree(jax.eval_shape(
        jb.init, jax.random.PRNGKey(0), x)["params"],
        np.random.RandomState(1))
    params["channel_add_conv1"]["bias"][:] = 0.0
    ref = np.asarray(jb.apply({"params": params}, x))
    pb = ContextBlock(8, 1. / 2, "avg")
    pb.load_state_dict(_plugin_state_dict(params))
    assert pb.channel_add_conv[1].eps == 1e-6
    with torch.no_grad():
        _close(nhwc(pb(nchw(x))), ref, 1e-5)
        pb.channel_add_conv[1].eps = 1e-5
        off = np.abs(nhwc(pb(nchw(x))) - ref).max()
    assert off > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("terms,kv_stride,q_stride,size", [
    ("1111", 2, 1, (9, 7)), ("1000", 2, 1, (6, 8)), ("0100", 1, 1, (5, 6)),
    ("0010", 2, 1, (7, 7)), ("0001", 2, 1, (7, 5)), ("1111", 1, 2, (7, 9))])
def test_generalized_attention_matches_jax(terms, kv_stride, q_stride, size):
    """All four terms, each alone, ``kv_stride`` 2 on odd sizes, and
    ``q_stride`` 2 (the bilinear resize back to ``x``'s size)."""
    from bonai_tpu.ops.layers import GeneralizedAttention as JaxBlock
    from bonai_tpu_torch.ops.layers import GeneralizedAttention
    x = np.random.RandomState(2).randn(2, *size, 16).astype(np.float32)
    _block_matches_jax(
        JaxBlock(num_heads=4, attention_type=terms, kv_stride=kv_stride,
                 q_stride=q_stride),
        GeneralizedAttention(16, num_heads=4, attention_type=terms,
                             kv_stride=kv_stride, q_stride=q_stride), x, 3)


def test_attention_block_has_no_gamma_and_starts_as_identity():
    """As in the JAX package (ROADMAP.md queue C): no ``gamma``; the zero
    ``proj_conv`` makes a fresh block the identity."""
    from bonai_tpu_torch.ops.layers import GeneralizedAttention
    m = GeneralizedAttention(16, num_heads=4)
    m.init_weights(torch.Generator().manual_seed(0))
    assert "gamma" not in dict(m.named_parameters())
    assert {"query_conv.weight", "geom_query_conv.weight", "appr_bias",
            "geom_bias", "appr_geom_fc_x.weight", "proj_conv.bias"} \
        <= set(m.state_dict())
    x = torch.randn(2, 16, 6, 5)
    with torch.no_grad():
        assert torch.equal(m(x), x)


# ---------------------------------------------------------------------------
# backbones and neck
# ---------------------------------------------------------------------------

def _stages_match(jax_module, variables, port_module, img):
    ref = jax.device_get(jax.jit(jax_module.apply)(variables, img))
    with torch.no_grad():
        got = port_module(nchw(img))
    assert len(got) == len(ref)
    for g, want in zip(got, ref):
        _close(nhwc(g), want, 1e-5)
    return got


def _backbone_pair(family):
    """The JAX backbone module of a tiny trunk config, its seeded
    variables and the port's backbone carrying them."""
    from bonai_tpu.models.detectors.builders import build_backbone_m
    from bonai_tpu_torch.models.detectors.two_stage import _build_backbone
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = trunk_cfg(family).model.backbone
    jm = build_backbone_m(cfg.to_dict() if hasattr(cfg, "to_dict")
                          else dict(cfg), jnp.float32)
    img = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), img)
    r = np.random.RandomState(5)
    variables = {k: _random_tree(v, r) for k, v in shapes.items()}
    sd = state_dict_from_jax({"backbone": variables["params"], "neck": {}},
                             {"backbone": variables["batch_stats"]})
    pm = _build_backbone(cfg)
    pm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    return jm, variables, pm.eval(), img


@pytest.mark.parametrize("family", ["dcn", "gcnet", "attention", "res2net",
                                    "regnet"])
def test_tiny_backbones_match_jax(family):
    """Every stage of ResNet-50 at base 8 (DCNv2 in c3-c5, the context
    blocks after conv3 of c3-c5, the attention blocks after conv2 of
    c4-c5), Res2Net-50 at base width 4 and the tiny RegNetX."""
    jm, variables, pm, img = _backbone_pair(family)
    got = _stages_match(jm, variables, pm, img)
    widths = [8, 16, 32, 64] if family == "regnet" else [32, 64, 128, 256]
    assert [g.shape[1] for g in got] == widths
    assert [g.shape[2] for g in got] == [16, 8, 4, 2]


def test_tiny_pafpn_matches_jax():
    from bonai_tpu.models.necks.fpn import PAFPN as JaxPAFPN
    from bonai_tpu_torch.models.necks.pafpn import PAFPN
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    r = np.random.RandomState(6)
    feats = tuple(r.randn(2, s, s, c).astype(np.float32)
                  for s, c in ((16, 8), (8, 16), (4, 32), (2, 64)))
    jm = JaxPAFPN(in_channels=(8, 16, 32, 64), out_channels=12, num_outs=5)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)
    params = _random_tree(shapes["params"], r)
    sd = state_dict_from_jax({"backbone": {}, "neck": params},
                             {"backbone": {}})
    pm = PAFPN((8, 16, 32, 64), 12, 5)
    pm.load_state_dict({k[len("neck."):]: v for k, v in sd.items()})
    ref = jax.device_get(jax.jit(jm.apply)({"params": params}, feats))
    with torch.no_grad():
        got = pm(tuple(nchw(f) for f in feats))
    assert [g.shape[2] for g in got] == [16, 8, 4, 2, 1]
    for g, want in zip(got, ref):
        _close(nhwc(g), want, 1e-5)


def test_regnet_stage_plans():
    """RegNetX-3.2GF: widths [96, 192, 432, 1008], blocks [2, 6, 15, 2],
    groups [2, 4, 9, 21], as the JAX plan; the tiny arch dict's plan."""
    from bonai_tpu.models.backbones.resnet import RegNet as JaxRegNet
    from bonai_tpu_torch.models.backbones.resnet import RegNet
    cfg = RegNet.ARCH_SETTINGS["regnetx_3.2gf"]
    w, b, bw, g = RegNet.stage_plan(cfg)
    assert (w, b, bw, g) == ([96, 192, 432, 1008], [2, 6, 15, 2],
                             [96, 192, 432, 1008], [2, 4, 9, 21])
    for arch in list(RegNet.ARCH_SETTINGS.values()) + [TINY_REGNET]:
        assert RegNet.stage_plan(arch) == JaxRegNet.stage_plan(arch)
    assert RegNet.ARCH_SETTINGS == JaxRegNet.ARCH_SETTINGS
    assert RegNet.stage_plan(TINY_REGNET)[:2] == ([8, 16, 32, 64],
                                                  [1, 1, 2, 2])


# ---------------------------------------------------------------------------
# weights, the JAX importer, the build sweep
# ---------------------------------------------------------------------------

# the mmdet v2.3 / mmcv keys of each new module at full width, by config
FULL_WIDTH_KEYS = {
    "dcn": {"backbone.layer2.0.conv2.weight": (128, 128, 3, 3),
            "backbone.layer2.0.conv2.conv_offset.weight": (27, 128, 3, 3),
            "backbone.layer4.2.conv2.conv_offset.bias": (27,),
            "backbone.layer1.0.conv2.weight": (64, 64, 3, 3)},
    "gcnet": {"backbone.layer2.0.context_block.conv_mask.weight":
              (1, 512, 1, 1),
              "backbone.layer2.0.context_block.conv_mask.bias": (1,),
              "backbone.layer3.5.context_block.channel_add_conv.0.weight":
              (256, 1024, 1, 1),
              "backbone.layer3.5.context_block.channel_add_conv.1.weight":
              (256, 1, 1),
              "backbone.layer4.2.context_block.channel_add_conv.3.bias":
              (2048,)},
    "attention": {
        "backbone.layer3.0.gen_attention_block.query_conv.weight":
        (256, 256, 1, 1),
        "backbone.layer3.0.gen_attention_block.key_conv.weight":
        (256, 256, 1, 1),
        "backbone.layer4.2.gen_attention_block.value_conv.weight":
        (512, 512, 1, 1),
        "backbone.layer4.2.gen_attention_block.appr_geom_fc_x.weight":
        (64, 256),
        "backbone.layer3.1.gen_attention_block.appr_geom_fc_y.weight":
        (32, 128),
        "backbone.layer3.1.gen_attention_block.proj_conv.bias": (256,),
        "backbone.layer3.1.gen_attention_block.appr_bias": (256,),
        "backbone.layer3.1.gen_attention_block.geom_bias": (256,),
        "backbone.layer3.1.gen_attention_block.geom_query_conv.weight":
        (256, 256, 1, 1)},
    "res2net": {"backbone.stem.0.weight": (32, 3, 3, 3),
                "backbone.stem.4.running_var": (32,),
                "backbone.stem.6.weight": (64, 32, 3, 3),
                "backbone.stem.7.bias": (64,),
                "backbone.layer1.0.convs.2.weight": (26, 26, 3, 3),
                "backbone.layer1.0.bns.0.weight": (26,),
                "backbone.layer1.0.downsample.1.weight": (256, 64, 1, 1),
                "backbone.layer2.0.downsample.2.running_mean": (512,),
                "backbone.layer4.2.conv3.weight": (2048, 832, 1, 1)},
    "regnet": {"backbone.conv1.weight": (32, 3, 3, 3),
               "backbone.layer1.0.conv2.weight": (96, 48, 3, 3),
               "backbone.layer3.14.conv2.weight": (432, 48, 3, 3),
               "backbone.layer4.0.downsample.0.weight": (1008, 432, 1, 1),
               "neck.lateral_convs.3.conv.weight": (256, 1008, 1, 1)},
    "pafpn": {"neck.downsample_convs.2.conv.weight": (256, 256, 3, 3),
              "neck.pafpn_convs.0.conv.bias": (256,),
              "neck.pafpn_convs.2.conv.weight": (256, 256, 3, 3)}}


@pytest.mark.parametrize("family", sorted(TRUNK_CONFIGS))
def test_full_width_keys_are_mmdet_keys(family):
    """The shipped config's ``state_dict`` (built on the meta device)
    carries mmdet's keys and shapes for its new modules, and no key of
    the modules it does not have."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(TRUNK_CONFIGS[family])
    with torch.device("meta"):
        sd = build_detector(cfg.model, cfg.train_cfg,
                            cfg.test_cfg).state_dict()
    for key, shape in FULL_WIDTH_KEYS[family].items():
        assert tuple(sd[key].shape) == shape, key
    keys = " ".join(sd)
    assert ("conv_offset" in keys) == (family == "dcn")
    assert ("context_block" in keys) == (family == "gcnet")
    assert ("gen_attention_block" in keys) == (family == "attention")
    assert ("backbone.stem." in keys) == (family == "res2net")
    assert ("pafpn_convs" in keys) == (family == "pafpn")
    if family == "attention":       # c4 and c5 only, after conv2
        assert not re.search(r"layer[12]\.\d+\.gen_attention", keys)
    if family == "dcn":             # no deformable conv in c2
        assert "layer1.0.conv2.conv_offset" not in keys


_JAX = {}


def _jax_variables(family, heads=None):
    """The tiny config of ``family`` (its heads' input channels set to
    ``heads``), its JAX model's variables of seed 0 and a second draw of
    them, built once."""
    if (family, heads) not in _JAX:
        cfg = trunk_cfg(family)
        if heads:
            m = cfg.model
            m.neck.out_channels = m.rpn_head.in_channels = heads
            for k in ("bbox_roi_extractor", "mask_roi_extractor"):
                if m.roi_head.get(k) is not None:
                    m.roi_head[k].out_channels = heads
            for k in ("bbox_head", "mask_head"):
                if m.roi_head.get(k) is not None:
                    m.roi_head[k].in_channels = heads
        _, variables = jax_model(cfg)
        r = np.random.RandomState(2)
        _JAX[family, heads] = (cfg, variables, {
            k: _random_tree(v, r) for k, v in variables.items()})
    return _JAX[family, heads]


@pytest.mark.parametrize("family", sorted(TRUNK_CONFIGS))
def test_weight_round_trip(family, tmp_path):
    """JAX variables -> ``state_dict_from_jax`` -> an mmdet ``.pth`` ->
    ``load_mmdet_checkpoint`` -> ``mmdet_state_dict`` -> the port's model,
    exactly, every key used."""
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import (load_mmdet_checkpoint,
                                               mmdet_state_dict,
                                               state_dict_from_jax)
    cfg, variables, _ = _jax_variables(family)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    torch.save({"state_dict": sd}, tmp_path / "m.pth")
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    loaded = mmdet_state_dict(model, load_mmdet_checkpoint(
        str(tmp_path / "m.pth")))
    assert set(loaded) == set(model.state_dict())
    model.load_state_dict(loaded)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_mmcv_attention_checkpoint_folds_gamma():
    """An mmcv ``GeneralizedAttention``'s ``gamma`` folds into
    ``proj_conv`` and its one ``query_conv`` fills ``geom_query_conv``;
    its per-head position projections raise."""
    from bonai_tpu_torch.ops.layers import GeneralizedAttention
    from bonai_tpu_torch.utils.weights import mmdet_state_dict
    m = GeneralizedAttention(16, num_heads=4)
    m.init_weights(torch.Generator().manual_seed(0))
    torch.nn.init.normal_(m.proj_conv.weight)
    torch.nn.init.normal_(m.proj_conv.bias)
    x = torch.randn(1, 16, 5, 6)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    want = (m(x) - x) * 0.25 + x
    mmcv = {k: v for k, v in sd.items() if "geom_query" not in k}
    mmcv["gamma"] = torch.tensor([0.25])
    folded = mmdet_state_dict(m, mmcv)
    assert set(folded) == set(sd)
    assert torch.equal(folded["geom_query_conv.weight"],
                       sd["query_conv.weight"])
    m.load_state_dict(folded)
    m.geom_query_conv.weight.data.copy_(sd["geom_query_conv.weight"])
    with torch.no_grad():
        torch.testing.assert_close(m(x), want, rtol=0, atol=1e-6)
    mmcv["appr_geom_fc_x.weight"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="per-head"):
        mmdet_state_dict(m, mmcv)


def test_jax_importer_on_the_trunk_checkpoints():
    """``bonai_tpu.utils.torch_import.mmdet_checkpoint_to_params`` reads a
    plain ResNet's keys only (ROADMAP.md queue C): a Res2Net ``.pth``
    raises ``KeyError`` (no ``backbone.conv1``); a RegNet ``.pth`` loads
    whole (its stem, blocks and grouped convs are ResNet-shaped); DCN's
    ``conv_offset``, the plugins and PAFPN's bottom-up convs stay at their
    initial values, which the port writes and reads."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    for family, left in (("res2net", None), ("regnet", ()),
                         ("dcn", ("conv_offset",)),
                         ("gcnet", ("context_block",)),
                         ("attention", ("gen_attention_block",)),
                         ("pafpn", ("downsample_convs", "pafpn_convs"))):
        # the importer reads the box head's first FC over 256 channels
        _, variables, start = _jax_variables(family, heads=256)
        sd = {k: v.numpy() for k, v in state_dict_from_jax(
            variables["params"], variables["batch_stats"]).items()}
        if left is None:
            with pytest.raises(KeyError, match="backbone.conv1.weight"):
                mmdet_checkpoint_to_params(sd, start["params"],
                                           start["batch_stats"])
            continue
        params, stats = mmdet_checkpoint_to_params(
            sd, start["params"], start["batch_stats"])
        got = state_dict_from_jax(params, stats)
        init = state_dict_from_jax(start["params"], start["batch_stats"])
        for k, v in got.items():
            read = torch.equal(v, torch.from_numpy(sd[k]))
            kept = torch.equal(v, init[k])
            if any(part in k for part in left):
                assert kept and not read, k
            else:
                assert read, k


def test_bonai_configs_build_39_of_39():
    """Every detector config of BONAI builds (on the meta device); none
    raises ``NotImplementedError`` naming a ROADMAP.md item."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    built, raised = [], {}
    for path in sorted(glob.glob(osp.join(ROOT, "configs", "**",
                                          "*bonai*.py"), recursive=True)):
        name = osp.relpath(path, osp.join(ROOT, "configs"))
        if name.startswith("_base_"):
            continue
        cfg = Config.fromfile(path)
        try:
            with meta_device():
                build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
            built.append(name)
        except NotImplementedError as e:
            raised[name.split("/")[0]] = re.search(
                r"ROADMAP.md item (A\d)", str(e))[1]
    assert len(built) == 39
    assert {osp.relpath(p, osp.join(ROOT, "configs"))
            for p in TRUNK_CONFIGS.values()} | {
        "htc/htc_r50_fpn_1x_bonai.py",
        "detectors/detectors_cascade_rcnn_r50_1x_bonai.py",
        "reppoints/reppoints_moment_r50_fpn_1x_bonai.py",
        "guided_anchoring/ga_faster_r50_fpn_1x_bonai.py",
        "fsaf/fsaf_r50_fpn_1x_bonai.py",
        "foveabox/fovea_r50_fpn_4x4_1x_bonai.py",
        "nas_fpn/retinanet_r50_nasfpn_bonai.py",
        "nas_fcos/nas_fcos_r50_fpn_bonai.py", "ssd/ssd300_bonai.py",
        "cornernet/cornernet_hourglass104_bonai.py"} <= set(built)
    assert raised == {}


@pytest.mark.parametrize("change", [
    dict(sac=dict(type="SAC", use_deform=True),
         stage_with_sac=(False, True, True, True)),
    dict(base="res2net", sac=dict(type="SAC"),
         stage_with_sac=(False, True, True, True)),
    dict(neck=dict(type="RFP", rfp_backbone=dict(depth=18))),
    dict(dcn=dict(type="DCNv3"), stage_with_dcn=(True,) * 4),
    dict(plugins=[dict(cfg=dict(type="GeneralizedAttention"),
                       position="after_conv4")]),
    dict(base="regnet", norm_cfg=dict(type="GN")),
    dict(base="res2net", dcn=dict(type="DCNv2"),
         stage_with_dcn=(True,) * 4),
    dict(neck=dict(type="RFP")), dict(neck=dict(type="FPN_CARAFE")),
    dict(neck=dict(type="PAFPN", add_extra_convs="on_output"))],
    ids=lambda c: "-".join(
        f"{k}={v.get('type', v) if isinstance(v, dict) else v}"
        for k, v in c.items())[:40])
def test_unported_trunk_options_name_a6(change):
    from bonai_tpu_torch.models import build_detector
    change = dict(change)
    cfg = trunk_cfg(change.pop("base", "dcn"))
    if "neck" in change:
        cfg.model.neck.update(change.pop("neck"))
    cfg.model.backbone.update(change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)


@pytest.mark.parametrize("change", [
    dict(type="ResNeXt"), dict(groups=32), dict(style="caffe"),
    dict(norm_cfg=dict(type="GN", num_groups=32)),
    dict(conv_cfg=dict(type="ConvWS"))],
    ids=lambda c: "-".join(
        f"{k}={v.get('type', v) if isinstance(v, dict) else v}"
        for k, v in c.items()))
def test_coco_trunk_options_build(change):
    """The trunk options of the COCO recipes, which raised A6 before
    their port (``test_torch_port_coco_trunks.py`` holds them to JAX):
    the DCN trunk's config at full width with each, on the meta device,
    has the JAX detector's parameter count; ResNeXt's ``conv2`` is
    grouped, caffe style strides ``conv1``, GN takes mmcv's ``gn<i>``
    names, ConvWS standardises every trunk conv but the deformable
    ones."""
    from bonai_tpu import models as jax_models
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.ops.layers import ConvWS2d
    cfg = Config.fromfile(TRUNK_CONFIGS["dcn"])
    cfg.model.backbone.update(change)
    with torch.device("meta"):
        bk = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg).backbone
    jm = jax_models.build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                                   compute_dtype="float32")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes["params"]["backbone"])) == sum(p.numel()
                                               for p in bk.parameters())
    first, down = bk.layer1[0], bk.layer2[0]
    assert first.conv2.groups == change.get("groups", 1)
    assert down.conv1.stride == ((2, 2) if "style" in change else (1, 1))
    assert hasattr(first, "gn1") == ("norm_cfg" in change)
    assert isinstance(first.conv2, ConvWS2d) == ("conv_cfg" in change)
    assert type(down.conv2).__name__ == "ModulatedDeformConv2dPack"


@pytest.mark.parametrize("change", [
    dict(type="HourglassNet"), dict(neck=dict(type="NASFPN")),
    dict(type="SSDVGG"), dict(neck=dict(type="NASFCOS_FPN"))],
    ids=["HourglassNet", "NASFPN", "SSDVGG", "NASFCOS_FPN"])
def test_generic_builders_take_the_hourglass_and_nas_fpn(change):
    """The generic backbone and neck builders take ``HourglassNet`` (the
    ResNet keys of the trunk's config read and ignored) and ``NASFPN`` on
    an R-CNN trunk, as the JAX builders do; ``SSDVGG`` and
    ``NASFCOS_FPN``, which the SSD and NAS-FCOS detectors build
    themselves, get the JAX builders' unsupported-type refusal."""
    from bonai_tpu.models import build_detector as jax_build
    from bonai_tpu_torch.models import build_detector
    change = dict(change)
    cfg = trunk_cfg("dcn")
    if "neck" in change:
        cfg.model.neck.update(change.pop("neck"))
    cfg.model.backbone.update(change)
    kind = cfg.model.neck.type if "NAS" in cfg.model.neck.type \
        else cfg.model.backbone.type
    if kind in ("SSDVGG", "NASFCOS_FPN"):
        what = "backbone" if kind == "SSDVGG" else "neck"
        with pytest.raises(ValueError, match=f"unsupported {what} {kind}"):
            build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
        jm = jax_build(cfg.model, cfg.train_cfg, cfg.test_cfg)
        with pytest.raises(AssertionError, match=f"unsupported {what} {kind}"):
            jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 256, 256, 3)))
        return
    with torch.device("meta"):
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    built = model.neck if kind == "NASFPN" else model.backbone
    assert type(built).__name__ == kind


@pytest.mark.parametrize("change", [
    dict(sac=dict(type="SAC"), stage_with_sac=(False, True, True, True)),
    dict(output_img=True), dict(type="DetectoRS_ResNet")],
    ids=["sac", "output_img", "DetectoRS_ResNet"])
def test_detectors_trunk_options_build(change):
    """DetectoRS's backbone options, which raised A6 before its port:
    SAC's ``conv2`` in the stages listed, the image ahead of the stages'
    outputs, the ``DetectoRS_ResNet`` type (a ResNet)."""
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.ops.saconv import SAConv2d
    cfg = trunk_cfg("gcnet")
    cfg.model.backbone.update(change)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    bk = model.backbone
    sac = [n for n, m in bk.named_modules() if isinstance(m, SAConv2d)]
    assert len(sac) == (13 if "sac" in change else 0)
    assert all(not n.startswith("layer1.") for n in sac)
    with torch.no_grad():
        outs = bk(torch.zeros(1, 3, 64, 64))
    assert len(outs) == 4 + change.get("output_img", False)
