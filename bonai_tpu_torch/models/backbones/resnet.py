"""ResNet backbones (counterpart of ``bonai_tpu/models/backbones/resnet.py``:
``style='pytorch'`` or ``'caffe'``, any ``frozen_stages``; BatchNorm and
SyncBN stay frozen over their stored statistics whatever ``norm_eval``
says, as in the JAX package).

- ``ResNet``, with the options of the COCO recipes: ResNeXt's grouped
  ``conv2`` (``groups``, ``base_width``), the caffe style (the stride on
  ``conv1``), ``norm_cfg`` (``build_norm``: BN or SyncBN, its affine
  behind a gradient stop with ``requires_grad=False``; GN) and
  ``conv_cfg`` (``build_conv``: ``ConvWS``) on every conv and norm of the
  stem, the blocks and the shortcuts; and of the BONAI trunk variants: a
  deformable ``conv2`` (``dcn``, ``stage_with_dcn``: DCNv2 or, with
  ``type='DCN'``, v1), the ``plugins`` of GCNet and empirical attention (a
  ``ContextBlock``, ``GeneralizedAttention`` or ``NonLocal2d`` after
  ``conv1``, ``conv2`` or ``conv3`` of the stages listed), and the deep
  stem of three 3x3 convs (``deep_stem``).
- ``Res2Net`` (``Bottle2neck``: the 3x3 conv split into ``scales - 1``
  convs over channel groups with cumulative mixing; the deep stem and the
  average-pool shortcut by default).
- ``RegNet``: RegNetX's grouped bottlenecks, widths from the quantised
  linear rule (``stage_plan``), a 32-channel 3x3/2 stem and no max-pool.
- DetectoRS's ResNet (``DetectoRS_ResNet``): ``conv2`` a switchable atrous
  conv (``sac``, ``stage_with_sac``; ``ops/saconv.py``), the input image
  returned ahead of the stages' outputs (``output_img``, for the RFP), and
  with ``rfp_inplanes`` (the RFP's backbone copy) a zero-initialised 1x1
  ``rfp_conv`` in the first block of every stage past the first, adding
  the RFP feature after the residual sum.  ``conv_cfg=dict(type=
  'ConvAWS')`` leaves the other convs plain, as in the JAX package
  (ROADMAP.md queue C).

Module and parameter names follow mmdet v2.3 / mmcv / torchvision
(``backbone.layer1.0.conv1.weight``, ``backbone.layer1.0.downsample.1
.running_var``, a GN trunk's ``backbone.gn1.weight`` and
``layer1.0.gn3.bias``, ``layer2.0.conv2.conv_offset.weight``,
``layer2.0.context_block.conv_mask.weight``, ``stem.3.weight``,
``layer1.0.convs.2.weight``), so their checkpoints load as they are.

Frozen stages are the JAX package's: the stem (``conv1``/``bn1``) when
``frozen_stages >= 0`` and ``layer1..frozen_stages`` are not trained; the
JAX gradient stops after the stem's max-pool and after each frozen stage.
The deep stem is named ``stem`` (JAX ``stem_conv<i>``/``stem_bn<i>``),
which the JAX frozen mask does not match: it stays trained behind the
gradient stop, moved by weight decay and momentum alone
(``behind_stop``; ROADMAP.md queue C), as HRNet's ``conv2``/``bn2``.
The RFP's backbone copy, outside ``backbone``, is not frozen either: its
stem and frozen stages stay trained behind the gradient stops
(``train_behind_stops``).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import layers
from ...ops.deform_conv import DeformConv2dPack, ModulatedDeformConv2dPack
from ...ops.saconv import SAConv2d
from ..init import kaiming_fan_out_, zeros_

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

logger = logging.getLogger("bonai_tpu_torch")


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over stored running statistics (whatever ``norm_eval``
    says): one per-channel multiply-add.  The affine parameters are parameters, the
    statistics buffers, with ``nn.BatchNorm2d``'s names.

    With ``freeze_affine`` (mmdet's ``requires_grad=False``) the affine is
    read behind a gradient stop: it stays trained, moved by weight decay
    and momentum alone, as the JAX package's ``FrozenBatchNorm``
    (``behind_stop``; mmdetection keeps it fixed, ROADMAP.md queue C)."""

    def __init__(self, channels, eps=1e-5, freeze_affine=False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.stops_gradient = freeze_affine
        self.behind_stop = ("weight", "bias") if freeze_affine else ()

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.stops_gradient:
            weight, bias = weight.detach(), bias.detach()
        scale = weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        shift = bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] \
            + shift.to(x.dtype)[:, None, None]


def _norm_type(norm_cfg):
    """``(type, num_groups, requires_grad)`` of an mmdet ``norm_cfg`` the
    JAX ``make_norm`` computes: BN or SyncBN (both frozen over stored
    statistics, also under DDP) or GN, at epsilon 1e-5.  The JAX builder
    reads no ``eps`` and no other key: an ``eps`` other than 1e-5, another
    key or type, or a GN without gradient raises."""
    cfg = dict(norm_cfg or {})
    ntype = cfg.pop("type", "BN")
    groups = cfg.pop("num_groups", 32) if ntype == "GN" else None
    requires_grad = cfg.pop("requires_grad", True)
    eps = cfg.pop("eps", 1e-5)
    if ntype not in ("BN", "SyncBN", "GN") or cfg or eps != 1e-5 or (
            ntype == "GN" and not requires_grad):
        raise NotImplementedError(
            f"norm_cfg {norm_cfg} is not ported to bonai_tpu_torch (the JAX "
            f"package reads BN, SyncBN and GN at epsilon 1e-5; ROADMAP.md "
            f"item A6)")
    return ntype, groups, requires_grad


def plain_norm(norm_cfg):
    """Whether ``norm_cfg`` is the frozen BatchNorm with a trained affine
    that a trunk without norm options computes (``None``, or BN/SyncBN
    with ``requires_grad=True``)."""
    ntype, _, requires_grad = _norm_type(norm_cfg)
    return ntype != "GN" and requires_grad


def build_norm(norm_cfg, channels, postfix=""):
    """The norm of ``norm_cfg`` (JAX ``make_norm``) under mmcv's
    ``build_norm_layer`` name: ``('bn<postfix>', FrozenBatchNorm2d)`` for
    BN and SyncBN (the affine behind a gradient stop with
    ``requires_grad=False``), ``('gn<postfix>', nn.GroupNorm)`` for GN.
    The GroupNorm is torch's two-pass one, where flax takes the variance
    as E[x^2] - E[x]^2."""
    ntype, groups, requires_grad = _norm_type(norm_cfg)
    if ntype == "GN":
        return f"gn{postfix}", nn.GroupNorm(groups, channels, eps=1e-5)
    return f"bn{postfix}", FrozenBatchNorm2d(
        channels, freeze_affine=not requires_grad)


def _conv_type(conv_cfg):
    """The type of a ``conv_cfg``: ``Conv``, ``ConvWS`` or ``ConvAWS``;
    another raises."""
    ctype = dict(conv_cfg or {}).get("type", "Conv")
    if ctype not in ("Conv", "ConvWS", "ConvAWS"):
        raise NotImplementedError(
            f"conv_cfg {conv_cfg} is not ported to bonai_tpu_torch yet "
            f"(ROADMAP.md item A6)")
    return ctype


def build_conv(conv_cfg, cin, cout, k, stride=1, padding=None, bias=False,
               groups=1):
    """A conv of ``conv_cfg`` (JAX ``conv``): plain, ``ConvWS``
    (``ops/layers.py::ConvWS2d``), or ``ConvAWS``, a plain conv outside
    DetectoRS's SAC as in the JAX package (ROADMAP.md queue C)."""
    cls = layers.ConvWS2d if _conv_type(conv_cfg) == "ConvWS" \
        else nn.Conv2d
    return cls(cin, cout, k, stride, k // 2 if padding is None else padding,
               bias=bias, groups=groups)


def _add_norm(module, norm_cfg, channels, postfix):
    """Add the norm of ``norm_cfg`` to ``module`` under its mmcv name;
    returns the name."""
    name, norm = build_norm(norm_cfg, channels, postfix)
    module.add_module(name, norm)
    return name


def _conv(cin, cout, k, stride=1, conv_cfg=None, groups=1):
    return build_conv(conv_cfg, cin, cout, k, stride, groups=groups)


def _downsample(cin, cout, stride, norm_cfg=None, conv_cfg=None):
    return nn.Sequential(_conv(cin, cout, 1, stride, conv_cfg),
                         build_norm(norm_cfg, cout)[1])


class _Norms:
    """``norm1``..``norm3``: a block's norms by their mmcv names
    (``bn<i>`` or ``gn<i>``)."""

    @property
    def norm1(self):
        return getattr(self, self.norm1_name)

    @property
    def norm2(self):
        return getattr(self, self.norm2_name)

    @property
    def norm3(self):
        return getattr(self, self.norm3_name)


class BasicBlock(_Norms, nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_cfg=None, conv_cfg=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, conv_cfg)
        self.norm1_name = _add_norm(self, norm_cfg, planes, 1)
        self.conv2 = _conv(planes, planes, 3, 1, conv_cfg)
        self.norm2_name = _add_norm(self, norm_cfg, planes, 2)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(out)) + identity)


# a plugin type (a class of ops/layers.py) -> mmcv's name for it
# (``_abbr_``)
PLUGINS = {"ContextBlock": "context_block",
           "GeneralizedAttention": "gen_attention_block",
           "NonLocal2d": "nonlocal_block"}
POSITIONS = ("after_conv1", "after_conv2", "after_conv3")


def stage_plugins(plugins, stage):
    """mmdet's plugin specs (``dict(cfg=dict(type=...), stages=...,
    position=...)``) that apply to ``stage``, as ``(type, kwargs,
    position, postfix)``."""
    out = []
    for spec in plugins or ():
        spec = dict(spec)
        stages = spec.get("stages")
        if stages is not None and not stages[stage]:
            continue
        cfg = dict(spec["cfg"])
        ptype = cfg.pop("type")
        position = spec.get("position", "after_conv3")
        if ptype not in PLUGINS or position not in POSITIONS:
            raise NotImplementedError(
                f"plugin {ptype} at {position} is not ported to "
                f"bonai_tpu_torch yet (ROADMAP.md item A6)")
        out.append((ptype, cfg, position, cfg.pop("postfix", "")))
    return out


def _dcn_conv(dcn, width, stride):
    """The deformable ``conv2`` of a ``dcn`` config: ``'DCNv2'`` (the
    default) or ``'DCN'``, with its ``deform_groups``; mmdet's
    ``fallback_on_stride`` is read and ignored, as the JAX package does."""
    dcn = dict(dcn)
    extra = sorted(set(dcn) - {"type", "deform_groups",
                               "fallback_on_stride"})
    dtype = dcn.get("type", "DCNv2")
    if extra or dtype not in ("DCN", "DCNv2"):
        raise NotImplementedError(
            f"dcn {dtype} with {extra} is not ported to bonai_tpu_torch yet "
            f"(ROADMAP.md item A6)")
    cls = DeformConv2dPack if dtype == "DCN" else ModulatedDeformConv2dPack
    return cls(width, width, 3, stride, 1,
               deform_groups=int(dcn.get("deform_groups", 1)))


def _check_sac(sac):
    """A ``sac`` config: ``SAC`` without ``use_deform`` (the JAX package
    ignores it; ROADMAP.md item A6)."""
    sac = dict(sac)
    if sac.get("type", "SAC") != "SAC" or sac.get("use_deform", False) \
            or set(sac) - {"type", "use_deform"}:
        raise NotImplementedError(
            f"sac {sac} is not ported to bonai_tpu_torch yet (the deformable "
            f"SAC; ROADMAP.md item A6)")


class Bottleneck(_Norms, nn.Module):
    """The stride sits on the 3x3 conv2 (``style='pytorch'``) or on the
    1x1 conv1 (``'caffe'``); ``groups`` > 1 makes ``conv2`` ResNeXt's
    grouped conv over ``int(planes * base_width / 64) * groups`` channels
    (the JAX package's denominator: 64, where mmdet's ResNeXt divides by
    ``base_channels``; ROADMAP.md queue C).  ``dcn`` makes ``conv2``
    deformable (ungrouped, as in the JAX package) and ``sac``
    switchable-atrous; ``norm_cfg``/``conv_cfg`` (``build_norm``,
    ``build_conv``) apply to every conv and norm but the deformable and
    SAC ``conv2``; ``plugins`` (``stage_plugins``' tuples) run after
    their conv's norm (and ReLU); with ``rfp_inplanes`` an ``rfp_conv``
    adds the RFP feature after the residual sum."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dcn=None, plugins=(), sac=False, rfp_inplanes=None,
                 groups=1, base_width=4, style="pytorch", norm_cfg=None,
                 conv_cfg=None):
        super().__init__()
        if dcn is not None and sac:
            raise NotImplementedError(
                "dcn and sac in one stage are not ported to bonai_tpu_torch "
                "(the JAX package ignores sac there; ROADMAP.md item A6)")
        width = planes if groups == 1 \
            else int(planes * (base_width / 64)) * groups
        c1_stride, c2_stride = (stride, 1) if style == "caffe" \
            else (1, stride)
        self.conv1 = _conv(inplanes, width, 1, c1_stride, conv_cfg)
        self.norm1_name = _add_norm(self, norm_cfg, width, 1)
        if sac:
            self.conv2 = SAConv2d(width, width, 3, c2_stride)
        else:
            self.conv2 = _conv(width, width, 3, c2_stride, conv_cfg,
                               groups) if dcn is None \
                else _dcn_conv(dcn, width, c2_stride)
        self.norm2_name = _add_norm(self, norm_cfg, width, 2)
        self.conv3 = _conv(width, planes * 4, 1, 1, conv_cfg)
        self.norm3_name = _add_norm(self, norm_cfg, planes * 4, 3)
        self.downsample = downsample
        self.plugin_names = {p: [] for p in POSITIONS}
        for ptype, kwargs, position, postfix in plugins:
            name = PLUGINS[ptype] + postfix
            if hasattr(self, name):
                raise ValueError(f"two plugins named {name} in one block")
            channels = planes * 4 if position == "after_conv3" else width
            self.add_module(name, getattr(layers, ptype)(channels,
                                                         **kwargs))
            self.plugin_names[position].append(name)
        if rfp_inplanes:
            self.rfp_conv = nn.Conv2d(rfp_inplanes, planes * 4, 1)

    def _plugins(self, x, position):
        for name in self.plugin_names[position]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x, rfp_feat=None):
        identity = x if self.downsample is None else self.downsample(x)
        out = self._plugins(F.relu(self.norm1(self.conv1(x))),
                            "after_conv1")
        out = self._plugins(F.relu(self.norm2(self.conv2(out))),
                            "after_conv2")
        out = self._plugins(self.norm3(self.conv3(out)), "after_conv3")
        out = out + identity
        if rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


class Bottle2neck(nn.Module):
    """Res2Net's block (JAX ``Bottle2neck``): ``conv1`` to ``scales``
    groups of ``width`` channels; ``convs.<i>``/``bns.<i>`` over group
    ``i`` plus the previous one's output (each group alone on a stage's
    first block, ``stage_type='stage'``); the last group passes as it is,
    or through a 3x3 average pool (zeros counted) on a strided first
    block; ``conv3`` back to ``planes * 4``."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 scales=4, base_width=26, base_channels=64,
                 stage_type="normal"):
        super().__init__()
        self.width = width = int(math.floor(planes * (base_width
                                                      / base_channels)))
        self.stage = stage_type == "stage"
        self.pool = self.stage and stride != 1
        self.stride = stride
        self.conv1 = _conv(inplanes, width * scales, 1)
        self.bn1 = FrozenBatchNorm2d(width * scales)
        self.convs = nn.ModuleList([_conv(width, width, 3, stride)
                                    for _ in range(scales - 1)])
        self.bns = nn.ModuleList([FrozenBatchNorm2d(width)
                                  for _ in range(scales - 1)])
        self.conv3 = _conv(width * scales, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        spx = torch.split(F.relu(self.bn1(self.conv1(x))), self.width, 1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = F.relu(bn(conv(spx[i] if i == 0 or self.stage
                                else sp + spx[i])))
            outs.append(sp)
        outs.append(F.avg_pool2d(spx[-1], 3, self.stride, 1) if self.pool
                    else spx[-1])
        out = self.bn3(self.conv3(torch.cat(outs, 1)))
        return F.relu(out + identity)


def _fixed_strides(num_stages, strides, dilations):
    """The JAX ``ResNet`` reads no ``strides`` or ``dilations``: stage 0
    has stride 1, every later stage 2, and none is dilated (mmdet's
    defaults, and the C4 configs' values).  Other values raise A7."""
    want = (1, 2, 2, 2, 2)[:num_stages], (1,) * num_stages
    for name, got, value in (("strides", strides, want[0]),
                             ("dilations", dilations, want[1])):
        if got is not None and tuple(got) != value:
            raise NotImplementedError(
                f"ResNet {name}={tuple(got)} is not ported to bonai_tpu_torch "
                f"(the JAX ResNet reads none and computes {value}; "
                f"ROADMAP.md item A7)")


class ResNet(nn.Module):
    """Returns the outputs of the stages in ``out_indices`` (NCHW), after
    the input with ``output_img``.  ``groups``/``base_width`` make it
    ResNeXt (mmdet's ``ResNeXt`` is this class); ``norm_cfg`` and
    ``conv_cfg`` apply to the stem, every block and every shortcut;
    ``zero_init_residual`` is read and ignored, as the JAX builder does
    not read it (the port's init is the JAX package's).  The first stage
    has stride 1, every later one 2, and none is dilated, whatever the
    number of stages (the C4 trunk's three): ``strides``/``dilations``
    may only say so (:func:`_fixed_strides`)."""

    def __init__(self, depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
                 frozen_stages=1, norm_eval=True, style="pytorch",
                 base_channels=64, dcn=None,
                 stage_with_dcn=(False, False, False, False), plugins=None,
                 deep_stem=False, sac=None,
                 stage_with_sac=(False, False, False, False),
                 output_img=False, rfp_inplanes=None, conv_cfg=None,
                 norm_cfg=None, groups=1, base_width=4,
                 zero_init_residual=None, strides=None, dilations=None):
        super().__init__()
        _fixed_strides(num_stages, strides, dilations)
        _conv_type(conv_cfg)
        _norm_type(norm_cfg)
        if sac is not None:
            _check_sac(sac)
        if style not in ("pytorch", "caffe"):
            raise NotImplementedError(
                f"style={style!r} is not a ResNet style (mmdet's are "
                f"'pytorch' and 'caffe')")
        self.norm_cfg, self.conv_cfg = norm_cfg, conv_cfg
        self.bottleneck_kw = dict(groups=groups, base_width=base_width,
                                  style=style, norm_cfg=norm_cfg,
                                  conv_cfg=conv_cfg)
        if not norm_eval:
            logger.info("ResNet(norm_eval=False): BatchNorm stays frozen over "
                        "its stored statistics, as in the JAX package")
        block_name, stage_blocks = ARCH_SETTINGS[depth]
        block = self.block_type(block_name)
        sac_stages = [bool(sac) and bool(w) for w in stage_with_sac]
        if block is not Bottleneck and (any(sac_stages) or rfp_inplanes):
            raise NotImplementedError(
                f"sac and the RFP on {type(self).__name__} depth {depth} are "
                f"not ported to bonai_tpu_torch (the JAX package ignores "
                f"them; ROADMAP.md item A6)")
        if block is BasicBlock and (dcn is not None or plugins
                                    or groups != 1):
            raise NotImplementedError(
                "dcn, plugins and groups on a BasicBlock ResNet are not "
                "ported to bonai_tpu_torch (mmdet has none; ROADMAP.md item "
                "A6)")
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.output_img = output_img
        if deep_stem:
            half = base_channels // 2
            self.stem = nn.Sequential(*[
                m for cin, cout, st in ((3, half, 2), (half, half, 1),
                                        (half, base_channels, 1))
                for m in (_conv(cin, cout, 3, st, conv_cfg),
                          build_norm(norm_cfg, cout)[1], nn.ReLU())])
        else:
            self.conv1 = _conv(3, base_channels, 7, 2, conv_cfg)
            self.norm1_name = _add_norm(self, norm_cfg, base_channels, 1)
        inplanes, planes = base_channels, base_channels
        self.stages = []
        for i in range(num_stages):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(stage_blocks[i]):
                ds = None
                if b == 0 and (stride != 1
                               or inplanes != planes * block.expansion):
                    ds = self.shortcut(inplanes, planes * block.expansion,
                                       stride)
                blocks.append(self.make_block(
                    block, inplanes, planes, stride if b == 0 else 1, ds,
                    dcn=dcn if dcn is not None and stage_with_dcn[i]
                    else None, plugins=stage_plugins(plugins, i),
                    sac=sac_stages[i],
                    rfp_inplanes=rfp_inplanes if b == 0 and i > 0
                    else None))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{i + 1}")
            planes *= 2
        # the stem (for frozen_stages >= 0) and the first frozen_stages
        # stages get no gradient, as mmdet's _freeze_stages; BN statistics
        # are buffers and never move.  A deep stem stays trained behind
        # the gradient stop after the max-pool, as in the JAX package
        frozen = [self.conv1, self.norm1] if frozen_stages >= 0 \
            and not deep_stem else []
        frozen += [getattr(self, f"layer{i}")
                   for i in range(1, frozen_stages + 1)]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)
        self.behind_stop = ("stem",) if deep_stem and frozen_stages >= 0 \
            else ()
        self.stops_gradient = bool(self.behind_stop)

    @property
    def norm1(self):
        return getattr(self, self.norm1_name)

    def train_behind_stops(self):
        """Train the stem and the frozen stages behind the gradient stops
        (the JAX frozen mask matches ``backbone`` alone: the RFP's copy
        keeps them trained, moved by weight decay and momentum only)."""
        names = ["conv1", self.norm1_name] if self.frozen_stages >= 0 \
            and not hasattr(self, "stem") else []
        names += [f"layer{i}" for i in range(1, self.frozen_stages + 1)]
        for n in names:
            for p in getattr(self, n).parameters():
                p.requires_grad_(True)
        self.behind_stop += tuple(names)
        self.stops_gradient = bool(self.behind_stop)

    @staticmethod
    def block_type(block_name):
        return Bottleneck if block_name == "bottleneck" else BasicBlock

    def shortcut(self, cin, cout, stride):
        return _downsample(cin, cout, stride, self.norm_cfg, self.conv_cfg)

    def make_block(self, block, inplanes, planes, stride, ds, dcn, plugins,
                   sac, rfp_inplanes):
        if block is BasicBlock:
            return block(inplanes, planes, stride, ds, self.norm_cfg,
                         self.conv_cfg)
        return block(inplanes, planes, stride, ds, dcn=dcn, plugins=plugins,
                     sac=sac, rfp_inplanes=rfp_inplanes, **self.bottleneck_kw)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
        for m in self.modules():        # their own init over the above
            if isinstance(m, SAConv2d):
                m.init_weights(gen)
            if hasattr(m, "rfp_conv"):
                zeros_(m.rfp_conv.weight)
                zeros_(m.rfp_conv.bias)

    def forward(self, x, rfp_feats=None):
        """``rfp_feats``: the RFP's features, the one of stage ``i`` into
        its first block for every stage past the first."""
        img = x
        if hasattr(self, "stem"):
            x = self.stem(x)
        else:
            x = F.relu(self.norm1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.stops_gradient:
            x = x.detach()
        outs = []
        for i, name in enumerate(self.stages):
            layer = getattr(self, name)
            if rfp_feats is not None and i > 0:
                x = layer[0](x, rfp_feats[i])
                for block in layer[1:]:
                    x = block(x)
            else:
                x = layer(x)
            if self.stops_gradient and i < self.frozen_stages:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x)
        return (img, *outs) if self.output_img else tuple(outs)


class Res2Net(ResNet):
    """ResNet of ``Bottle2neck`` blocks (mmdet's ``Res2Net``): ``scales``
    groups of ``planes * base_width / 64`` channels, the deep stem and,
    with ``avg_down``, the strided shortcut as a ``stride`` x ``stride``
    average pool (floor mode, as the JAX package) before its 1x1 conv.
    The shortcut is mmdet's ``Sequential(pool, conv, BN)`` whatever the
    stride (keys ``downsample.1``/``.2``; an identity in the pool's place
    at stride 1 or without ``avg_down``).  The JAX ``Bottle2neck`` reads
    no norm, conv, ``groups`` or style option: those raise."""

    def __init__(self, depth=50, scales=4, base_width=26, deep_stem=True,
                 avg_down=True, **kwargs):
        if not plain_norm(kwargs.get("norm_cfg")) or kwargs.get(
                "conv_cfg") or kwargs.get("groups", 1) != 1 \
                or kwargs.get("style", "pytorch") != "pytorch":
            raise NotImplementedError(
                "norm_cfg, conv_cfg, groups and style on Res2Net are not "
                "ported to bonai_tpu_torch (the JAX Bottle2neck ignores "
                "them; ROADMAP.md item A6)")
        self.scales, self.base_width, self.avg_down = scales, base_width, \
            avg_down
        if ARCH_SETTINGS[depth][0] != "bottleneck":
            raise NotImplementedError(
                f"Res2Net depth {depth}: Res2Net has bottlenecks only")
        self.base_channels = kwargs.get("base_channels", 64)
        super().__init__(depth=depth, deep_stem=deep_stem, **kwargs)

    @staticmethod
    def block_type(block_name):
        return Bottle2neck

    def shortcut(self, cin, cout, stride):
        pool = self.avg_down and stride != 1
        return nn.Sequential(
            nn.AvgPool2d(stride, stride) if pool else nn.Identity(),
            _conv(cin, cout, 1, 1 if pool else stride),
            FrozenBatchNorm2d(cout))

    def make_block(self, block, inplanes, planes, stride, ds, dcn, plugins,
                   sac, rfp_inplanes):
        if dcn is not None or plugins:
            raise NotImplementedError(
                "dcn and plugins on Res2Net are not ported to "
                "bonai_tpu_torch (the JAX package ignores them; ROADMAP.md "
                "item A6)")
        return Bottle2neck(inplanes, planes, stride, ds, self.scales,
                           self.base_width, self.base_channels,
                           "stage" if ds is not None else "normal")


class RegNetBlock(nn.Module):
    """RegNetX's bottleneck (expansion 1): 1x1 to the bottleneck width, a
    grouped 3x3 (stride here), 1x1 to the stage width."""

    def __init__(self, inplanes, width, bottleneck_width, groups, stride=1,
                 downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, bottleneck_width, 1)
        self.bn1 = FrozenBatchNorm2d(bottleneck_width)
        self.conv2 = nn.Conv2d(bottleneck_width, bottleneck_width, 3, stride,
                               1, groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm2d(bottleneck_width)
        self.conv3 = _conv(bottleneck_width, width, 1)
        self.bn3 = FrozenBatchNorm2d(width)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class RegNet(nn.Module):
    """RegNetX (JAX ``RegNet``; mmdet's ``RegNet``): ``arch`` one of
    ``ARCH_SETTINGS`` or a dict of ``w0, wa, wm, group_w, depth,
    bot_mul``; a ``stem_channels`` 3x3/2 stem (``conv1``/``bn1``), no
    max-pool, every stage's first block at stride 2.  Returns the outputs
    of the stages in ``out_indices`` (NCHW)."""

    ARCH_SETTINGS = {
        "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16,
                              depth=22, bot_mul=1.0),
        "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16,
                              depth=16, bot_mul=1.0),
        "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24,
                              depth=18, bot_mul=1.0),
        "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48,
                              depth=25, bot_mul=1.0),
        "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40,
                              depth=23, bot_mul=1.0),
        "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56,
                              depth=17, bot_mul=1.0),
        "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120,
                              depth=23, bot_mul=1.0),
        "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112,
                             depth=19, bot_mul=1.0),
    }

    @staticmethod
    def stage_plan(cfg, divisor=8):
        """Per stage ``(widths, blocks, bottleneck widths, groups)`` from
        the RegNet rule: ``w_j = w0 + wa * j`` snapped to powers of ``wm``
        and to multiples of ``divisor``, runs of equal widths as stages,
        each bottleneck width a multiple of its group width."""
        w_cont = np.arange(cfg["depth"]) * cfg["wa"] + cfg["w0"]
        ks = np.round(np.log(w_cont / cfg["w0"]) / np.log(cfg["wm"]))
        widths = cfg["w0"] * np.power(cfg["wm"], ks)
        widths = (np.round(widths / divisor) * divisor).astype(int)
        stage_w, stage_b = [], []
        for w in widths:
            if not stage_w or stage_w[-1] != w:
                stage_w.append(int(w))
                stage_b.append(1)
            else:
                stage_b[-1] += 1
        bw, groups = [], []
        for w in stage_w:
            wb = int(w * cfg["bot_mul"])
            g = min(cfg["group_w"], wb)
            wb = int(round(wb / g) * g)
            bw.append(wb)
            groups.append(wb // g)
        stage_w = [int(round(b / cfg["bot_mul"])) for b in bw]
        return stage_w, stage_b, bw, groups

    def __init__(self, arch="regnetx_3.2gf", out_indices=(0, 1, 2, 3),
                 frozen_stages=-1, stem_channels=32):
        super().__init__()
        cfg = dict(self.ARCH_SETTINGS[arch]) if isinstance(arch, str) \
            else dict(arch)
        stage_w, stage_b, bw, groups = self.stage_plan(cfg)
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, stem_channels, 3, 2)
        self.bn1 = FrozenBatchNorm2d(stem_channels)
        self.stages = []
        cin = stem_channels
        for s, (w, n, b, g) in enumerate(zip(stage_w, stage_b, bw, groups)):
            blocks = []
            for i in range(n):
                ds = _downsample(cin, w, 2) if i == 0 else None
                blocks.append(RegNetBlock(cin, w, b, g, 2 if i == 0 else 1,
                                          ds))
                cin = w
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{s + 1}")
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        frozen += [getattr(self, f"layer{i}")
                   for i in range(1, frozen_stages + 1)]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        outs = []
        for i, name in enumerate(self.stages):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)



class ResLayerSharedHead(nn.Module):
    """The C4 layout's shared RoI head (JAX ``ResLayerSharedHead``; mmdet's
    ``ResLayer`` shared head): ResNet stage ``stage`` (res5 by default) of
    bottlenecks on the RoI features, its first block at ``stride``, with
    ``style`` and ``norm_cfg`` (``build_norm``: a ``requires_grad=False``
    BatchNorm's affine behind a gradient stop, still decayed, as the JAX
    package).  Stage ``s`` has ``64 * 2**s`` planes and takes half as
    many channels as it gives; mmdet names it ``layer<s + 1>.<b>``.
    ``(R, S, S, C)`` RoI features -> ``(R, S / stride, S / stride, 4 *
    planes)``; ``dilation`` other than 1 raises A7 (the JAX module reads
    none)."""

    def __init__(self, depth=50, stage=3, stride=2, dilation=1,
                 style="caffe", norm_cfg=None, norm_eval=True):
        super().__init__()
        block_name, stage_blocks = ARCH_SETTINGS[depth]
        if block_name != "bottleneck" or dilation != 1:
            raise NotImplementedError(
                f"ResLayer shared head of depth {depth}, dilation "
                f"{dilation} is not ported to bonai_tpu_torch (the JAX "
                f"module takes bottlenecks without dilation; ROADMAP.md "
                f"item A7)")
        planes = 64 * 2 ** stage
        inplanes = planes * 2
        blocks = []
        for b in range(stage_blocks[stage]):
            ds = None
            if b == 0 and (stride != 1 or inplanes != planes * 4):
                ds = _downsample(inplanes, planes * 4, stride, norm_cfg)
            blocks.append(Bottleneck(inplanes, planes,
                                     stride if b == 0 else 1, ds,
                                     style=style, norm_cfg=norm_cfg))
            inplanes = planes * 4
        self.stride = stride
        self.layer_name = f"layer{stage + 1}"
        self.add_module(self.layer_name, nn.Sequential(*blocks))

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x):
        """NHWC ``(R, S, S, C)`` -> NHWC.  On the CPU the stage runs in
        contiguous NCHW, as the backbone does (``TwoStageDetector.
        extract_feat``: the CPU weight gradient of a strided 1x1 conv over
        a channels-last input, caffe style's first ``conv1``, corrupts the
        heap)."""
        x = x.permute(0, 3, 1, 2)
        if not x.is_cuda:
            x = x.contiguous()
        return getattr(self, self.layer_name)(x).permute(0, 2, 3, 1)
