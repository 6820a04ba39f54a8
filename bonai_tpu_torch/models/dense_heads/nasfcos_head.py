"""NAS-FCOS's head (counterpart of
``bonai_tpu/models/dense_heads/nasfcos_head.py``): FCOS's outputs over
two searched towers of [modulated deformable 3x3 conv with bias, 3x3 conv,
modulated deformable 3x3 conv with bias, 1x1 conv], each followed by
GroupNorm(32) (epsilon 1e-6) and a ReLU; per-level scales, ``exp`` of the
regression.  Targets, loss and decode are FCOS's (``fcos_head.py``).

The deformable convs run the port's ``ops/deform_conv.py`` with one offset
group: the JAX head builds ``ModulatedDeformConv2d`` with its default of
one, where mmdetection's has two (``deform_groups=2``).  An mmdet ``.pth``
with two groups raises ``ValueError`` on loading
(``utils/weights.py::mmdet_state_dict``; ROADMAP.md queue C).

Keys are mmdetection v2.3's: ``bbox_head.cls_convs.<i>.conv`` (the
deformable ones with ``.conv_offset``), ``cls_convs.<i>.gn``,
``reg_convs.*``, ``fcos_cls``, ``fcos_reg``, ``fcos_centerness``,
``scales.<l>.scale``.  The plain tower convs keep the bias they have in
the JAX package (mmdetection's have none: a zero one on loading).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import ModulatedDeformConv2dPack
from ..init import kaiming_fan_out_, zeros_
from .retina_head import BIAS_PRIOR, GN_EPS, Scale, init_output

# the searched tower: (deformable, kernel size) per op
ARCH = ((True, 3), (False, 3), (True, 3), (False, 1))


class SearchedConv(nn.Module):
    """One op of the tower, GroupNorm(32) and a ReLU: ``.conv``, ``.gn``."""

    def __init__(self, cin, cout, deform, k):
        super().__init__()
        self.conv = ModulatedDeformConv2dPack(cin, cout, k, padding=k // 2,
                                              bias=True) if deform \
            else nn.Conv2d(cin, cout, k, padding=k // 2)
        self.gn = nn.GroupNorm(32, cout, eps=GN_EPS)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class NASFCOSHead(nn.Module):
    """Outputs as ``FCOSHead``'s: float32 logits, ``exp`` distances and
    centerness logits (on the cls tower, or the reg tower with
    ``centerness_on_reg``)."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 num_levels=5, centerness_on_reg=False):
        super().__init__()
        self.centerness_on_reg = centerness_on_reg
        self.cls_convs, self.reg_convs = (nn.ModuleList(
            [SearchedConv(in_channels if i == 0 else feat_channels,
                          feat_channels, deform, k)
             for i, (deform, k) in enumerate(ARCH)]) for _ in range(2))
        self.fcos_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.fcos_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def init_weights(self, gen):
        for tower in (self.cls_convs, self.reg_convs):
            for m in tower:
                if isinstance(m.conv, nn.Conv2d):
                    kaiming_fan_out_(m.conv.weight, gen)
                    zeros_(m.conv.bias)
                else:
                    m.conv.init_weights(gen)
                nn.init.ones_(m.gn.weight)
                zeros_(m.gn.bias)
        init_output(self.fcos_cls, gen, BIAS_PRIOR)
        init_output(self.fcos_reg, gen)
        init_output(self.fcos_centerness, gen)

    def forward(self, feats):
        cls_out, reg_out, ctr_out = [], [], []
        for x, scale in zip(feats, self.scales):
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.fcos_cls(c).float())
            ctr_out.append(self.fcos_centerness(
                r if self.centerness_on_reg else c).float())
            reg_out.append(torch.exp(scale(self.fcos_reg(r).float())))
        return cls_out, reg_out, ctr_out
