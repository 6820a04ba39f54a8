"""DetectoRS's recursive feature pyramid (counterpart of
``bonai_tpu/models/necks/rfp.py``: ``ASPP``, ``RFP``; mmdet's
``necks/rfp.py``), in plain PyTorch.

The RFP is an FPN (mmdet's keys ``neck.lateral_convs``/``neck.fpn_convs``)
over the backbone's ``(img, c2, c3, c4, c5)``; for each of ``rfp_steps -
1`` steps the shared ``rfp_aspp`` turns pyramid levels 1-3 into the
features of a backbone copy (``rfp_modules.<step - 1>``, whose first
block of each stage past the first adds them through its ``rfp_conv``),
the same FPN runs on the copy's outputs, and a gate, the sigmoid of the
1x1 ``rfp_weight`` shared by the levels and steps, blends the new pyramid
into the old.  The gate and the ``rfp_conv``\\s start at zero.

As in the JAX package, each copy is a ResNet built from ``rfp_backbone``'s
depth, stages, widths, frozen stages, style and SAC options, without its
``conv_cfg``, ``norm_cfg`` or ``output_img`` (a ``norm_cfg`` other than
BN with a trained affine, which is what the copy computes, raises), with
``rfp_conv``\\s over the ASPP's channels; its stem and frozen stages stay
trained behind their gradient stops (ROADMAP.md queue C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.resnet import ResNet, plain_norm
from ..init import lecun_normal_, xavier_uniform_, zeros_
from .fpn import FPN

# rfp_backbone keys the copy reads, and those it leaves, as the JAX RFP does
RFP_BACKBONE_KEYS = ("depth", "num_stages", "base_channels", "out_indices",
                     "frozen_stages", "style", "sac", "stage_with_sac")
RFP_BACKBONE_IGNORED = ("type", "pretrained", "rfp_inplanes", "conv_cfg",
                        "output_img", "norm_eval")


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a ReLU'd conv of each dilation
    (1x1 at dilation 1, else 3x3), the last on the global average pool and
    broadcast, concatenated (``aspp.<i>``)."""

    def __init__(self, in_channels, out_channels=64, dilations=(1, 3, 6, 1)):
        super().__init__()
        self.aspp = nn.ModuleList(
            nn.Conv2d(in_channels, out_channels, 3 if d > 1 else 1,
                      padding=d if d > 1 else 0, dilation=d)
            for d in dilations)

    def init_weights(self, gen):
        for conv in self.aspp:              # flax's default init
            lecun_normal_(conv.weight, gen)
            zeros_(conv.bias)

    def forward(self, x):
        gap = x.mean(dim=(2, 3), keepdim=True)
        outs = [F.relu(conv(gap if i == len(self.aspp) - 1 else x))
                for i, conv in enumerate(self.aspp)]
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, dim=1)


class RFP(FPN):

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, rfp_steps=2, rfp_backbone=None,
                 aspp_out_channels=64, aspp_dilations=(1, 3, 6, 1)):
        super().__init__(in_channels, out_channels, num_outs)
        if rfp_backbone is None:
            raise NotImplementedError(
                "RFP without an rfp_backbone config is not ported to "
                "bonai_tpu_torch (the JAX package builds a default "
                "ResNet-50; ROADMAP.md item A6)")
        rb = dict(rfp_backbone)
        norm_cfg = rb.pop("norm_cfg", None)
        extra = sorted(set(rb) - set(RFP_BACKBONE_KEYS)
                       - set(RFP_BACKBONE_IGNORED))
        if extra or rb.get("type", "ResNet") not in (
                "ResNet", "DetectoRS_ResNet") or not plain_norm(norm_cfg):
            raise NotImplementedError(
                f"rfp_backbone {rb.get('type')} with {extra} and norm_cfg "
                f"{norm_cfg} is not ported "
                f"to bonai_tpu_torch yet (ROADMAP.md item A6)")
        kw = {k: rb[k] for k in RFP_BACKBONE_KEYS if k in rb}
        kw.setdefault("frozen_stages", -1)
        self.rfp_modules = nn.ModuleList()
        for _ in range(1, rfp_steps):
            copy = ResNet(rfp_inplanes=aspp_out_channels * len(
                aspp_dilations), **kw)
            copy.train_behind_stops()
            self.rfp_modules.append(copy)
        self.rfp_aspp = ASPP(out_channels, aspp_out_channels,
                             aspp_dilations)
        self.rfp_weight = nn.Conv2d(out_channels, 1, 1)

    def init_weights(self, gen):
        for conv in [*self.lateral_convs, *self.fpn_convs]:
            xavier_uniform_(conv.conv.weight, gen)
            zeros_(conv.conv.bias)
        for m in self.rfp_modules:
            m.init_weights(gen)
        self.rfp_aspp.init_weights(gen)
        zeros_(self.rfp_weight.weight)
        zeros_(self.rfp_weight.bias)

    def forward(self, inputs):
        """``(img, c2, c3, c4, c5)`` (NCHW) -> the pyramid's levels."""
        img, feats = inputs[0], inputs[1:]
        x = super().forward(feats)
        for copy in self.rfp_modules:
            rfp_feats = [None] + [self.rfp_aspp(x[i]) for i in range(1, 4)]
            new = super().forward(copy(img, rfp_feats))
            x = [w * ft + (1 - w) * prev for ft, prev, w in zip(
                new, x, (torch.sigmoid(self.rfp_weight(ft)) for ft in new))]
        return tuple(x)
