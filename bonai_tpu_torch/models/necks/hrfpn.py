"""HRFPN neck (counterpart of ``bonai_tpu/models/necks/hrfpn.py``): every
HRNet branch upsampled to the finest one and concatenated, a 1x1
reduction, then ``num_outs`` levels by average pooling with kernel and
stride ``2**i``, each through a 3x3 output conv.

The upsampling is nearest, as in the JAX package; mmdet's HRFPN upsamples
bilinear (ROADMAP.md queue C).  Keys are mmdet's:
``neck.reduction_conv.conv`` and ``neck.fpn_convs.<i>.conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.hrnet import upsample_nearest
from ..init import xavier_uniform_, zeros_
from .fpn import ConvModule


class HRFPN(nn.Module):
    def __init__(self, in_channels=(32, 64, 128, 256), out_channels=256,
                 num_outs=5):
        super().__init__()
        self.num_outs = num_outs
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3)
             for _ in range(num_outs)])

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_uniform_(m.weight, gen)
                zeros_(m.bias)

    def forward(self, inputs):
        h, w = inputs[0].shape[2:]
        x = self.reduction_conv(torch.cat(
            [inputs[0]] + [upsample_nearest(x, h, w) for x in inputs[1:]],
            dim=1))
        return tuple(conv(x if i == 0 else F.avg_pool2d(x, 2 ** i, 2 ** i))
                     for i, conv in enumerate(self.fpn_convs))
