"""Feature Pyramid Network (counterpart of ``bonai_tpu/models/necks/fpn.py``
for the BONAI config): 1x1 laterals, nearest 2x top-down adds, 3x3 output
convs, and extra levels by ``max_pool2d(x, 1, stride=2)`` (kernel 1: plain
stride-2 subsampling)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..init import xavier_uniform_, zeros_


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: holds ``.conv`` so
    mmdet keys (``neck.lateral_convs.0.conv.weight``) load as they are."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride,
                              kernel // 2 if padding is None else padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=0, add_extra_convs=False):
        super().__init__()
        if start_level != 0 or add_extra_convs:
            raise NotImplementedError(
                "bonai_tpu_torch ports FPN with start_level=0 and no extra "
                "convs; other necks are ROADMAP.md item A6")
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3) for _ in in_channels])

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_uniform_(m.weight, gen)
                zeros_(m.bias)

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
