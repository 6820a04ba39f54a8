"""SSD's VGG backbone (counterpart of
``bonai_tpu/models/backbones/ssd_vgg.py``; mmdet's ``SSDVGG``): the VGG
trunk of 3x3 conv-ReLUs with ceil-mode 2x2 max-pools (75 -> 38 at 300^2)
after each of the first four stages, pool5 a 3x3 stride-1 max-pool,
fc6 a 3x3 conv of dilation 6 and fc7 a 1x1 conv (1024 channels each), then
the ladder of extra convs (alternating 1x1 and 3x3, stride 2 after an
``'S'``; the 512 ladder ends in a 4x4 conv).  Outputs: conv4_3 through the
L2Norm (``x / sqrt(sum(x^2) + 1e-10) * scale`` over the channels, in
float32, ``scale`` learned from ``l2_norm_scale``), fc7, and every second
extra conv: six levels at 300^2, seven at 512^2.

Keys are mmdet v2.3's: ``backbone.features.<n>`` (mmcv's ``VGG``
``nn.Sequential`` with its ReLUs and pools counted, then pool5, fc6 and
fc7), ``backbone.extra.<j>``, ``backbone.l2_norm.weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_, xavier_uniform_, zeros_

# conv counts per VGG stage by depth (mmcv's VGG) and their widths
VGG_STAGES = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
              16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
STAGE_CHANNELS = (64, 128, 256, 512, 512)
FC_CHANNELS = 1024
# extra-conv ladders; 'S' makes the next 3x3 conv stride 2
EXTRA = {300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
         512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S",
               256, 128)}


def feature_indices(depth):
    """The ``features.<n>`` index of each VGG conv (``conv<s>_<c>``, in
    order), then of fc6 and fc7: each conv is followed by its ReLU, each
    of the first four stages by its pool, and pool5 precedes fc6."""
    idx, n = [], 0
    for s, convs in enumerate(VGG_STAGES[depth]):
        for _ in range(convs):
            idx.append(n)
            n += 2
        if s < 4:
            n += 1
    return idx + [n + 1, n + 3]


def _ceil_max_pool(x):
    """2x2/2 max-pool keeping the last partial window (JAX pads with
    -inf on the bottom and right)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class L2Norm(nn.Module):
    def __init__(self, channels, scale=20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        f = x.float()
        norm = torch.sqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)
        return (f / norm * self.weight.float()[:, None, None]).to(x.dtype)


class SSDVGG(nn.Module):
    def __init__(self, input_size=300, depth=16, l2_norm_scale=20.0):
        super().__init__()
        if input_size not in EXTRA:
            raise ValueError(f"SSDVGG input_size {input_size} (300 or 512)")
        self.input_size = input_size
        self.depth = depth
        index = feature_indices(depth)
        layers = {}
        cin, k = 3, 0
        for convs, ch in zip(VGG_STAGES[depth], STAGE_CHANNELS):
            for _ in range(convs):
                layers[str(index[k])] = nn.Conv2d(cin, ch, 3, padding=1)
                cin, k = ch, k + 1
        layers[str(index[-2])] = nn.Conv2d(cin, FC_CHANNELS, 3, padding=6,
                                           dilation=6)
        layers[str(index[-1])] = nn.Conv2d(FC_CHANNELS, FC_CHANNELS, 1)
        self.features = nn.ModuleDict(layers)
        extra, cin, kernel = [], FC_CHANNELS, (1, 3)
        plan = EXTRA[input_size]
        for i, ch in enumerate(plan):
            if ch == "S":
                continue
            k = kernel[len(extra) % 2]
            stride2 = i > 0 and plan[i - 1] == "S"
            extra.append(nn.Conv2d(cin, ch, k, 2 if stride2 else 1,
                                   1 if stride2 else 0))
            cin = ch
        if input_size == 512:
            extra.append(nn.Conv2d(cin, 256, 4, padding=1))
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(STAGE_CHANNELS[3], l2_norm_scale)

    def init_weights(self, gen):
        for conv in self.features.values():
            kaiming_fan_out_(conv.weight, gen)
            zeros_(conv.bias)
        for conv in self.extra:
            xavier_uniform_(conv.weight, gen)
            zeros_(conv.bias)

    def forward(self, x):
        convs = list(self.features.values())
        k = 0
        outs = []
        for s, n in enumerate(VGG_STAGES[self.depth]):
            for _ in range(n):
                x = F.relu(convs[k](x))
                k += 1
            if s == 3:
                outs.append(x)                      # conv4_3, before pool4
            x = _ceil_max_pool(x) if s < 4 else F.max_pool2d(x, 3, 1, 1)
        x = F.relu(convs[k](x))                     # fc6
        outs.append(F.relu(convs[k + 1](x)))        # fc7
        x = outs[-1]
        for j, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if j % 2 == 1:
                outs.append(x)
        outs[0] = self.l2_norm(outs[0])
        return tuple(outs)
