"""FCN mask head (counterpart of ``bonai_tpu/models/roi_heads/mask_head.py``
``FCNMaskHead``): ``num_convs`` 3x3 convs, a 2x deconv, 1x1 logits."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_, zeros_
from ..necks.fpn import ConvModule


class FCNMaskHead(nn.Module):
    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=1):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3) for i in range(num_convs)])
        last = conv_out_channels if num_convs else in_channels
        self.upsample = nn.ConvTranspose2d(last, conv_out_channels, 2, 2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kaiming_fan_out_(m.weight, gen)
                zeros_(m.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, K, 2S, 2S)``
        mask logits."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).float()
