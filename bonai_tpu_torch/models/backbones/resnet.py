"""ResNet backbone, pytorch style, with frozen BatchNorm (counterpart of
``bonai_tpu/models/backbones/resnet.py`` for the BONAI config:
``frozen_stages=1, norm_eval=True, style='pytorch'``).

Module and parameter names follow mmdet v2.3 / torchvision
(``backbone.layer1.0.conv1.weight``, ``backbone.layer1.0.downsample.1
.running_var``), so their checkpoints load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over stored running statistics (``norm_eval=True``): one
    per-channel multiply-add.  The affine parameters are parameters, the
    statistics buffers, with ``nn.BatchNorm2d``'s names."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] \
            + shift.to(x.dtype)[:, None, None]


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


def _downsample(cin, cout, stride):
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + identity)


class Bottleneck(nn.Module):
    """Pytorch style: the stride sits on the 3x3 conv2."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNet(nn.Module):
    """Returns the outputs of the stages in ``out_indices`` (NCHW)."""

    def __init__(self, depth=50, num_stages=4, out_indices=(0, 1, 2, 3),
                 frozen_stages=1, norm_eval=True, style="pytorch",
                 base_channels=64):
        super().__init__()
        if style != "pytorch" or not norm_eval:
            raise NotImplementedError(
                "bonai_tpu_torch ports the pytorch-style ResNet with "
                "norm_eval=True; other variants are ROADMAP.md item A6")
        block_name, stage_blocks = ARCH_SETTINGS[depth]
        block = Bottleneck if block_name == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, base_channels, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(base_channels)
        inplanes, planes = base_channels, base_channels
        self.stages = []
        for i in range(num_stages):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(stage_blocks[i]):
                ds = None
                if b == 0 and (stride != 1
                               or inplanes != planes * block.expansion):
                    ds = _downsample(inplanes, planes * block.expansion,
                                     stride)
                blocks.append(block(inplanes, planes,
                                    stride if b == 0 else 1, ds))
                inplanes = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.stages.append(f"layer{i + 1}")
            planes *= 2
        # frozen stem + first stages: no gradient (norm_eval keeps BN fixed
        # everywhere)
        frozen = [self.conv1, self.bn1] + [
            getattr(self, f"layer{i}") for i in range(1, frozen_stages + 1)]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, name in enumerate(self.stages):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
