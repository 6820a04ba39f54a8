"""CornerNet's stacked hourglass (counterpart of
``bonai_tpu/models/backbones/hourglass.py``; mmdet's ``HourglassNet``):
a stride-2 7x7 conv-BN-ReLU of 128 channels and a stride-2 residual block
to ``stage_channels[0]``, then ``num_stacks`` recursive hourglass modules,
each followed by a 3x3 conv-BN-ReLU out conv; between stacks, the 1x1
conv-BNs of the stack's input and of its output are summed, passed
through a ReLU and one residual block.  Returns every stack's output at
stride 4.

An hourglass module of depth ``d``: ``up1`` (blocks at the input's width),
``low1`` (stride 2, to the next width), ``low2`` (the module of depth
``d - 1``, or blocks at the deepest width), ``low3`` (back to the input's
width, the channel change in its last block), and the nearest 2x upsample
of ``low3`` (an integer factor, where torch's ``'nearest'`` and JAX's
agree) added to ``up1``.  The blocks are BasicBlocks with frozen
BatchNorm, the repository's convention (``resnet.py``), as in the JAX
package.

Keys are mmdet v2.3's: ``backbone.stem.0.{conv,bn}``, ``backbone.stem.1.0``
(a block), ``backbone.hourglass_modules.<i>.{up1,low1,low3}.<b>`` and
``.low2`` (a module, or blocks), ``backbone.out_convs.<i>.{conv,bn}``,
``backbone.conv1x1s.<i>``, ``backbone.remap_convs.<i>``,
``backbone.inters.<i>``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_
from .resnet import BasicBlock, FrozenBatchNorm2d, _downsample


def res_layer(inplanes, planes, blocks, stride=1, downsample_first=True):
    """mmdet's ``ResLayer`` of BasicBlocks: the block that changes the
    width or stride first, or (``downsample_first=False``) last."""
    ds = _downsample(inplanes, planes, stride) \
        if stride != 1 or inplanes != planes else None
    if downsample_first:
        layers = [BasicBlock(inplanes, planes, stride, ds)] + [
            BasicBlock(planes, planes) for _ in range(blocks - 1)]
    else:
        layers = [BasicBlock(inplanes, inplanes)
                  for _ in range(blocks - 1)] + [
            BasicBlock(inplanes, planes, stride, ds)]
    return nn.Sequential(*layers)


class ConvBN(nn.Module):
    """mmcv ``ConvModule`` of a conv without bias and a BN, with or
    without a ReLU: ``.conv``, ``.bn``."""

    def __init__(self, cin, cout, k, stride=1, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = FrozenBatchNorm2d(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class HourglassModule(nn.Module):
    def __init__(self, depth, stage_channels, stage_blocks):
        super().__init__()
        cur_c, next_c = stage_channels[0], stage_channels[1]
        cur_b, next_b = stage_blocks[0], stage_blocks[1]
        self.up1 = res_layer(cur_c, cur_c, cur_b)
        self.low1 = res_layer(cur_c, next_c, cur_b, stride=2)
        self.low2 = HourglassModule(depth - 1, stage_channels[1:],
                                    stage_blocks[1:]) if depth > 1 \
            else res_layer(next_c, next_c, next_b)
        self.low3 = res_layer(next_c, cur_c, cur_b, downsample_first=False)

    def forward(self, x):
        low3 = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + F.interpolate(low3, scale_factor=2,
                                           mode="nearest")


class HourglassNet(nn.Module):
    def __init__(self, downsample_times=5, num_stacks=2,
                 stage_channels=(256, 256, 384, 384, 384, 512),
                 stage_blocks=(2, 2, 2, 2, 2, 4), feat_channel=256):
        super().__init__()
        if not (len(stage_channels) == len(stage_blocks)
                > downsample_times):
            raise ValueError(f"HourglassNet: {len(stage_channels)} stage "
                             f"widths and {len(stage_blocks)} block counts "
                             f"for {downsample_times} downsamplings")
        cur_c = stage_channels[0]
        self.num_stacks = num_stacks
        self.stem = nn.Sequential(ConvBN(3, 128, 7, 2),
                                  res_layer(128, cur_c, 1, stride=2))
        self.hourglass_modules = nn.ModuleList(
            [HourglassModule(downsample_times, stage_channels, stage_blocks)
             for _ in range(num_stacks)])
        self.inters = res_layer(cur_c, cur_c, num_stacks - 1) \
            if num_stacks > 1 else nn.Sequential()
        self.conv1x1s = nn.ModuleList(
            [ConvBN(cur_c, cur_c, 1, relu=False)
             for _ in range(num_stacks - 1)])
        self.out_convs = nn.ModuleList(
            [ConvBN(cur_c, feat_channel, 3) for _ in range(num_stacks)])
        self.remap_convs = nn.ModuleList(
            [ConvBN(feat_channel, cur_c, 1, relu=False)
             for _ in range(num_stacks - 1)])

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, hourglass in enumerate(self.hourglass_modules):
            out = self.out_convs[i](hourglass(x))
            outs.append(out)
            if i < self.num_stacks - 1:
                x = self.inters[i](F.relu(self.conv1x1s[i](x)
                                          + self.remap_convs[i](out)))
        return outs
