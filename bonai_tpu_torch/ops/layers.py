"""The non-local block of Libra R-CNN's balanced feature pyramid
(counterpart of ``bonai_tpu/ops/layers.py::NonLocal2d``; mmcv's
``NonLocal2d`` as ``BFP`` builds it: embedded Gaussian, no scale).

Module names are mmcv's (``g``, ``theta``, ``phi``, ``conv_out``, each a
``ConvModule`` holding ``.conv``), so mmdet keys load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.init import normal_, zeros_
from ..models.necks.fpn import ConvModule


class NonLocal2d(nn.Module):
    """``x + conv_out(softmax(theta(x)^T phi(x)) g(x))`` over the
    positions of an NCHW map, with ``in_channels // reduction`` inner
    channels.  The pairwise softmax runs in float32.  ``conv_out`` starts
    at zero, so the block starts as the identity."""

    def __init__(self, in_channels, reduction=2):
        super().__init__()
        inter = max(in_channels // reduction, 1)
        self.g = ConvModule(in_channels, inter, 1)
        self.theta = ConvModule(in_channels, inter, 1)
        self.phi = ConvModule(in_channels, inter, 1)
        self.conv_out = ConvModule(inter, in_channels, 1)

    def init_weights(self, gen):
        for m in (self.g, self.theta, self.phi):
            normal_(m.conv.weight, 0.01, gen)
            zeros_(m.conv.bias)
        zeros_(self.conv_out.conv.weight)
        zeros_(self.conv_out.conv.bias)

    def forward(self, x):
        b, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)       # (b, n, c)
        phi = self.phi(x).flatten(2)                           # (b, c, n)
        g = self.g(x).flatten(2).transpose(1, 2)               # (b, n, c)
        attn = torch.softmax(torch.bmm(theta, phi).float(), dim=-1)
        y = torch.bmm(attn.to(g.dtype), g)
        return x + self.conv_out(y.transpose(1, 2).reshape(b, -1, h, w))
