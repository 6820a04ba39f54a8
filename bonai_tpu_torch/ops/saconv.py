"""Switchable atrous convolution, DetectoRS's SAC (counterpart of
``bonai_tpu/ops/saconv.py::SAConv2d``; mmcv's ``SAConv2d`` over
``ConvAWS2d``), in plain PyTorch.

One weight, standardised per output channel (AWS: zero mean, unit std,
then a learnt ``weight_gamma`` and ``weight_beta``), runs at dilation
``r`` and, plus ``weight_diff``, at ``3r``; a switch, the sigmoid of a 1x1
conv on the input's 5x5 average pool at the conv's stride, blends the two.
Zero-initialised 1x1 convs on the global average pool add context before
and after.

The JAX package's choices, kept here (ROADMAP.md queue C): the std is the
population std plus 1e-5 (mmcv: the square root of the unbiased variance
plus 1e-5); ``weight_gamma`` starts at the kaiming fan-out std, not 1; the
switch's pool counts the zero padding (mmcv pads by reflection).  The
standardisation runs in float32 under autocast.

Keys are mmcv's (``weight``, ``weight_gamma``, ``weight_beta``,
``weight_diff``, ``switch``, ``pre_context``, ``post_context``); mmcv's
``weight_gamma``/``weight_beta`` are buffers, trained parameters here as
in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.init import kaiming_fan_out_, zeros_


class SAConv2d(nn.Module):

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 dilation=1, bias=False):
        super().__init__()
        k = kernel_size
        self.stride, self.dilation, self.kernel_size = stride, dilation, k
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k,
                                               k))
        self.weight_gamma = nn.Parameter(torch.full(
            (out_channels, 1, 1, 1), math.sqrt(2.0 / (k * k * out_channels))))
        self.weight_beta = nn.Parameter(torch.zeros(out_channels, 1, 1, 1))
        self.weight_diff = nn.Parameter(torch.zeros(out_channels,
                                                    in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.switch = nn.Conv2d(in_channels, 1, 1)
        self.pre_context = nn.Conv2d(in_channels, in_channels, 1)
        self.post_context = nn.Conv2d(out_channels, out_channels, 1)

    def init_weights(self, gen):
        kaiming_fan_out_(self.weight, gen)
        with torch.no_grad():
            self.weight_gamma.fill_(math.sqrt(
                2.0 / (self.kernel_size ** 2 * self.weight.shape[0])))
        for t in (self.weight_beta, self.weight_diff, self.switch.weight,
                  self.pre_context.weight, self.pre_context.bias,
                  self.post_context.weight, self.post_context.bias):
            zeros_(t)
        with torch.no_grad():
            self.switch.bias.fill_(1.0)
        if self.bias is not None:
            zeros_(self.bias)

    def standardized_weight(self):
        """The AWS weight, in float32 (float64 for float64 weights)."""
        dtype = torch.promote_types(self.weight.dtype, torch.float32)
        w = self.weight.to(dtype)
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-5
        return (w - mean) / std * self.weight_gamma.to(dtype) \
            + self.weight_beta.to(dtype)

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            w = self.standardized_weight()
            w_diff = w + self.weight_diff.to(w.dtype)
        # each branch's weight in the input's dtype, as autocast casts it
        w, w_diff = w.to(x.dtype), w_diff.to(x.dtype)
        x = x + self.pre_context(x.mean(dim=(2, 3), keepdim=True)).to(
            x.dtype)
        s = torch.sigmoid(self.switch(F.avg_pool2d(x, 5, self.stride, 2)))
        pad = self.kernel_size // 2
        r = self.dilation
        out = s * F.conv2d(x, w, None, self.stride, r * pad, r) \
            + (1 - s) * F.conv2d(x, w_diff, None, self.stride, 3 * r * pad,
                                 3 * r)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out + self.post_context(out.mean(dim=(2, 3),
                                                keepdim=True)).to(out.dtype)
