"""Libra R-CNN's balanced feature pyramid (counterpart of
``bonai_tpu/models/necks/bfp.py``): every level is gathered to the refine
level (finer levels max-pooled down, coarser ones resized up bilinearly
with half-pixel centres), averaged, refined (``None``, a 3x3 ``conv`` or a
``non_local`` block) and scattered back the other way as a residual.

The JAX package resizes bilinearly where mmdetection's ``BFP`` resizes
nearest (ROADMAP.md queue C); the port keeps JAX's.  Keys are mmdet's
(``refine.conv.*``, ``refine.{g,theta,phi,conv_out}.conv.*``).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...ops.layers import NonLocal2d
from ..init import normal_, zeros_
from .fpn import ConvModule


def _max_pool_to(x, h, w):
    """Non-overlapping max pooling by the integer ratio to ``(h, w)`` (the
    JAX package's ``reduce_window``, ``VALID``)."""
    kh, kw = x.shape[2] // h, x.shape[3] // w
    return F.max_pool2d(x, (kh, kw), (kh, kw))


def _resize(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class BFP(nn.Module):
    def __init__(self, in_channels=256, num_levels=5, refine_level=2,
                 refine_type=None):
        super().__init__()
        if refine_type not in (None, "conv", "non_local"):
            raise NotImplementedError(
                f"BFP refine_type={refine_type!r} is not ported to "
                f"bonai_tpu_torch (ROADMAP.md item A7)")
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == "conv":
            self.refine = ConvModule(in_channels, in_channels, 3)
        elif refine_type == "non_local":
            self.refine = NonLocal2d(in_channels, reduction=1)

    def init_weights(self, gen):
        """The JAX package's LeCun normal for the refine conv; the
        non-local block initialises itself."""
        if self.refine_type == "conv":
            w = self.refine.conv.weight
            normal_(w, (1.0 / w[0].numel()) ** 0.5, gen)
            zeros_(self.refine.conv.bias)

    def forward(self, inputs):
        """NCHW levels -> as many NCHW levels."""
        if len(inputs) != self.num_levels:
            raise ValueError(f"BFP of {self.num_levels} levels got "
                             f"{len(inputs)}")
        r = self.refine_level
        th, tw = inputs[r].shape[2:]
        gathered = [_max_pool_to(x, th, tw) if i < r else
                    _resize(x, th, tw) if i > r else x
                    for i, x in enumerate(inputs)]
        bsf = sum(gathered) / len(gathered)
        if self.refine_type is not None:
            bsf = self.refine(bsf)
        outs = []
        for i, x in enumerate(inputs):
            h, w = x.shape[2:]
            res = (_resize(bsf, h, w) if i < r else
                   _max_pool_to(bsf, h, w) if i > r else bsf)
            outs.append(x + res.to(x.dtype))
        return tuple(outs)
