"""NAS-FPN (counterpart of ``bonai_tpu/models/necks/nas_fpn.py``; mmdet's
``NASFPN``): 1x1 laterals from backbone level ``start_level`` on, extra
levels by a 1x1 conv and a 2x2 max-pool (floor), then ``stack_times``
stages of the nine searched merge cells over P3-P7.

A cell resizes both inputs to its output size (:func:`resize_to`), merges
them (a sum, or the global-pooling cell's ``x2 + sigmoid(mean(x2)) *
x1``) and, but for ``gp_43_5`` and ``gp_54_7``, runs a pre-activated 3x3
conv (ReLU, then the conv).  The upsample is JAX's nearest with
half-pixel centres (torch's ``'nearest-exact'``, not ``'nearest'``): the
two differ where the ratio is not an integer, as from P6 to P4 at COCO's
1344x800.

Keys are mmdet v2.3's: ``neck.lateral_convs.<i>.conv``,
``neck.extra_downsamples.<i>.0.conv``, ``neck.fpn_stages.<s>.<cell>.
out_conv.conv``.  mmdet's ``add_extra_convs`` is read and ignored, as the
JAX builder does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..init import xavier_uniform_, zeros_
from .fpn import ConvModule


def _nearest_index(n_in, n_out, device):
    """JAX's nearest source rows for ``n_out`` outputs of ``n_in`` inputs:
    ``floor((i + 0.5) * n_in / n_out)`` in float32, in that order."""
    i = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return torch.from_numpy(np.floor(i).astype(np.int64)).to(device)


def resize_to(x, th, tw):
    """An ``(N, C, H, W)`` map at ``(th, tw)`` as the JAX merge cells
    resize it: itself at that size; JAX's nearest (half-pixel centres)
    when it grows in height; else a VALID max-pool of ``(H // th, W //
    tw)``."""
    h, w = x.shape[-2:]
    if (h, w) == (th, tw):
        return x
    if h < th:
        if w != tw:
            x = x.index_select(3, _nearest_index(w, tw, x.device))
        return x.index_select(2, _nearest_index(h, th, x.device))
    k = (h // th, w // tw)
    return F.max_pool2d(x, k, k)


class MergeCell(nn.Module):
    """A sum cell or, with ``global_pool``, mmcv's ``GlobalPoolingCell``;
    ``out_conv`` (a pre-activated 3x3 conv) unless ``with_out_conv`` is
    false."""

    def __init__(self, channels, global_pool=False, with_out_conv=True):
        super().__init__()
        self.global_pool = global_pool
        self.out_conv = ConvModule(channels, channels, 3) \
            if with_out_conv else None

    def forward(self, x1, x2, out_size):
        x1 = resize_to(x1, *out_size)
        x2 = resize_to(x2, *out_size)
        if self.global_pool:
            x = x2 + torch.sigmoid(x2.mean(dim=(2, 3), keepdim=True)) * x1
        else:
            x = x1 + x2
        if self.out_conv is not None:
            x = self.out_conv(F.relu(x))
        return x


# a stage's cells in order: name, global pooling, out conv
CELLS = (("gp_64_4", True, True), ("sum_44_4", False, True),
         ("sum_43_3", False, True), ("sum_34_4", False, True),
         ("gp_43_5", True, False), ("sum_55_5", False, True),
         ("gp_54_7", True, False), ("sum_77_7", False, True),
         ("gp_75_6", True, True))


class NASFPN(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), out_channels=256,
                 num_outs=5, stack_times=7, start_level=0,
                 add_extra_convs=False):
        super().__init__()
        used = list(in_channels)[start_level:]
        if num_outs != 5 or len(used) > 5:
            raise ValueError(f"NASFPN merges exactly P3-P7: num_outs "
                             f"{num_outs}, {len(used)} inputs")
        self.start_level = start_level
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in used])
        self.extra_downsamples = nn.ModuleList(
            [nn.Sequential(ConvModule(out_channels, out_channels, 1),
                           nn.MaxPool2d(2, 2))
             for _ in range(num_outs - len(used))])
        self.fpn_stages = nn.ModuleList([nn.ModuleDict(
            {name: MergeCell(out_channels, gp, conv)
             for name, gp, conv in CELLS}) for _ in range(stack_times)])

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_uniform_(m.weight, gen)
                zeros_(m.bias)

    def forward(self, inputs):
        feats = [conv(x) for conv, x in zip(self.lateral_convs,
                                            inputs[self.start_level:])]
        for down in self.extra_downsamples:
            feats.append(down(feats[-1]))
        p3, p4, p5, p6, p7 = feats

        def size(p):
            return tuple(p.shape[-2:])

        for stage in self.fpn_stages:
            p4_1 = stage["gp_64_4"](p6, p4, size(p4))
            p4_2 = stage["sum_44_4"](p4_1, p4, size(p4))
            p3 = stage["sum_43_3"](p4_2, p3, size(p3))
            p4 = stage["sum_34_4"](p3, p4_2, size(p4))
            p5_tmp = stage["gp_43_5"](p4, p3, size(p5))
            p5 = stage["sum_55_5"](p5, p5_tmp, size(p5))
            p7_tmp = stage["gp_54_7"](p5, p4_2, size(p7))
            p7 = stage["sum_77_7"](p7, p7_tmp, size(p7))
            p6 = stage["gp_75_6"](p7, p5, size(p6))
        return p3, p4, p5, p6, p7
