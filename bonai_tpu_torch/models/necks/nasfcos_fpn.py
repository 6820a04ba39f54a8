"""NAS-FCOS's FPN (counterpart of ``bonai_tpu/models/necks/nasfcos_fpn.py``;
mmdet's ``NASFCOS_FPN``): 1x1 adapt convs without bias on C3-C5, each
followed by a norm and a ReLU; the searched DAG of seven concat cells;
the global fusion of cells 9, 8 and 7 with cell 5, resized onto C3, C4
and C5; and stride-2 3x3 extra levels (a ReLU before all but the first,
then a norm, then the conv).

Where mmdet has BatchNorm (the adapt convs, the cells' out convs) the JAX
package has a per-channel GroupNorm (one channel a group, epsilon 1e-6),
and it adds one before each extra level's conv, where mmdet has no norm;
the port keeps JAX's (ROADMAP.md queue C).  The global fusion resizes with
``jax.image.resize(..., 'bilinear')``: half-pixel centres, antialiased
where it shrinks (``roi_heads/mask_head.py::resize_bilinear``).

A concat cell (mmcv's ``ConcatCell``): optional 3x3 input convs with a
ReLU, both inputs resized to the larger one (:func:`nas_fpn.resize_to`),
concatenated, then the norm, a ReLU and a grouped 1x1 conv without bias,
``Conv2d(2c, c, 1, groups=c)``: output ``g`` reads channels ``2g`` and
``2g + 1``.

Keys are mmdet v2.3's: ``neck.adapt_convs.<i>.{conv,bn}``,
``neck.fpn.<cell>.{input1_conv,input2_conv}.conv``, ``neck.fpn.<cell>.
out_conv.{bn,conv}``, ``neck.extra_downsamples.<i>.conv``; the extra
levels' norms, which mmdet lacks, are ``neck.extra_downsamples.<i>.norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_, xavier_uniform_, zeros_
from ..roi_heads.mask_head import resize_bilinear
from .fpn import ConvModule
from .nas_fpn import resize_to

GN_EPS = 1e-6                   # flax's GroupNorm epsilon


def channel_norm(channels):
    """The JAX package's per-channel GroupNorm (``group_size=1``), where
    mmdet has a BatchNorm."""
    return nn.GroupNorm(channels, channels, eps=GN_EPS)


class AdaptConv(nn.Module):
    """1x1 conv without bias, norm, ReLU: ``.conv``, ``.bn``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = channel_norm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CellOutConv(nn.Module):
    """The cell's out conv in mmcv's order ``('norm', 'act', 'conv')``:
    ``.bn`` over the ``2c`` concatenated channels, a ReLU, ``.conv``."""

    def __init__(self, channels):
        super().__init__()
        self.bn = channel_norm(2 * channels)
        self.conv = nn.Conv2d(2 * channels, channels, 1, groups=channels,
                              bias=False)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x)))


class ConcatCell(nn.Module):
    def __init__(self, channels, with_input1_conv=True,
                 with_input2_conv=True):
        super().__init__()
        self.input1_conv = ConvModule(channels, channels, 3) \
            if with_input1_conv else None
        self.input2_conv = ConvModule(channels, channels, 3) \
            if with_input2_conv else None
        self.out_conv = CellOutConv(channels)

    def forward(self, x1, x2):
        if self.input1_conv is not None:
            x1 = F.relu(self.input1_conv(x1))
        if self.input2_conv is not None:
            x2 = F.relu(self.input2_conv(x2))
        th = max(x1.shape[2], x2.shape[2])
        tw = max(x1.shape[3], x2.shape[3])
        return self.out_conv(torch.cat([resize_to(x1, th, tw),
                                        resize_to(x2, th, tw)], 1))


class ExtraLevel(nn.Module):
    """A ReLU (but before the first), the norm, a stride-2 3x3 conv."""

    def __init__(self, channels, relu):
        super().__init__()
        self.relu = relu
        self.norm = channel_norm(channels)
        self.conv = nn.Conv2d(channels, channels, 3, 2, 1)

    def forward(self, x):
        return self.conv(self.norm(F.relu(x) if self.relu else x))


# the searched DAG: cell, its two inputs (indices into the features so
# far: adapted C3, C4, C5, then the cells in order), input convs
CELLS = (("c22_1", 2, 2, True, True), ("c22_2", 2, 2, True, True),
         ("c32", 3, 2, True, False), ("c02", 0, 2, True, False),
         ("c42", 4, 2, True, True), ("c36", 3, 6, True, True),
         ("c61", 6, 1, True, True))


class NASFCOS_FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=1):
        super().__init__()
        if len(in_channels) - start_level != 3:
            raise ValueError(f"NASFCOS_FPN adapts three levels (C3-C5): "
                             f"{len(in_channels)} inputs from level "
                             f"{start_level}")
        self.start_level = start_level
        self.adapt_convs = nn.ModuleList(
            [AdaptConv(c, out_channels) for c in in_channels[start_level:]])
        self.fpn = nn.ModuleDict(
            {name: ConcatCell(out_channels, w1, w2)
             for name, _, _, w1, w2 in CELLS})
        self.extra_downsamples = nn.ModuleList(
            [ExtraLevel(out_channels, i > 0) for i in range(num_outs - 3)])

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                if m.bias is None:
                    kaiming_fan_out_(m.weight, gen)
                else:
                    xavier_uniform_(m.weight, gen)
                    zeros_(m.bias)

    def forward(self, inputs):
        feats = [conv(x) for conv, x in zip(self.adapt_convs,
                                            inputs[self.start_level:])]
        for name, i1, i2, _, _ in CELLS:
            feats.append(self.fpn[name](feats[i1], feats[i2]))
        outs = []
        for idx, input_idx in zip((9, 8, 7), (1, 2, 3)):
            f1 = feats[idx]
            fsum = f1 + resize_bilinear(feats[5], f1.shape[-2:])
            outs.append(resize_bilinear(fsum, inputs[input_idx].shape[-2:]))
        for extra in self.extra_downsamples:
            outs.append(extra(outs[-1]))
        return tuple(outs)
