"""LOFT's per-building attribute heads: height, joint offset and height,
the image's off-nadir angle, side faces and dense offset fields, with the
height coder, the offset field's aggregation and the offset features'
reweighting (counterpart of ``bonai_tpu/models/roi_heads/
attribute_heads.py``).

The RoI heads take ``(N, S, S, C)`` RoI features of padded RoI batches;
padded rows are weighted 0 in the losses.  The regressors are ``num_convs``
3x3 convs and ``num_fcs`` FCs, each followed by a ReLU, then their output
FCs; the first FC reads the (C, H, W) flatten, as the offset head's does.
The dense heads are FCN heads (3x3 convs, a 2x deconv, a 1x1 conv).  The
angle head reads the coarsest FPN level, pools it and regresses one angle
in radians per image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import fan_in_uniform_, kaiming_fan_out_, normal_, zeros_
from .mask_head import resize_bilinear


def _convs(in_channels, out_channels, num):
    return nn.ModuleList([
        nn.Conv2d(in_channels if i == 0 else out_channels, out_channels, 3,
                  padding=1) for i in range(num)])


class _ConvFCTrunk(nn.Module):
    """The regressors' shared trunk; ``forward`` gives the last FC's
    ReLU output."""

    def __init__(self, in_channels=256, roi_feat_size=7, num_convs=4,
                 num_fcs=2, conv_out_channels=256, fc_out_channels=1024):
        super().__init__()
        self.convs = _convs(in_channels, conv_out_channels, num_convs)
        flat = (conv_out_channels if num_convs else in_channels) \
            * roi_feat_size ** 2
        self.fcs = nn.ModuleList([
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(num_fcs)])
        self.out_features = fc_out_channels if num_fcs else flat

    def _outputs(self):
        return [m for m in self.children() if isinstance(m, nn.Linear)]

    def init_weights(self, gen):
        for conv in self.convs:
            kaiming_fan_out_(conv.weight, gen)
            zeros_(conv.bias)
        for fc in self.fcs:
            fan_in_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        for fc in self._outputs():
            normal_(fc.weight, 0.01, gen)
            zeros_(fc.bias)

    def trunk(self, x):
        t = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            t = F.relu(conv(t))
        t = t.flatten(1)
        for fc in self.fcs:
            t = F.relu(fc(t))
        return t


class HeightHead(_ConvFCTrunk):
    """Each RoI's building height, encoded (``height2delta``)."""

    def __init__(self, **trunk):
        super().__init__(**trunk)
        self.fc_height = nn.Linear(self.out_features, 1)

    def forward(self, x):
        """``(N, S, S, C)`` -> float32 ``(N, 1)``."""
        return self.fc_height(self.trunk(x)).float()


class OffsetHeightHead(_ConvFCTrunk):
    """Each RoI's offset and height from one trunk."""

    def __init__(self, reg_num=2, **trunk):
        super().__init__(**trunk)
        self.fc_offset = nn.Linear(self.out_features, reg_num)
        self.fc_height = nn.Linear(self.out_features, 1)

    def forward(self, x):
        """``(N, S, S, C)`` -> float32 ``(N, reg_num)`` and ``(N, 1)``."""
        t = self.trunk(x)
        return self.fc_offset(t).float(), self.fc_height(t).float()


class AngleHead(nn.Module):
    """The image's off-nadir angle: ``num_convs`` 3x3 convs with ReLU on
    the coarsest FPN level, a global average pool and ``fc_angle``."""

    def __init__(self, in_channels=256, conv_out_channels=256, num_convs=2):
        super().__init__()
        self.convs = _convs(in_channels, conv_out_channels, num_convs)
        self.fc_angle = nn.Linear(
            conv_out_channels if num_convs else in_channels, 1)

    def init_weights(self, gen):
        for conv in self.convs:
            kaiming_fan_out_(conv.weight, gen)
            zeros_(conv.bias)
        normal_(self.fc_angle.weight, 0.01, gen)
        zeros_(self.fc_angle.bias)

    def forward(self, feats):
        """NHWC levels -> float32 ``(B, 1)`` radians."""
        x = feats[-1].permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.fc_angle(x.mean(dim=(2, 3))).float()


class _DenseHead(nn.Module):
    """``num_convs`` 3x3 convs, a 2x deconv (each with ReLU) and a 1x1
    conv to ``out`` channels, named ``name``."""

    def __init__(self, out, name, in_channels=256, num_convs=4,
                 conv_out_channels=256):
        super().__init__()
        self.convs = _convs(in_channels, conv_out_channels, num_convs)
        self.upsample = nn.ConvTranspose2d(
            conv_out_channels if num_convs else in_channels,
            conv_out_channels, 2, 2)
        self.out_name = name
        setattr(self, name, nn.Conv2d(conv_out_channels, out, 1))

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kaiming_fan_out_(m.weight, gen)
                zeros_(m.bias)

    def _forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.upsample(x))
        return getattr(self, self.out_name)(x).float()


class SideFaceHead(_DenseHead):
    """Each RoI's visible side faces."""

    def __init__(self, in_channels=256, num_convs=4, conv_out_channels=256):
        super().__init__(1, "conv_logits", in_channels, num_convs,
                         conv_out_channels)

    def forward(self, x):
        """``(N, S, S, C)`` -> float32 ``(N, 1, 2S, 2S)`` logits, as the
        mask head's."""
        return self._forward(x)


class OffsetFieldHead(_DenseHead):
    """Each RoI's dense roof-to-footprint offset field."""

    def __init__(self, in_channels=256, num_convs=4, conv_out_channels=256):
        super().__init__(2, "conv_field", in_channels, num_convs,
                         conv_out_channels)

    def forward(self, x):
        """``(N, S, S, C)`` -> float32 ``(N, 2S, 2S, 2)`` per-pixel
        ``(dx, dy)``."""
        return self._forward(x).permute(0, 2, 3, 1)


def height2delta(heights, means=(0.0,), stds=(4.0,)):
    """Heights encoded for regression: ``(h - mean) / std``."""
    return (heights - means[0]) / stds[0]


def delta2height(deltas, means=(0.0,), stds=(4.0,)):
    """Decoded heights, not below 0."""
    return (deltas * stds[0] + means[0]).clamp(min=0.0)


def offset_field_to_offsets(field, mask_logits):
    """One offset a RoI from its ``(N, S, S, 2)`` field: the mean over the
    pixels weighted by the sigmoid of the roof-mask logits ``(N, 1, S',
    S')`` (resized to ``S`` as ``jax.image.resize`` does).  Returns
    ``(N, 2)``."""
    s = field.shape[1]
    w = torch.sigmoid(resize_bilinear(mask_logits[:, :1], (s, s)))
    w = w.permute(0, 2, 3, 1)
    return (field * w).sum(dim=(1, 2)) / w.sum(dim=(1, 2)).clamp(min=1e-6)


def reweight_roi_feats(offset_feats, mask_logits, side_face_logits):
    """The offset RoI features ``(N, S, S, C)`` scaled by ``(sigmoid(
    resize(side_face + mask)) + 1) / 2`` of the ``(N, 1, S', S')`` logits,
    resized to ``S`` as ``jax.image.resize`` does (antialiased where it
    shrinks)."""
    s = offset_feats.shape[1]
    fused = resize_bilinear(side_face_logits + mask_logits, (s, s))
    w = (torch.sigmoid(fused) + 1.0) * 0.5
    return offset_feats * w.permute(0, 2, 3, 1).to(offset_feats.dtype)
