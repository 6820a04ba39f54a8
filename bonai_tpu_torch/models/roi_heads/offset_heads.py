"""LOFT FOA offset head (counterpart of
``bonai_tpu/models/roi_heads/offset_heads.py`` ``OffsetHeadExpandFeature``,
``rotate_feature``, ``foa_offset_targets`` and ``foa_offset_fusion``).

Each rotation branch turns the RoI features by k*90 degrees, runs its own
conv tower and the shared FCs; inference keeps, per axis, the largest
magnitude over the branches with the 0-degree branch's sign.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import offset2delta, offset_rotate
from ..init import fan_in_uniform_, kaiming_fan_out_, normal_, zeros_


def rotate_feature(x, angle_deg):
    """Rotate NCHW features by k*90 degrees counterclockwise; the same
    turn as ``jnp.rot90(x, k, axes=(1, 2))`` on NHWC."""
    k = (int(angle_deg) // 90) % 4
    return torch.rot90(x, k, dims=(2, 3)) if k else x


def _branch_swaps_xy(angle_deg):
    return int(angle_deg) % 180 == 90


class OffsetHeadExpandFeature(nn.Module):
    def __init__(self, roi_feat_size=7, in_channels=256, num_convs=4,
                 num_fcs=2, reg_num=2, conv_out_channels=256,
                 fc_out_channels=1024, expand_feature_num=4,
                 share_expand_fc=False, rotations=(0, 90, 180, 270),
                 offset_coordinate="rectangle"):
        super().__init__()
        if not share_expand_fc or offset_coordinate != "rectangle":
            raise NotImplementedError(
                "bonai_tpu_torch ports the FOA head with shared FCs and "
                "rectangular offsets; the rest is ROADMAP.md item A5")
        self.rotations = tuple(rotations[:expand_feature_num])
        self.expand_convs = nn.ModuleList([
            nn.ModuleList([
                nn.Conv2d(in_channels if j == 0 else conv_out_channels,
                          conv_out_channels, 3, padding=1)
                for j in range(num_convs)])
            for _ in range(expand_feature_num)])
        flat = (conv_out_channels if num_convs else in_channels) \
            * roi_feat_size ** 2
        self.fcs = nn.ModuleList([
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(num_fcs)])
        self.fc_offset = nn.Linear(fc_out_channels if num_fcs else flat,
                                   reg_num)

    def init_weights(self, gen):
        for convs in self.expand_convs:
            for conv in convs:
                kaiming_fan_out_(conv.weight, gen)
                zeros_(conv.bias)
        for fc in self.fcs:
            fan_in_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_offset.weight, 0.01, gen)
        zeros_(self.fc_offset.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(E, N, reg_num)``."""
        x = x.permute(0, 3, 1, 2)
        outs = []
        for angle, convs in zip(self.rotations, self.expand_convs):
            t = rotate_feature(x, angle)
            for conv in convs:
                t = F.relu(conv(t))
            t = t.flatten(1)
            for fc in self.fcs:
                t = F.relu(fc(t))
            outs.append(self.fc_offset(t).float())
        return torch.stack(outs)


def foa_offset_targets(pos_boxes, matched_offsets, rotations,
                       coder_means=(0., 0.), coder_stds=(0.5, 0.5)):
    """Encoded offset targets ``(E, P, 2)`` of each FOA branch: the GT
    offset turned by the branch angle; at 90 and 270 degrees x and y swap
    roles inside the encoding (rotated x normalised by the box height)."""
    outs = []
    for angle in rotations:
        rot = offset_rotate(matched_offsets, angle)
        if _branch_swaps_xy(angle):
            enc = offset2delta(pos_boxes, rot.flip(-1), coder_means,
                               coder_stds).flip(-1)
        else:
            enc = offset2delta(pos_boxes, rot, coder_means, coder_stds)
        outs.append(enc)
    return torch.stack(outs)


def foa_offset_fusion(offset_pred, rotations):
    """Fuse ``(E, N, 2)`` branch predictions into ``(N, 2)`` (max model)."""
    xs, ys = [], []
    for idx in range(offset_pred.shape[0]):
        x, y = offset_pred[idx, :, 0], offset_pred[idx, :, 1]
        if _branch_swaps_xy(rotations[idx]):
            x, y = y, x
        xs.append(x)
        ys.append(y)
    vx = torch.stack(xs, -1).abs().amax(-1)
    vy = torch.stack(ys, -1).abs().amax(-1)
    main = offset_pred[0]
    polarity = torch.where(main > 0, 1.0, -1.0)
    return torch.stack([vx, vy], -1) * polarity
