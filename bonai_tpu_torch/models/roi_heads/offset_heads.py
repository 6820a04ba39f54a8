"""LOFT offset heads (counterpart of
``bonai_tpu/models/roi_heads/offset_heads.py``: the plain ``OffsetHead``,
the FOA ``OffsetHeadExpandFeature``, ``rotate_feature``,
``foa_offset_targets`` and ``foa_offset_fusion``).

The plain head is four 3x3 convs, two FCs and an FC to the offset.  In the
FOA head each rotation branch turns the RoI features by k*90 degrees, runs
its own conv tower and the shared FCs, or its own; inference keeps, per
axis, the largest magnitude over the branches with the 0-degree branch's
sign.
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


class OffsetHead(nn.Module):
    """``num_convs`` 3x3 convs, ``num_fcs`` FCs and ``fc_offset``, each
    but the last followed by a ReLU (reference ``offset_head.py:23-105``):
    ``reg_num`` 2 for rectangular or polar offsets, 3 for polar ones as
    ``(length, cos, sin)``.  The first FC reads the (C, H, W) flatten, as
    mmdet's does."""

    def __init__(self, roi_feat_size=7, in_channels=256, num_convs=4,
                 num_fcs=2, reg_num=2, conv_out_channels=256,
                 fc_out_channels=1024):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels if i == 0 else conv_out_channels,
                      conv_out_channels, 3, padding=1)
            for i in range(num_convs)])
        flat = (conv_out_channels if num_convs else in_channels) \
            * roi_feat_size ** 2
        self.fcs = nn.ModuleList([
            nn.Linear(flat if i == 0 else fc_out_channels, fc_out_channels)
            for i in range(num_fcs)])
        self.fc_offset = nn.Linear(fc_out_channels if num_fcs else flat,
                                   reg_num)

    def init_weights(self, gen):
        for conv in self.convs:
            kaiming_fan_out_(conv.weight, gen)
            zeros_(conv.bias)
        for fc in self.fcs:
            fan_in_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_offset.weight, 0.01, gen)
        zeros_(self.fc_offset.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, reg_num)``."""
        t = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            t = F.relu(conv(t))
        t = t.flatten(1)
        for fc in self.fcs:
            t = F.relu(fc(t))
        return self.fc_offset(t).float()


class OffsetHeadExpandFeature(nn.Module):
    """FOA: ``expand_feature_num`` rotation branches, each with its own
    conv tower, and FCs shared by the branches (``fcs``, ``fc_offset``)
    or each branch's own (``expand_fcs.<e>``, ``expand_fc_offsets.<e>``,
    the JAX default)."""

    def __init__(self, roi_feat_size=7, in_channels=256, num_convs=4,
                 num_fcs=2, reg_num=2, conv_out_channels=256,
                 fc_out_channels=1024, expand_feature_num=4,
                 share_expand_fc=False, rotations=(0, 90, 180, 270),
                 offset_coordinate="rectangle"):
        super().__init__()
        self.rotations = tuple(rotations[:expand_feature_num])
        self.share_expand_fc = share_expand_fc
        self.expand_convs = nn.ModuleList([
            nn.ModuleList([
                nn.Conv2d(in_channels if j == 0 else conv_out_channels,
                          conv_out_channels, 3, padding=1)
                for j in range(num_convs)])
            for _ in range(expand_feature_num)])
        flat = (conv_out_channels if num_convs else in_channels) \
            * roi_feat_size ** 2

        def fcs():
            return nn.ModuleList([
                nn.Linear(flat if i == 0 else fc_out_channels,
                          fc_out_channels) for i in range(num_fcs)])

        def fc_offset():
            return nn.Linear(fc_out_channels if num_fcs else flat, reg_num)
        if share_expand_fc:
            self.fcs = fcs()
            self.fc_offset = fc_offset()
        else:
            self.expand_fcs = nn.ModuleList(
                [fcs() for _ in range(expand_feature_num)])
            self.expand_fc_offsets = nn.ModuleList(
                [fc_offset() for _ in range(expand_feature_num)])

    def _branch_fcs(self):
        """Each branch's FCs and output FC."""
        if self.share_expand_fc:
            return [(self.fcs, self.fc_offset)] * len(self.rotations)
        return list(zip(self.expand_fcs, self.expand_fc_offsets))

    def init_weights(self, gen):
        for convs in self.expand_convs:
            for conv in convs:
                kaiming_fan_out_(conv.weight, gen)
                zeros_(conv.bias)
        for fcs, out in dict.fromkeys(self._branch_fcs()):  # shared: once
            for fc in fcs:
                fan_in_uniform_(fc.weight, gen)
                zeros_(fc.bias)
            normal_(out.weight, 0.01, gen)
            zeros_(out.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(E, N, reg_num)``."""
        x = x.permute(0, 3, 1, 2)
        outs = []
        for angle, convs, (fcs, fc_offset) in zip(
                self.rotations, self.expand_convs, self._branch_fcs()):
            t = rotate_feature(x, angle)
            for conv in convs:
                t = F.relu(conv(t))
            t = t.flatten(1)
            for fc in fcs:
                t = F.relu(fc(t))
            outs.append(fc_offset(t).float())
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
