"""Box heads and their training targets (counterpart of
``bonai_tpu/models/roi_heads/bbox_head.py``: ``Shared2FCBBoxHead``, with
Grid R-CNN's classification-only ``with_reg=False``, the shared convs
of ``Shared4Conv1FCBBoxHead`` and the C4 layout's average-pooled
``BBoxHead``,
Double-Head R-CNN's ``DoubleConvFCBBoxHead`` and ``scale_rois``, and
``bbox_targets_single``, batched over images here).  v2.3 labels:
foreground 0..C-1, background C (the last softmax column)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import bbox2delta
from ..backbones.resnet import Bottleneck, FrozenBatchNorm2d
from ..init import kaiming_fan_out_, normal_, xavier_uniform_, zeros_
from ..necks.fpn import ConvModule


def bbox_targets(sampled_boxes, sample_res, gt_bboxes, gt_labels,
                 num_classes, target_means, target_stds, legacy=False):
    """Targets of the sampled boxes ``(B, S, 4)`` of a batch, from the
    sampler's result (``is_pos``, ``valid``, ``pos_gt_inds``, each
    ``(B, S)``) and the padded GT ``(B, G, 4)`` / ``(B, G)``; ``legacy``
    encodes with mmdetection v1.x's ``+1`` sizes.

    Returns ``labels`` (int64, background = ``num_classes``),
    ``label_weights``, ``bbox_targets`` and ``bbox_weights``.
    """
    is_pos = sample_res["is_pos"]
    matched = sample_res["pos_gt_inds"]
    labels = gt_labels.long().gather(1, matched)
    labels = labels.where(is_pos, labels.new_tensor(num_classes))
    label_weights = sample_res["valid"].float()
    deltas = bbox2delta(
        sampled_boxes, gt_bboxes.gather(1, matched[..., None].expand(-1, -1, 4)),
        target_means, target_stds, legacy=legacy)
    w = is_pos.float()[..., None]
    return labels, label_weights, deltas * w, w.expand_as(deltas)


class Shared2FCBBoxHead(nn.Module):
    """``num_shared_convs`` 3x3 convs of ``conv_out_channels`` (each a
    ``ConvModule`` of ``norm_cfg``/``conv_cfg``, then a ReLU; mmdet's
    ``shared_convs.<i>.conv``/``.gn``), ``num_shared_fcs`` shared FCs
    (two by default; ``Shared4Conv1FCBBoxHead`` is 4 convs and 1 FC),
    then the class logits and, ``with_reg``, the box deltas.  Without
    ``fc_reg`` (Grid R-CNN) the deltas are zeros of the same width, which
    decode to the proposal itself.  With ``with_avg_pool`` (mmdet's plain
    ``BBoxHead``, the C4 layout's: no convs or shared FCs) the map is
    averaged over its cells before the FCs."""

    def __init__(self, num_classes=1, in_channels=256, fc_out_channels=1024,
                 roi_feat_size=7, reg_class_agnostic=False, with_reg=True,
                 num_shared_convs=0, num_shared_fcs=2, conv_out_channels=256,
                 norm_cfg=None, conv_cfg=None, with_avg_pool=False):
        super().__init__()
        self.shared_convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, norm_cfg=norm_cfg,
                       conv_cfg=conv_cfg) for i in range(num_shared_convs)])
        self.with_avg_pool = with_avg_pool
        last = (conv_out_channels if num_shared_convs else in_channels) \
            * (1 if with_avg_pool else roi_feat_size ** 2)
        self.shared_fcs = nn.ModuleList()
        for _ in range(num_shared_fcs):
            self.shared_fcs.append(nn.Linear(last, fc_out_channels))
            last = fc_out_channels
        self.fc_cls = nn.Linear(last, num_classes + 1)
        self.reg_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_reg = nn.Linear(last, self.reg_dim) if with_reg else None

    def init_weights(self, gen):
        for conv in self.shared_convs:
            conv.init_weights_as_jax(gen)
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_cls.weight, 0.01, gen)
        zeros_(self.fc_cls.bias)
        if self.fc_reg is not None:
            normal_(self.fc_reg.weight, 0.001, gen)
            zeros_(self.fc_reg.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, C+1)`` class
        logits and ``(N, 4*K)`` deltas; flattened in (C, H, W) order."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.shared_convs:
            x = F.relu(conv(x))
        x = x.mean(dim=(2, 3)) if self.with_avg_pool else x.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        if self.fc_reg is None:
            return self.fc_cls(x).float(), x.new_zeros(
                (x.shape[0], self.reg_dim), dtype=torch.float32)
        return self.fc_cls(x).float(), self.fc_reg(x).float()


class ConvBN(nn.Module):
    """mmcv ``ConvModule`` of a bias-free conv and a BatchNorm (frozen
    over its statistics, as the JAX package's): ``.conv`` and ``.bn``."""

    def __init__(self, cin, cout, kernel):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2,
                              bias=False)
        self.bn = FrozenBatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicResBlock(nn.Module):
    """Double-Head's residual block: ``relu(conv2(relu(conv1(x))) +
    conv_identity(x))``, ``conv1`` 3x3 at ``in_channels``, the others 1x1
    to ``out_channels``."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv1 = ConvBN(in_channels, in_channels, 3)
        self.conv2 = ConvBN(in_channels, out_channels, 1)
        self.conv_identity = ConvBN(in_channels, out_channels, 1)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x)))
                      + self.conv_identity(x))


class DoubleConvFCBBoxHead(nn.Module):
    """Double-Head R-CNN's box head: classification from ``num_fcs`` FCs
    on the cls RoI features, regression from a convolutional branch on the
    reg RoI features (``res_block``, ``num_convs`` bottlenecks at
    ``conv_out_channels // 4`` planes, a global average pool).  Its
    BatchNorms keep their stored statistics, as in the JAX package
    (mmdetection trains them: ROADMAP.md queue C)."""

    def __init__(self, num_classes=1, num_convs=4, num_fcs=2, in_channels=256,
                 conv_out_channels=1024, fc_out_channels=1024,
                 roi_feat_size=7, reg_class_agnostic=False):
        super().__init__()
        self.res_block = BasicResBlock(in_channels, conv_out_channels)
        self.conv_branch = nn.ModuleList(
            Bottleneck(conv_out_channels, conv_out_channels // 4)
            for _ in range(num_convs))
        self.fc_branch = nn.ModuleList(
            nn.Linear(in_channels * roi_feat_size ** 2 if i == 0
                      else fc_out_channels, fc_out_channels)
            for i in range(num_fcs))
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(conv_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
        for fc in self.fc_branch:
            xavier_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_cls.weight, 0.01, gen)
        normal_(self.fc_reg.weight, 0.001, gen)
        zeros_(self.fc_cls.bias)
        zeros_(self.fc_reg.bias)

    def forward(self, x_cls, x_reg):
        """``(N, S, S, C)`` cls and reg RoI features -> float32 ``(N,
        C+1)`` class logits and ``(N, 4*K)`` deltas."""
        x = self.res_block(x_reg.permute(0, 3, 1, 2))
        for block in self.conv_branch:
            x = block(x)
        bbox_pred = self.fc_reg(x.mean(dim=(2, 3)))
        x = x_cls.permute(0, 3, 1, 2).flatten(1)
        for fc in self.fc_branch:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), bbox_pred.float()


def scale_rois(rois, scale_factor):
    """``(R, 5)`` RoIs scaled by ``scale_factor`` about their centres (not
    clipped), as Double-Head's reg branch takes them."""
    cx = (rois[:, 1] + rois[:, 3]) * 0.5
    cy = (rois[:, 2] + rois[:, 4]) * 0.5
    hw = (rois[:, 3] - rois[:, 1]) * 0.5 * scale_factor
    hh = (rois[:, 4] - rois[:, 2]) * 0.5 * scale_factor
    return torch.stack([rois[:, 0], cx - hw, cy - hh, cx + hw, cy + hh], -1)
