"""Box head and its training targets (counterpart of
``bonai_tpu/models/roi_heads/bbox_head.py``: ``Shared2FCBBoxHead`` and
``bbox_targets_single``, batched over images here).  v2.3 labels:
foreground 0..C-1, background C (the last softmax column)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...core.boxes import bbox2delta
from ..init import normal_, xavier_uniform_, zeros_


def bbox_targets(sampled_boxes, sample_res, gt_bboxes, gt_labels,
                 num_classes, target_means, target_stds):
    """Targets of the sampled boxes ``(B, S, 4)`` of a batch, from the
    sampler's result (``is_pos``, ``valid``, ``pos_gt_inds``, each
    ``(B, S)``) and the padded GT ``(B, G, 4)`` / ``(B, G)``.

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
        target_means, target_stds)
    w = is_pos.float()[..., None]
    return labels, label_weights, deltas * w, w.expand_as(deltas)


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes=1, in_channels=256, fc_out_channels=1024,
                 roi_feat_size=7, reg_class_agnostic=False):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def init_weights(self, gen):
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_cls.weight, 0.01, gen)
        normal_(self.fc_reg.weight, 0.001, gen)
        zeros_(self.fc_cls.bias)
        zeros_(self.fc_reg.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, C+1)`` class
        logits and ``(N, 4*K)`` deltas; flattened in (C, H, W) order."""
        x = x.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()
