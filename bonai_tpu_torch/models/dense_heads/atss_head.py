"""ATSS's head, loss and decode (counterpart of
``bonai_tpu/models/dense_heads/atss_head.py``: ``ATSSHead``,
``atss_centerness_target``, ``atss_loss`` and ``atss_bboxes_single``,
batched over images here).

GN towers as FCOS's, one anchor a cell, deltas on the anchors and a
centerness branch on the reg tower; targets from
:func:`~bonai_tpu_torch.core.assigners.atss_assign`.  Keys are
mmdetection v2.3's (``bbox_head.cls_convs.<i>.{conv,gn}``,
``atss_cls``, ``atss_reg``, ``atss_centerness``, ``scales.<l>.scale``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import atss_assign
from ...core.boxes import delta2bbox
from ..losses import GIoULoss, binary_cross_entropy, sigmoid_focal_loss
from .retina_head import (BIAS_PRIOR, Scale, clip_to, flatten_levels,
                          gather_rows, init_output, init_towers,
                          nms_detections, top_per_level, towers)


class ATSSHead(nn.Module):
    """cls and reg towers of ``stacked_convs`` conv-GN(32)-ReLUs, then
    3x3 convs to ``C`` logits, 4 deltas (times a learnable per-level
    scale) and 1 centerness logit (on the reg tower); outputs float32."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_levels=5):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs, self.reg_convs = towers(in_channels, feat_channels,
                                                stacked_convs, 32)
        self.atss_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.atss_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.atss_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        init_output(self.atss_cls, gen, BIAS_PRIOR)
        init_output(self.atss_reg, gen)
        init_output(self.atss_centerness, gen)

    def forward(self, feats):
        cls_out, reg_out, ctr_out = [], [], []
        for x, scale in zip(feats, self.scales):
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.atss_cls(c).float())
            reg_out.append(scale(self.atss_reg(r).float()))
            ctr_out.append(self.atss_centerness(r).float())
        return cls_out, reg_out, ctr_out


def centerness_target(centers, boxes):
    """FCOS centerness of ``(..., 2)`` points in ``(..., 4)`` boxes:
    ``sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b))``, floored at
    0."""
    l_ = centers[..., 0] - boxes[..., 0]
    r_ = boxes[..., 2] - centers[..., 0]
    t_ = centers[..., 1] - boxes[..., 1]
    b_ = boxes[..., 3] - centers[..., 1]
    return _centerness(l_, t_, r_, b_)


def _centerness(l_, t_, r_, b_):
    return torch.sqrt((
        (torch.minimum(l_, r_) / torch.maximum(l_, r_).clamp(min=1e-6))
        * (torch.minimum(t_, b_) / torch.maximum(t_, b_).clamp(min=1e-6))
    ).clamp(min=0.0))


def anchor_centers(anchors):
    return torch.stack([(anchors[..., 0] + anchors[..., 2]) * 0.5,
                        (anchors[..., 1] + anchors[..., 3]) * 0.5], dim=-1)


def atss_targets(anchors, num_level_anchors, gt_bboxes, gt_valid, gt_labels,
                 num_classes, topk):
    """ATSS's labels ``(B, A)`` (``num_classes`` for negatives) and the
    assigned GT boxes ``(B, A, 4)`` of a batch."""
    assigned, _ = atss_assign(anchors, num_level_anchors, gt_bboxes,
                              gt_valid, topk=topk)
    matched = (assigned - 1).clamp(min=0)
    labels = torch.where(assigned > 0, gt_labels.long().gather(1, matched),
                         num_classes)
    return labels, gather_rows(gt_bboxes.float(), matched)


def atss_loss(cls_scores, bbox_preds, centernesses, anchors,
              num_level_anchors, gt_bboxes, gt_valid, gt_labels, num_classes,
              topk=9, target_means=(0.,) * 4, target_stds=(0.1, 0.1, 0.2, 0.2),
              gamma=2.0, alpha=0.25, loss_bbox_weight=2.0):
    """ATSS's losses of a batch: focal over every anchor and BCE
    centerness over the positives, both over the positive count; GIoU of
    the decoded boxes over the positives, weighted by their centerness
    targets and over the targets' sum."""
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4)
    ctr_flat = flatten_levels(centernesses, 1)[..., 0]
    labels, mboxes = atss_targets(anchors, num_level_anchors, gt_bboxes,
                                  gt_valid, gt_labels, num_classes, topk)
    pos = labels < num_classes
    num_pos = pos.sum().float().clamp(min=1.0)
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    loss_cls = sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                  avg_factor=num_pos)
    dec = delta2bbox(anchors, reg_flat, target_means, target_stds)
    ctr_t = centerness_target(anchor_centers(anchors), mboxes)
    loss_bbox = GIoULoss(eps=1e-6, loss_weight=loss_bbox_weight)(
        dec, mboxes, ctr_t * pos)
    loss_ctr = binary_cross_entropy(ctr_flat, ctr_t, pos.float(),
                                    avg_factor=num_pos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_centerness": loss_ctr}


def atss_bboxes(cls_scores, bbox_preds, centernesses, anchors_levels,
                img_shape, num_classes, cfg, target_means=(0.,) * 4,
                target_stds=(0.1, 0.1, 0.2, 0.2)):
    """Detections of a batch: per level the ``nms_pre`` anchors of the
    highest class score times centerness, their boxes decoded and clipped
    to ``img_shape`` ``(B, 2)``, then multi-class NMS over the levels with
    the centerness as a score factor."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, bp, cn, anc in zip(cls_scores, bbox_preds, centernesses,
                               anchors_levels):
        s = torch.sigmoid(flatten_levels([cs], num_classes))
        n = torch.sigmoid(flatten_levels([cn], 1))
        idx = top_per_level(s.max(dim=-1).values * n[..., 0],
                            min(nms_pre, s.shape[1]))
        a = gather_rows(anc.expand(s.shape[0], -1, 4), idx)
        d = gather_rows(flatten_levels([bp], 4), idx)
        boxes_all.append(clip_to(delta2bbox(a, d, target_means, target_stds),
                                 img_shape))
        scores_all.append(gather_rows(s, idx) * gather_rows(n, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.6)
