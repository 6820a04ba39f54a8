"""GFL's head, loss and decode (counterpart of
``bonai_tpu/models/dense_heads/gfl_head.py``: ``GFLHead``, ``integral``,
``_giou``, ``gfl_loss`` and ``gfl_bboxes_single``, batched over images
here).

ATSS's GN towers and assignment; each box side is a softmax over the
``reg_max + 1`` integer distances (in strides) from the anchor's centre,
decoded by its expectation.  Classification is trained by the quality
focal loss against the decoded box's IoU, the sides by GIoU and the
distribution focal loss.  Keys are mmdetection v2.3's
(``bbox_head.cls_convs.<i>.{conv,gn}``, ``gfl_cls``, ``gfl_reg``,
``scales.<l>.scale``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..losses import (aligned_iou_giou, distribution_focal_loss,
                      quality_focal_loss)
from .atss_head import anchor_centers, atss_targets
from .retina_head import (BIAS_PRIOR, Scale, clip_to, flatten_levels,
                          gather_rows, init_output, init_towers,
                          nms_detections, top_per_level, towers)


class GFLHead(nn.Module):
    """cls and reg towers of ``stacked_convs`` conv-GN-ReLUs (``min(32,
    feat_channels)`` groups), then 3x3 convs to ``C`` logits and
    ``4 * (reg_max + 1)`` distance logits (times a learnable per-level
    scale); outputs float32."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 stacked_convs=4, reg_max=16, num_levels=5):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.cls_convs, self.reg_convs = towers(in_channels, feat_channels,
                                                stacked_convs,
                                                min(32, feat_channels))
        self.gfl_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.gfl_reg = nn.Conv2d(feat_channels, 4 * (reg_max + 1), 3,
                                 padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        init_output(self.gfl_cls, gen, BIAS_PRIOR)
        init_output(self.gfl_reg, gen)

    def forward(self, feats):
        cls_out, reg_out = [], []
        for x, scale in zip(feats, self.scales):
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.gfl_cls(c).float())
            reg_out.append(scale(self.gfl_reg(r).float()))
        return cls_out, reg_out


def integral(pred, reg_max):
    """The expectation of each side's softmax over ``0..reg_max``:
    ``(..., 4 * (reg_max + 1))`` logits -> ``(..., 4)`` distances."""
    p = pred.reshape(pred.shape[:-1] + (4, reg_max + 1))
    proj = torch.arange(reg_max + 1, dtype=torch.float32, device=pred.device)
    return (torch.softmax(p, dim=-1) * proj).sum(-1)


def _ltrb_boxes(centers, dist):
    return torch.stack([centers[..., 0] - dist[..., 0],
                        centers[..., 1] - dist[..., 1],
                        centers[..., 0] + dist[..., 2],
                        centers[..., 1] + dist[..., 3]], dim=-1)


def gfl_loss(cls_scores, bbox_preds, anchors, strides, num_level_anchors,
             gt_bboxes, gt_valid, gt_labels, num_classes, reg_max=16, topk=9,
             qfl_beta=2.0, loss_cls_weight=1.0, loss_bbox_weight=2.0,
             loss_dfl_weight=0.25):
    """GFL's losses of a batch over the ``(A, 4)`` concatenated anchors
    and their ``(A,)`` strides: QFL against the decoded box's IoU (no
    gradient) over the positive count; GIoU and DFL on the
    stride-normalised sides of the positives, weighted by their largest
    class probability (no gradient) and over its sum."""
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4 * (reg_max + 1))
    labels, mboxes = atss_targets(anchors, num_level_anchors, gt_bboxes,
                                  gt_valid, gt_labels, num_classes, topk)
    pos = labels < num_classes
    num_pos = pos.sum().float().clamp(min=1.0)
    stride = strides[None, :, None]
    centers = anchor_centers(anchors)[None] / stride          # (1, A, 2)
    dec = _ltrb_boxes(centers, integral(reg_flat, reg_max))
    tgt = mboxes / stride
    iou, giou = aligned_iou_giou(dec, tgt)
    score = torch.where(pos, iou.detach(), 0.0)
    loss_cls = loss_cls_weight * quality_focal_loss(
        cls_flat, labels, score, qfl_beta).sum() / num_pos
    wt = torch.where(pos, torch.sigmoid(cls_flat.detach()).amax(-1), 0.0)
    wsum = wt.sum().clamp(min=1e-6)
    loss_bbox = loss_bbox_weight * ((1.0 - giou) * wt).sum() / wsum
    tdist = torch.stack([centers[..., 0] - tgt[..., 0],
                         centers[..., 1] - tgt[..., 1],
                         tgt[..., 2] - centers[..., 0],
                         tgt[..., 3] - centers[..., 1]], dim=-1)
    per_side = distribution_focal_loss(
        reg_flat.reshape(reg_flat.shape[:2] + (4, reg_max + 1)),
        tdist.clamp(0, reg_max - 0.1))
    loss_dfl = loss_dfl_weight * (per_side * wt[..., None]).sum() / (
        4.0 * wsum)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_dfl": loss_dfl}


def gfl_bboxes(cls_scores, bbox_preds, anchors_levels, strides, img_shape,
               num_classes, cfg, reg_max=16):
    """Detections of a batch: per level the ``nms_pre`` anchors of the
    highest class score, their sides' expectations times the level's
    stride about the anchor's centre, clipped to ``img_shape`` ``(B,
    2)``, then multi-class NMS over the levels."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, bp, anc, st in zip(cls_scores, bbox_preds, anchors_levels,
                               strides):
        s = torch.sigmoid(flatten_levels([cs], num_classes))
        idx = top_per_level(s.max(dim=-1).values, min(nms_pre, s.shape[1]))
        a = gather_rows(anc.expand(s.shape[0], -1, 4), idx)
        r = gather_rows(flatten_levels([bp], 4 * (reg_max + 1)), idx)
        boxes = _ltrb_boxes(anchor_centers(a), integral(r, reg_max) * st)
        boxes_all.append(clip_to(boxes, img_shape))
        scores_all.append(gather_rows(s, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.6)
