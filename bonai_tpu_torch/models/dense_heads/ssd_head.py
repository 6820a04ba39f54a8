"""SSD's head, targets, loss and decode (counterpart of
``bonai_tpu/models/dense_heads/ssd_head.py``: ``SSDHead``,
``ssd_targets``, ``ssd_loss`` and ``ssd_bboxes_single``, batched over
images here).

The head is a 3x3 conv pair a level (``A * (C + 1)`` logits, background
last, and ``A * 4`` deltas), the levels differing in channels and anchors.
The loss: max-IoU targets over all anchors, softmax cross-entropy over
the positives and the hardest negatives (``neg_pos_ratio`` to one an
image, ranked by their loss with a stable double argsort, so exact ties
go to the lower anchor index as in JAX: the padded area's anchors tie
exactly), and smooth L1 on the positives' deltas, both over the batch's
positive count.  PISA's ISR-P and CARL apply with ``train_cfg.isr`` /
``carl`` (``configs/pisa/pisa_ssd*``).  Decoding: softmax, the
``nms_pre`` anchors of the highest foreground score a level, then
multi-class NMS.

Keys are mmdetection v2.3's: ``bbox_head.cls_convs.<i>``,
``bbox_head.reg_convs.<i>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign
from ...core.boxes import bbox2delta, delta2bbox
from ...core.nms import multiclass_nms
from ..init import xavier_uniform_, zeros_
from ..losses import carl_loss, isr_p, smooth_l1_loss
from .retina_head import clip_to, flatten_levels, gather_rows, top_per_level


class SSDHead(nn.Module):
    def __init__(self, num_classes=80,
                 in_channels=(512, 1024, 512, 256, 256, 256),
                 num_anchors=(4, 6, 6, 6, 4, 4)):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = nn.ModuleList(
            [nn.Conv2d(c, a * (num_classes + 1), 3, padding=1)
             for c, a in zip(in_channels, num_anchors)])
        self.reg_convs = nn.ModuleList(
            [nn.Conv2d(c, a * 4, 3, padding=1)
             for c, a in zip(in_channels, num_anchors)])

    def init_weights(self, gen):
        for conv in [*self.cls_convs, *self.reg_convs]:
            xavier_uniform_(conv.weight, gen)
            zeros_(conv.bias)

    def forward(self, feats):
        return ([conv(x) for conv, x in zip(self.cls_convs, feats)],
                [conv(x) for conv, x in zip(self.reg_convs, feats)])


def ssd_targets(anchors, gt_bboxes, gt_valid, gt_labels, num_classes,
                assigner_cfg, target_stds, legacy=False):
    """Targets of a batch over the ``(A, 4)`` anchors: labels ``(B, A)``
    (``num_classes`` for background), classification weights (0 for the
    ignored), delta targets and weights ``(B, A, 4)``, ``is_pos``, the
    matched GT index and its box."""
    assigned, _ = max_iou_assign(
        anchors, gt_bboxes, gt_valid,
        pos_iou_thr=assigner_cfg.get("pos_iou_thr", 0.5),
        neg_iou_thr=assigner_cfg.get("neg_iou_thr", 0.5),
        min_pos_iou=assigner_cfg.get("min_pos_iou", 0.0),
        match_low_quality=assigner_cfg.get("match_low_quality", True))
    is_pos = assigned > 0
    matched = (assigned - 1).clamp(min=0)
    labels = torch.where(is_pos, gt_labels.long().gather(1, matched),
                         num_classes)
    cls_w = (assigned >= 0).float()
    gt_boxes = gather_rows(gt_bboxes.float(), matched)
    deltas = bbox2delta(anchors, gt_boxes, stds=target_stds, legacy=legacy)
    reg_w = is_pos.float()[..., None]
    return (labels, cls_w, deltas * reg_w, reg_w.expand_as(deltas), is_pos,
            matched, gt_boxes)


def _pisa(cls_flat, reg_flat, ce, anchors, labels, cls_w, bt, bw, is_pos,
          matched, gt_boxes, num_classes, total_pos, pisa_cfg, target_stds,
          legacy, g):
    """ISR-P's classification weights and the CARL loss on SSD's softmax
    targets (``{}`` without ``carl``)."""
    b, a = ce.shape
    pos_f = is_pos.reshape(-1)
    labels_f = labels.reshape(-1)
    extra = {}
    isr = dict(pisa_cfg.get("isr") or {})
    if isr:
        with torch.no_grad():
            dec = delta2bbox(anchors, reg_flat.detach(), stds=target_stds,
                             legacy=legacy)
            inter = ((torch.minimum(dec[..., 2], gt_boxes[..., 2])
                      - torch.maximum(dec[..., 0], gt_boxes[..., 0])).clamp(
                          min=0)
                     * (torch.minimum(dec[..., 3], gt_boxes[..., 3])
                        - torch.maximum(dec[..., 1], gt_boxes[..., 1])).clamp(
                            min=0))

            def area(v):
                return (v[..., 2] - v[..., 0]).clamp(min=0) * \
                    (v[..., 3] - v[..., 1]).clamp(min=0)
            ious = inter / (area(dec) + area(gt_boxes) - inter).clamp(
                min=1e-6)
            matched_f = (matched + torch.arange(
                b, device=ce.device)[:, None] * g).reshape(-1)
            cls_w = isr_p(cls_w.reshape(-1), ious.reshape(-1), pos_f,
                          labels_f, matched_f,
                          torch.where(pos_f, ce.detach().reshape(-1), 0.0),
                          k=isr.get("k", 2.0),
                          bias=isr.get("bias", 0.0)).reshape(b, a)
    carl = dict(pisa_cfg.get("carl") or {})
    if carl:
        prob = torch.softmax(cls_flat, -1).reshape(-1, num_classes + 1)
        pos_prob = prob.gather(1, labels_f.clamp(0, num_classes)[:, None])[
            :, 0]
        reg_raw = ((reg_flat - bt).abs() * bw).reshape(-1, 4)
        extra["loss_carl"] = carl.get("loss_weight", 5.0) * carl_loss(
            pos_prob, pos_f, reg_raw, k=carl.get("k", 1.0),
            bias=carl.get("bias", 0.2), avg_factor=total_pos)
    return cls_w, extra


def hard_negatives(ce, is_pos, cls_w, ratio):
    """The negatives mined for the loss ``(B, A)``: per image those of
    loss rank below ``min(ratio * positives, negatives)``, ranked by a
    stable descending sort (exact ties to the lower index)."""
    neg_ce = torch.where(is_pos, ce.new_tensor(float("-inf")), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True).float()
    npos = is_pos.sum(1).float()
    nneg = ((~is_pos) & (cls_w > 0)).sum(1).float()
    k = torch.minimum(ratio * npos, nneg)
    return (rank < k[:, None]) & ~is_pos


def ssd_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_valid,
             gt_labels, num_classes, train_cfg,
             target_stds=(0.1, 0.1, 0.2, 0.2), pisa_cfg=None, legacy=False):
    """SSD's MultiBox losses of a batch over the ``(A, 4)`` concatenated
    anchors (``pisa_cfg``: ``dict(isr=..., carl=...)``)."""
    cls_flat = flatten_levels(cls_scores, num_classes + 1)
    reg_flat = flatten_levels(bbox_preds, 4)
    labels, cls_w, bt, bw, is_pos, matched, gt_boxes = ssd_targets(
        anchors, gt_bboxes, gt_valid, gt_labels, num_classes,
        dict(train_cfg.get("assigner", {})), target_stds, legacy)
    total_pos = is_pos.sum().float().clamp(min=1.0)
    ce = -F.log_softmax(cls_flat, -1).gather(2, labels[..., None])[..., 0]
    extra = {}
    if pisa_cfg:
        cls_w, extra = _pisa(cls_flat, reg_flat, ce, anchors, labels, cls_w,
                             bt, bw, is_pos, matched, gt_boxes, num_classes,
                             total_pos, pisa_cfg, target_stds, legacy,
                             gt_bboxes.shape[1])
    ce = ce * cls_w
    keep_neg = hard_negatives(ce.detach(), is_pos, cls_w,
                              float(train_cfg.get("neg_pos_ratio", 3)))
    loss_cls = torch.where(is_pos | keep_neg, ce,
                           ce.new_zeros(())).sum() / total_pos
    loss_bbox = smooth_l1_loss(reg_flat, bt,
                               float(train_cfg.get("smoothl1_beta", 1.0)),
                               bw, avg_factor=total_pos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, **extra}


def ssd_bboxes(cls_scores, bbox_preds, anchors_levels, img_shape,
               num_classes, cfg, target_stds=(0.1, 0.1, 0.2, 0.2),
               legacy=False):
    """Detections of a batch: per level the softmax scores (background
    last) of the ``nms_pre`` anchors of the highest foreground score,
    their boxes decoded and clipped to ``img_shape`` ``(B, 2)``, then
    multi-class NMS over the levels."""
    nms_pre = cfg.get("nms_pre", 1000)
    boxes_all, scores_all = [], []
    for scores, deltas, anchors in zip(cls_scores, bbox_preds,
                                       anchors_levels):
        s = torch.softmax(flatten_levels([scores], num_classes + 1), -1)
        d = flatten_levels([deltas], 4)
        a = anchors.expand(s.shape[0], -1, 4)
        if s.shape[1] > nms_pre:
            idx = top_per_level(s[..., :num_classes].max(dim=-1).values,
                                nms_pre)
            s, d, a = (gather_rows(x, idx) for x in (s, d, a))
        boxes_all.append(clip_to(delta2bbox(a, d, stds=target_stds,
                                            legacy=legacy), img_shape))
        scores_all.append(s)
    return multiclass_nms(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg.get("score_thr", 0.02),
                          dict(cfg.get("nms", dict(type="nms",
                                                   iou_threshold=0.45))),
                          cfg.get("max_per_img", 200))
