"""RPN head, proposal generation, targets and loss (counterpart of
``bonai_tpu/models/dense_heads/rpn_head.py``: ``RPNHead``,
``rpn_proposals_single``, ``rpn_targets`` and ``rpn_loss``, batched over
images here)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign
from ...core.boxes import bbox2delta, clip_boxes, delta2bbox
from ...core.nms import nms
from ...core.samplers import random_sample
from ..init import normal_, zeros_
from ..losses import binary_cross_entropy, l1_loss


class RPNHead(nn.Module):
    """3x3 conv + relu, then 1x1 objectness (A) and 1x1 deltas (A*4)."""

    def __init__(self, in_channels=256, feat_channels=256, num_anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def init_weights(self, gen):
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_(m.weight, 0.01, gen)
            zeros_(m.bias)

    def forward(self, feats):
        """NCHW levels -> per-level ``(B, A, H, W)`` and ``(B, A*4, H, W)``."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t))
            bbox_preds.append(self.rpn_reg(t))
        return cls_scores, bbox_preds


def rpn_proposals(cls_scores, bbox_preds, anchors_levels, img_shape, cfg):
    """Proposals for a batch of images.

    Per image and level: top ``nms_pre`` anchors by sigmoid score, decode,
    clip to ``img_shape`` ``(B, 2)`` (h, w), hard NMS at ``nms_thr``; then
    the top ``max_num`` over all levels.  Returns ``(B, max_num, 4)``
    boxes, ``(B, max_num)`` scores and a bool valid mask.
    """
    nms_pre = cfg.get("nms_pre", 1000)
    max_num = cfg.get("max_num", cfg.get("nms_post", 1000))
    nms_thr = cfg.get("nms_thr", 0.7)
    min_bbox_size = cfg.get("min_bbox_size", 0)
    b = cls_scores[0].shape[0]
    hw = (img_shape[:, 0:1].float(), img_shape[:, 1:2].float())
    level_boxes, level_scores, level_valid = [], [], []
    for scores, deltas, anchors in zip(cls_scores, bbox_preds,
                                       anchors_levels):
        # (B, A, H, W) -> (B, H*W*A): the anchors' (y, x, a) order
        s = torch.sigmoid(scores.permute(0, 2, 3, 1).reshape(b, -1).float())
        d = deltas.permute(0, 2, 3, 1).reshape(b, -1, 4).float()
        if s.shape[1] > nms_pre:
            s, idx = torch.sort(s, dim=1, descending=True, stable=True)
            s, idx = s[:, :nms_pre], idx[:, :nms_pre]
            d = d.gather(1, idx[..., None].expand(b, nms_pre, 4))
            a = anchors[idx]
        else:
            a = anchors.expand(b, -1, 4)
        boxes = clip_boxes(delta2bbox(a, d), hw)
        valid = torch.ones_like(s, dtype=torch.bool)
        if min_bbox_size > 0:
            valid = ((boxes[..., 2] - boxes[..., 0] > min_bbox_size)
                     & (boxes[..., 3] - boxes[..., 1] > min_bbox_size))
        level_boxes.append(boxes)
        level_scores.append(s)
        level_valid.append(valid)

    # one NMS over all levels: each level is its own padded problem
    sizes = [s.shape[1] for s in level_scores]
    m = max(sizes)

    def stack(xs, value):
        return torch.stack([F.pad(x, (0, 0) * (x.dim() - 2) + (0, m - x.shape[1]),
                                  value=value) for x in xs], dim=1)

    keep = nms(stack(level_boxes, 0.0), stack(level_scores, 0.0), nms_thr,
               valid=stack(level_valid, False))
    all_boxes = torch.cat(level_boxes, dim=1)
    all_scores = torch.cat(
        [torch.where(keep[:, i, :n], s, torch.zeros_like(s))
         for i, (n, s) in enumerate(zip(sizes, level_scores))], dim=1)
    k = min(max_num, all_scores.shape[1])
    top_scores, top_idx = torch.sort(all_scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = all_boxes.gather(1, top_idx[..., None].expand(b, k, 4))
    if k < max_num:
        top_boxes = F.pad(top_boxes, (0, 0, 0, max_num - k))
        top_scores = F.pad(top_scores, (0, max_num - k))
    return top_boxes, top_scores, top_scores > 0


def _flatten(cls_scores, bbox_preds):
    """Per-level ``(B, A, H, W)`` / ``(B, A*4, H, W)`` -> float32
    ``(B, N)`` / ``(B, N, 4)`` in the anchors' ``(level, y, x, a)``
    order."""
    b = cls_scores[0].shape[0]
    cls = torch.cat([s.permute(0, 2, 3, 1).reshape(b, -1)
                     for s in cls_scores], dim=1).float()
    reg = torch.cat([r.permute(0, 2, 3, 1).reshape(b, -1, 4)
                     for r in bbox_preds], dim=1).float()
    return cls, reg


def rpn_targets(anchors, gt_bboxes, gt_valid, u_pos, u_neg, assigner_cfg,
                sampler_cfg):
    """RPN targets of a batch over the flattened ``(N, 4)`` anchors, or
    each image's own ``(B, N, 4)`` (Guided Anchoring's).

    ``gt_bboxes`` ``(B, G, 4)``, ``gt_valid`` ``(B, G)``; ``u_pos``/
    ``u_neg`` ``(B, N)`` the sampler's uniforms.  Returns ``labels``,
    ``label_weights`` ``(B, N)``, ``bbox_targets``, ``bbox_weights``
    ``(B, N, 4)`` and ``num_samples`` ``(B,)``.
    """
    assigned, _ = max_iou_assign(
        anchors, gt_bboxes, gt_valid,
        pos_iou_thr=assigner_cfg.get("pos_iou_thr", 0.7),
        neg_iou_thr=assigner_cfg.get("neg_iou_thr", 0.3),
        min_pos_iou=assigner_cfg.get("min_pos_iou", 0.3),
        match_low_quality=assigner_cfg.get("match_low_quality", True))
    res = random_sample(assigned, sampler_cfg.get("num", 256),
                        sampler_cfg.get("pos_fraction", 0.5), u_pos, u_neg,
                        sampler_cfg.get("neg_pos_ub", -1))
    b, n = assigned.shape
    inds = res["inds"]
    pos = res["is_pos"].float()
    valid = res["valid"].float()
    # a candidate is sampled at most once (padded slots add zeros)
    labels = anchors.new_zeros((b, n)).scatter_add_(1, inds, pos)
    label_weights = anchors.new_zeros((b, n)).scatter_add_(1, inds, valid)
    matched = gt_bboxes.gather(
        1, res["pos_gt_inds"][..., None].expand(-1, -1, 4))
    sampled = anchors[inds] if anchors.dim() == 2 else anchors.gather(
        1, inds[..., None].expand(-1, -1, 4))
    deltas = bbox2delta(sampled, matched)
    idx4 = inds[..., None].expand(-1, -1, 4)
    w = pos[..., None]
    bbox_targets = anchors.new_zeros((b, n, 4)).scatter_add_(1, idx4,
                                                             deltas * w)
    bbox_weights = anchors.new_zeros((b, n, 4)).scatter_add_(
        1, idx4, w.expand(-1, -1, 4))
    return labels, label_weights, bbox_targets, bbox_weights, valid.sum(1)


def rpn_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_valid, draw,
             train_cfg, reg_weight=None):
    """RPN losses of a batch: sigmoid cross-entropy over the sampled
    anchors and L1 over the positive ones, both averaged over all sampled
    anchors of the batch.

    ``cls_scores``/``bbox_preds`` are the head's per-level outputs,
    ``anchors`` the ``(N, 4)`` concatenated level anchors, ``draw`` the
    sampler's draw source (:func:`~bonai_tpu_torch.core.samplers
    .generator_draws`).  ``reg_weight`` ``(B,)`` scales each image's
    regression weights (``SemiRPNHead``: 0 for a footprint-only image)."""
    cls, reg = _flatten(cls_scores, bbox_preds)
    u_pos, u_neg = draw(cls.shape, cls.device)
    labels, lw, bt, bw, ns = rpn_targets(
        anchors, gt_bboxes, gt_valid, u_pos, u_neg,
        dict(train_cfg["assigner"]), dict(train_cfg["sampler"]))
    num_total = ns.sum().clamp(min=1.0)
    if reg_weight is not None:
        bw = bw * reg_weight[:, None, None]
    return {"loss_rpn_cls": binary_cross_entropy(cls, labels, lw,
                                                 avg_factor=num_total),
            "loss_rpn_bbox": l1_loss(reg, bt, bw, avg_factor=num_total)}
