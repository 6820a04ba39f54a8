"""FSAF's head, centre-region masks, TBLR coder, online level selection,
loss and decode (counterpart of
``bonai_tpu/models/dense_heads/fsaf_head.py``: ``FSAFHead``,
``fsaf_level_masks``, ``fsaf_tblr_targets``, ``decode_tblr``,
``_iou_loss_cells``, ``fsaf_loss`` and ``fsaf_bboxes_single``, batched
over images here).

A cell inside a GT's centre region (``pos_scale`` of its sides) is
positive for it, the smallest-area GT owning a contested cell; the
regression is the cell centre's top, bottom, left and right distances to
the GT over ``stride * normalizer``.  Each GT trains on the one level where
its mean focal + IoU loss over its region, detached, is smallest.  Keys
are RetinaNet's (``bbox_head.{cls,reg}_convs.<i>.conv``, ``retina_cls``,
``retina_reg``), mmdetection v2.3's ``FSAFHead`` being a one-anchor
``RetinaHead``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..losses import sigmoid_focal_loss
from .retina_head import (BIAS_PRIOR, RetinaHead, clip_to, flatten_levels,
                          gather_rows, init_output, init_towers,
                          nms_detections, top_per_level)

BIG = 1e8


class FSAFHead(RetinaHead):
    """RetinaNet's towers and outputs at one anchor a cell, He-normal
    towers, and a ReLU on the TBLR distances; outputs float32."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 stacked_convs=4):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, num_anchors=1)

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        init_output(self.retina_cls, gen, BIAS_PRIOR)
        init_output(self.retina_reg, gen)

    def forward(self, feats):
        cls_scores, reg_preds = super().forward(feats)
        return ([c.float() for c in cls_scores],
                [F.relu(r).float() for r in reg_preds])


def _cell_centres(h, w, device):
    """Cell-centre coordinates ``(h,)`` and ``(w,)`` in cells."""
    return (torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=device) + 0.5)


def fsaf_level_masks(gt_bboxes, gt_valid, h, w, stride, pos_scale=0.2):
    """Per-GT centre-region membership ``in_pos`` ``(B, G, H, W)`` of one
    level, and each cell's owner ``(B, H, W)``, the smallest-area GT whose
    region holds it (the first of equals; -1 for none)."""
    cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    hw = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * pos_scale * 0.5
    hh = (gt_bboxes[..., 3] - gt_bboxes[..., 1]) * pos_scale * 0.5
    region = torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1) / stride
    ys, xs = _cell_centres(h, w, gt_bboxes.device)
    inx = (xs >= region[..., 0, None]) & (xs <= region[..., 2, None])
    iny = (ys >= region[..., 1, None]) & (ys <= region[..., 3, None])
    in_pos = iny[..., :, None] & inx[..., None, :] & gt_valid[..., None,
                                                              None]
    area = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) * \
        (gt_bboxes[..., 3] - gt_bboxes[..., 1])
    key = torch.where(in_pos, area[..., None, None], area.new_tensor(BIG))
    best, owner = key.min(dim=1)
    return in_pos, torch.where(best < BIG, owner, -1)


def fsaf_tblr_targets(gt_bboxes, h, w, stride, normalizer=4.0):
    """``(B, G, H, W, 4)`` top, bottom, left, right distances of every cell
    centre to every GT over ``stride * normalizer``."""
    ys, xs = _cell_centres(h, w, gt_bboxes.device)
    ys, xs = ys * stride, xs * stride
    g = gt_bboxes[..., None, None, :]
    shape = gt_bboxes.shape[:-1] + (h, w)
    t = (ys[:, None] - g[..., 1]).expand(shape)
    b = (g[..., 3] - ys[:, None]).expand(shape)
    left = (xs - g[..., 0]).expand(shape)
    r = (g[..., 2] - xs).expand(shape)
    return torch.stack([t, b, left, r], -1) / (stride * normalizer)


def decode_tblr(pred, h, w, stride, normalizer=4.0):
    """``(..., H, W, 4)`` TBLR predictions -> ``(..., H*W, 4)`` boxes."""
    ys, xs = _cell_centres(h, w, pred.device)
    ys, xs = ys * stride, xs * stride
    d = pred * (stride * normalizer)
    boxes = torch.stack([xs - d[..., 2], ys[:, None] - d[..., 0],
                         xs + d[..., 3], ys[:, None] + d[..., 1]], -1)
    return boxes.reshape(pred.shape[:-3] + (h * w, 4))


def iou_loss_cells(pred, tgt):
    """``1 - IoU`` of TBLR distance sets about a common centre,
    elementwise."""
    def area(d):
        return (d[..., 0] + d[..., 1]).clamp(min=0) * \
            (d[..., 2] + d[..., 3]).clamp(min=0)
    inter = (torch.minimum(pred[..., 0], tgt[..., 0])
             + torch.minimum(pred[..., 1], tgt[..., 1])).clamp(min=0) * \
        (torch.minimum(pred[..., 2], tgt[..., 2])
         + torch.minimum(pred[..., 3], tgt[..., 3])).clamp(min=0)
    union = (area(pred) + area(tgt) - inter).clamp(min=1e-6)
    return 1.0 - inter / union


def fsaf_targets(cls_scores, reg_preds, gt_bboxes, gt_valid, gt_labels,
                 num_classes, strides, pos_scale=0.2, normalizer=4.0,
                 gamma=2.0, alpha=0.25):
    """FSAF's per-level targets and online selection: each level's
    ``(in_pos, owner, tblr)`` and the selected level ``(B, G)`` of each GT,
    the first level of the smallest detached mean loss over its region."""
    g = gt_bboxes.shape[1]
    per_level, lvl_loss = [], []
    for cs, rp, s in zip(cls_scores, reg_preds, strides):
        h, w = cs.shape[2:]
        in_pos, owner = fsaf_level_masks(gt_bboxes, gt_valid, h, w, s,
                                         pos_scale)
        tblr = fsaf_tblr_targets(gt_bboxes, h, w, s, normalizer)
        with torch.no_grad():
            onehot = F.one_hot(gt_labels.long(), num_classes).float()
            focal = sigmoid_focal_loss(
                cs.detach().permute(0, 2, 3, 1)[:, None].expand(
                    -1, g, -1, -1, -1),
                onehot[:, :, None, None].expand(-1, -1, h, w, -1),
                gamma, alpha, reduction="none")             # (B,G,H,W,C)
            iou = iou_loss_cells(rp.detach().permute(0, 2, 3, 1)[:, None],
                                 tblr)                      # (B,G,H,W)
            zero = iou.new_zeros(())
            per_gt = (torch.where(in_pos[..., None], focal, zero).sum(
                (2, 3, 4)) + torch.where(in_pos, iou, zero).sum((2, 3)))
            n_cells = in_pos.sum((2, 3)).float().clamp(min=1.0)
            lvl_loss.append(per_gt / n_cells)
        per_level.append((in_pos, owner, tblr))
    sel = torch.stack(lvl_loss).argmin(dim=0)                # the first min
    return per_level, sel


def fsaf_loss(cls_scores, reg_preds, gt_bboxes, gt_valid, gt_labels,
              num_classes, strides, pos_scale=0.2, normalizer=4.0,
              gamma=2.0, alpha=0.25):
    """FSAF's losses of a batch: focal over every cell and the IoU loss
    over the active cells (owned by a GT on its selected level), both over
    the batch's active-cell count."""
    b, g = gt_bboxes.shape[:2]
    per_level, sel = fsaf_targets(
        cls_scores, reg_preds, gt_bboxes, gt_valid, gt_labels, num_classes,
        strides, pos_scale, normalizer, gamma, alpha)
    total_cls = total_reg = num_pos = 0.0
    for li, (cs, rp) in enumerate(zip(cls_scores, reg_preds)):
        in_pos, owner, tblr = per_level[li]
        active = in_pos & (sel == li)[..., None, None]      # (B, G, H, W)
        own = owner.clamp(min=0)
        active_cell = active.gather(1, own[:, None])[:, 0] & (owner >= 0)
        lab = gt_labels.long().gather(1, own.flatten(1)).reshape(own.shape)
        onehot = F.one_hot(lab, num_classes).float() * active_cell[..., None]
        focal = sigmoid_focal_loss(cs.permute(0, 2, 3, 1), onehot, gamma,
                                   alpha, reduction="none")
        total_cls = total_cls + focal.sum()
        tgt = tblr.gather(1, own[:, None, ..., None].expand(
            -1, 1, -1, -1, 4))[:, 0]
        iou = iou_loss_cells(rp.permute(0, 2, 3, 1), tgt)
        total_reg = total_reg + torch.where(active_cell, iou,
                                            iou.new_zeros(())).sum()
        num_pos = num_pos + active_cell.sum()
    denom = torch.as_tensor(num_pos).float().clamp(min=1.0)
    return {"loss_cls": total_cls / denom, "loss_bbox": total_reg / denom}


def fsaf_bboxes(cls_scores, reg_preds, img_shape, num_classes, strides, cfg,
                normalizer=4.0):
    """Detections of a batch: per level the decoded boxes (clipped to
    ``img_shape`` ``(B, 2)``) of the ``nms_pre`` cells of the highest class
    score, then multi-class NMS over the levels."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, rp, s in zip(cls_scores, reg_preds, strides):
        h, w = cs.shape[2:]
        sc = torch.sigmoid(flatten_levels([cs], num_classes))
        boxes = clip_to(decode_tblr(rp.permute(0, 2, 3, 1).float(), h, w, s,
                                    normalizer), img_shape)
        idx = top_per_level(sc.max(dim=-1).values, min(nms_pre, sc.shape[1]))
        boxes_all.append(gather_rows(boxes, idx))
        scores_all.append(gather_rows(sc, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
