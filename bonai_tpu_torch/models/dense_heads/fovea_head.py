"""FoveaBox's head, targets, loss and decode (counterpart of
``bonai_tpu/models/dense_heads/fovea_head.py``: ``FoveaHead``,
``fovea_targets_level``, ``fovea_loss`` and ``fovea_bboxes_single``,
batched over images here).

Per level, the GTs whose ``sqrt(area)`` falls in the level's scale range
label the ``sigma``-shrunk "fovea" of their box (cells from ``ceil`` to
``floor`` of the shrunk edges less half a cell), the smallest-area GT
winning a contested cell; the targets are ``log`` of the cell corner's
side distances over the level's base edge, clipped to ``[1/16, 16]``.
Keys are mmdetection v2.3's (``bbox_head.{cls,reg}_convs.<i>.conv``,
``conv_cls``, ``conv_reg``).  ``with_deform`` (the COCO ``fovea_align``
configs' feature alignment) raises, naming ROADMAP.md item A6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..losses import sigmoid_focal_loss, smooth_l1_loss
from .retina_head import (BIAS_PRIOR, clip_to, flatten_levels, gather_rows,
                          init_output, init_towers, nms_detections,
                          top_per_level, towers)


class FoveaHead(nn.Module):
    """Two towers of ``stacked_convs`` 3x3 conv-ReLUs (conv-GN(32)-ReLUs
    with ``use_gn``), then a 3x3 conv to ``C`` logits and one to the 4 log
    distances; outputs float32."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 stacked_convs=4, use_gn=False):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs, self.reg_convs = towers(
            in_channels, feat_channels, stacked_convs,
            min(32, feat_channels) if use_gn else None)
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        init_output(self.conv_cls, gen, BIAS_PRIOR)
        init_output(self.conv_reg, gen)

    def forward(self, feats):
        cls_out, reg_out = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            reg_out.append(self.conv_reg(r).float())
            cls_out.append(self.conv_cls(c).float())
        return cls_out, reg_out


def _corners(h, w, stride, device):
    """Each cell's top-left corner ``(y, x)`` in pixels, ``(h, 1)`` and
    ``(w,)``."""
    return (torch.arange(h, dtype=torch.float32, device=device)[:, None]
            * stride,
            torch.arange(w, dtype=torch.float32, device=device) * stride)


def fovea_targets_level(gt_bboxes, gt_valid, gt_labels, h, w, stride,
                        base_len, bounds, sigma, num_classes):
    """One level's targets of a batch: labels ``(B, h*w)``
    (``num_classes`` for negatives), log targets ``(B, h*w, 4)`` (0 on
    negatives) and the positive mask."""
    lower, upper = bounds
    areas = torch.sqrt(((gt_bboxes[..., 2] - gt_bboxes[..., 0])
                        * (gt_bboxes[..., 3] - gt_bboxes[..., 1])).clamp(
                            min=0))
    hit = gt_valid & (areas >= lower) & (areas <= upper)
    gb = gt_bboxes / stride
    half_w = 0.5 * (gb[..., 2] - gb[..., 0])
    half_h = 0.5 * (gb[..., 3] - gb[..., 1])
    pl = torch.ceil(gb[..., 0] + (1 - sigma) * half_w - 0.5).clamp(0, w - 1)
    pr = torch.floor(gb[..., 0] + (1 + sigma) * half_w - 0.5).clamp(0, w - 1)
    pt = torch.ceil(gb[..., 1] + (1 - sigma) * half_h - 0.5).clamp(0, h - 1)
    pd = torch.floor(gb[..., 1] + (1 + sigma) * half_h - 0.5).clamp(0, h - 1)
    iy = torch.arange(h, dtype=torch.float32, device=gt_bboxes.device)
    ix = torch.arange(w, dtype=torch.float32, device=gt_bboxes.device)
    e = (slice(None), None, None, slice(None))              # (B, 1, 1, G)
    inside = ((ix[:, None] >= pl[e]) & (ix[:, None] <= pr[e])
              & (iy[:, None, None] >= pt[e]) & (iy[:, None, None] <= pd[e])
              & hit[e])                                     # (B, h, w, G)
    key = torch.where(inside, areas[e], areas.new_tensor(float("inf")))
    best = key.argmin(dim=-1)                               # the first min
    any_hit = inside.any(dim=-1)
    labels = torch.where(any_hit, gt_labels.long().gather(
        1, best.flatten(1)).reshape(best.shape), num_classes)
    gsel = gather_rows(gt_bboxes.float(), best.flatten(1)).reshape(
        best.shape + (4,))                                  # (B, h, w, 4)
    py, px = _corners(h, w, stride, gt_bboxes.device)
    t = torch.stack([(px - gsel[..., 0]) / base_len,
                     (py - gsel[..., 1]) / base_len,
                     (gsel[..., 2] - px) / base_len,
                     (gsel[..., 3] - py) / base_len], -1)
    t = torch.log(t.clamp(1.0 / 16, 16.0))
    t = torch.where(any_hit[..., None], t, t.new_zeros(()))
    b = gt_bboxes.shape[0]
    return labels.reshape(b, -1), t.reshape(b, -1, 4), any_hit.reshape(b, -1)


def fovea_loss(cls_scores, bbox_preds, gt_bboxes, gt_valid, gt_labels,
               num_classes, strides=(8, 16, 32, 64, 128),
               base_edge_list=(16, 32, 64, 128, 256),
               scale_ranges=((8, 32), (16, 64), (32, 128), (64, 256),
                             (128, 512)),
               sigma=0.4, gamma=2.0, alpha=0.25, bbox_beta=0.11,
               loss_bbox_weight=1.0):
    """FoveaBox's losses of a batch: focal over every cell over the
    positive count plus the batch size, smooth L1 of the log targets over
    four times the positive count."""
    b = gt_bboxes.shape[0]
    targets = [fovea_targets_level(gt_bboxes, gt_valid, gt_labels,
                                   cs.shape[2], cs.shape[3], float(st),
                                   float(bl), bounds, sigma, num_classes)
               for cs, st, bl, bounds in zip(cls_scores, strides,
                                             base_edge_list, scale_ranges)]
    labels, tgt, pos = (torch.cat(x, 1) for x in zip(*targets))
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4)
    num_pos = pos.sum().float()
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    loss_cls = sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                  avg_factor=num_pos + b)
    w = pos[..., None].float().expand_as(tgt)
    loss_bbox = loss_bbox_weight * smooth_l1_loss(
        reg_flat, tgt, bbox_beta, w, avg_factor=num_pos.clamp(min=1.0) * 4)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}


def fovea_bboxes(cls_scores, bbox_preds, img_shape, num_classes, cfg,
                 strides=(8, 16, 32, 64, 128),
                 base_edge_list=(16, 32, 64, 128, 256)):
    """Detections of a batch: per level the ``nms_pre`` cells of the
    highest class score, each cell corner's box ``exp`` of its predicted
    log distances times the base edge (clipped to ``img_shape`` ``(B,
    2)``), then multi-class NMS over the levels."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, bp, st, bl in zip(cls_scores, bbox_preds, strides,
                              base_edge_list):
        h, w = cs.shape[2:]
        s = torch.sigmoid(flatten_levels([cs], num_classes))
        t = torch.exp(flatten_levels([bp], 4))
        py, px = _corners(h, w, float(st), cs.device)
        px, py = px.expand(h, w).reshape(-1), py.expand(h, w).reshape(-1)
        boxes = clip_to(torch.stack([px - bl * t[..., 0], py - bl * t[..., 1],
                                     px + bl * t[..., 2],
                                     py + bl * t[..., 3]], -1), img_shape)
        idx = top_per_level(s.max(dim=-1).values, min(nms_pre, s.shape[1]))
        boxes_all.append(gather_rows(boxes, idx))
        scores_all.append(gather_rows(s, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
