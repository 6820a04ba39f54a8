"""FCOS's head, point grid, targets, loss and decode (counterpart of
``bonai_tpu/models/dense_heads/fcos_head.py``: ``FCOSHead``,
``fcos_points``, ``fcos_targets``, ``fcos_loss`` and
``fcos_bboxes_single``, batched over images here).

A point is positive for the smallest-area GT containing it (with centre
sampling: inside the GT and within ``radius * stride`` of its centre)
whose largest side distance falls in the point's level range; padded GTs
never win.  The reg branch is ``exp(scale * x)`` or, with
``norm_on_bbox``, ``relu(scale * x) * stride``: pixel distances for
training and test alike.  Keys are mmdetection v2.3's
(``bbox_head.cls_convs.<i>.{conv,gn}``, ``fcos_cls``, ``fcos_reg``,
``fcos_centerness``, ``scales.<l>.scale``).  With ``dcn_on_last_conv``
each tower's last conv is a modulated deformable conv (mmcv's
``ModulatedDeformConv2dPack``, no bias: ``cls_convs.<n>.conv.weight`` and
``.conv.conv_offset``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import ModulatedDeformConv2dPack
from ..losses import (GIoULoss, IoULoss, binary_cross_entropy,
                      sigmoid_focal_loss)
from .atss_head import _centerness
from .retina_head import (BIAS_PRIOR, Scale, clip_to, flatten_levels,
                          gather_rows, init_output, init_towers,
                          nms_detections, top_per_level, towers)

INF = 1e8


class FCOSHead(nn.Module):
    """cls and reg towers of ``stacked_convs`` conv-GN(32)-ReLUs (conv-ReLUs
    without ``use_gn``), then 3x3 convs to ``C`` logits, 4 distances and
    1 centerness logit (on the cls tower, or the reg tower with
    ``centerness_on_reg``); outputs float32.  ``dcn_on_last_conv`` makes
    each tower's last conv a modulated deformable one."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_levels=5, centerness_on_reg=False,
                 norm_on_bbox=False, strides=(8, 16, 32, 64, 128),
                 use_gn=True, dcn_on_last_conv=False):
        super().__init__()
        self.num_classes = num_classes
        self.centerness_on_reg = centerness_on_reg
        self.norm_on_bbox = norm_on_bbox
        self.strides = tuple(strides)
        self.cls_convs, self.reg_convs = towers(in_channels, feat_channels,
                                                stacked_convs,
                                                32 if use_gn else None)
        if dcn_on_last_conv:
            for tower in (self.cls_convs, self.reg_convs):
                tower[-1].conv = ModulatedDeformConv2dPack(
                    in_channels if stacked_convs == 1 else feat_channels,
                    feat_channels)
        self.fcos_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.fcos_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        init_output(self.fcos_cls, gen, BIAS_PRIOR)
        init_output(self.fcos_reg, gen)
        init_output(self.fcos_centerness, gen)

    def forward(self, feats):
        cls_out, reg_out, ctr_out = [], [], []
        for x, scale, stride in zip(feats, self.scales, self.strides):
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.fcos_cls(c).float())
            ctr_out.append(self.fcos_centerness(
                r if self.centerness_on_reg else c).float())
            reg = scale(self.fcos_reg(r).float())
            reg_out.append(F.relu(reg) * float(stride) if self.norm_on_bbox
                           else torch.exp(reg))
        return cls_out, reg_out, ctr_out


def fcos_points(featmap_sizes, strides):
    """Per-level ``(H*W, 2)`` float32 points at ``x * stride + stride //
    2``, row-major."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        xs = np.arange(w, dtype=np.float32) * s + s // 2
        ys = np.arange(h, dtype=np.float32) * s + s // 2
        gx, gy = np.meshgrid(xs, ys)
        out.append(np.stack([gx.ravel(), gy.ravel()], -1))
    return out


def fcos_targets(points, regress_ranges, gt_bboxes, gt_valid, gt_labels,
                 num_classes, strides=None, center_sample_radius=0.0):
    """FCOS targets of a batch over the ``(P, 2)`` points with their
    ``(P, 2)`` level ranges (and ``(P,)`` strides for centre sampling):
    labels ``(B, P)`` (``num_classes`` for negatives), side distances
    ``(B, P, 4)`` (l, t, r, b) to the chosen GT and centerness targets
    ``(B, P)``."""
    gt = gt_bboxes.float()[:, None]                          # (B, 1, G, 4)
    xs = points[:, 0][None, :, None]
    ys = points[:, 1][None, :, None]
    ltrb = torch.stack([xs - gt[..., 0], ys - gt[..., 1], gt[..., 2] - xs,
                        gt[..., 3] - ys], dim=-1)            # (B, P, G, 4)
    inside = ltrb.amin(-1) > 0
    if center_sample_radius > 0.0 and strides is not None:
        cx = (gt[..., 0] + gt[..., 2]) * 0.5
        cy = (gt[..., 1] + gt[..., 3]) * 0.5
        r = strides[None, :, None] * center_sample_radius
        x1 = torch.maximum(cx - r, gt[..., 0])
        y1 = torch.maximum(cy - r, gt[..., 1])
        x2 = torch.minimum(cx + r, gt[..., 2])
        y2 = torch.minimum(cy + r, gt[..., 3])
        inside = (xs > x1) & (xs < x2) & (ys > y1) & (ys < y2) & inside
    max_dist = ltrb.amax(-1)
    in_range = (max_dist >= regress_ranges[None, :, None, 0]) & \
        (max_dist <= regress_ranges[None, :, None, 1])
    areas = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))
    areas = torch.where(inside & in_range & gt_valid[:, None],
                        areas.expand_as(max_dist), INF)
    min_area, min_idx = areas.min(dim=-1)       # the first minimum
    labels = torch.where(min_area < INF,
                         gt_labels.long().gather(1, min_idx), num_classes)
    tgt = ltrb.gather(2, min_idx[..., None, None].expand(-1, -1, 1, 4))[
        :, :, 0]
    ctr = _centerness(tgt[..., 0], tgt[..., 1], tgt[..., 2], tgt[..., 3])
    return labels, tgt, ctr


def _decode_ltrb(points, dists):
    return torch.stack([points[..., 0] - dists[..., 0],
                        points[..., 1] - dists[..., 1],
                        points[..., 0] + dists[..., 2],
                        points[..., 1] + dists[..., 3]], dim=-1)


def fcos_loss(cls_scores, bbox_preds, centernesses, points, ranges,
              gt_bboxes, gt_valid, gt_labels, num_classes, gamma=2.0,
              alpha=0.25, strides=None, center_sample_radius=0.0,
              bbox_loss_mode="iou"):
    """FCOS's losses of a batch over the ``(P, 2)`` concatenated points:
    focal over every point and BCE centerness over the positives, both
    over the positive count; ``-log IoU`` (or ``1 - GIoU``) of the decoded
    boxes over the positives, weighted by their centerness targets and
    over the targets' sum."""
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4)
    ctr_flat = flatten_levels(centernesses, 1)[..., 0]
    labels, tgt, ctr_t = fcos_targets(points, ranges, gt_bboxes, gt_valid,
                                      gt_labels, num_classes, strides,
                                      center_sample_radius)
    pos = labels < num_classes
    num_pos = pos.sum().float().clamp(min=1.0)
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    loss_cls = sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                  avg_factor=num_pos)
    box_loss = GIoULoss if bbox_loss_mode == "giou" else IoULoss
    loss_bbox = box_loss(eps=1e-6)(_decode_ltrb(points, reg_flat),
                                   _decode_ltrb(points, tgt), ctr_t * pos)
    loss_ctr = binary_cross_entropy(ctr_flat, ctr_t, pos.float(),
                                    avg_factor=num_pos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_centerness": loss_ctr}


def fcos_bboxes(cls_scores, bbox_preds, centernesses, points_levels,
                img_shape, num_classes, cfg):
    """Detections of a batch: per level the ``nms_pre`` points of the
    highest class score times centerness, their boxes clipped to
    ``img_shape`` ``(B, 2)``, then multi-class NMS over the levels with the
    centerness as a score factor."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, bp, cn, pts in zip(cls_scores, bbox_preds, centernesses,
                               points_levels):
        s = torch.sigmoid(flatten_levels([cs], num_classes))
        n = torch.sigmoid(flatten_levels([cn], 1))
        idx = top_per_level(s.max(dim=-1).values * n[..., 0],
                            min(nms_pre, s.shape[1]))
        p = gather_rows(pts.expand(s.shape[0], -1, 2), idx)
        boxes = _decode_ltrb(p, gather_rows(flatten_levels([bp], 4), idx))
        boxes_all.append(clip_to(boxes, img_shape))
        scores_all.append(gather_rows(s, idx) * gather_rows(n, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
