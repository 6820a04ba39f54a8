"""RepPoints' head, point transforms, assigner, loss and decode (counterpart
of ``bonai_tpu/models/dense_heads/reppoints_head.py``: ``RepPointsHead``,
``_gen_grid_from_reg``, ``points2bbox{,_moment}``, ``point_assign``,
``reppoints_loss`` and ``reppoints_bboxes_single``, batched over images
here).

Per level the head predicts ``num_points`` (y, x) offsets twice: an init
set from a plain conv, and a refine set from a deformable conv whose
sampling offsets are the init points (their gradient scaled by
``gradient_mul``) less the kernel's base grid.  A point set becomes a box
by the ``moment`` (mean +- std times a learned scale), ``minmax`` or
``partial_minmax`` transform; with ``use_grid_points`` the head regresses
a box and samples a ``k x k`` grid over it.  The init stage trains on the
point assigner (or, with a ``MaxIoUAssigner`` init, on max-IoU of
``point_base_scale`` squares), the refine stage and the classification on
max-IoU of the init boxes.

Point sets are y-first channel pairs, which is mmcv's offset layout, so
``init points - base`` is the deformable conv's offset as it is.  Keys
are mmdetection v2.3's (``bbox_head.{cls,reg}_convs.<i>.{conv,gn}``,
``reppoints_cls_conv``, ``reppoints_cls_out``,
``reppoints_pts_init_{conv,out}``, ``reppoints_pts_refine_{conv,out}``,
``moment_transfer``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign
from ...ops.deform_conv import DeformConv2d
from ..init import normal_, zeros_
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from .retina_head import (BIAS_PRIOR, clip_to, flatten_levels, gather_rows,
                          init_output, init_towers, nms_detections,
                          top_per_level, towers)


def base_grid(kk):
    """The ``(2 * kk * kk,)`` y-first offsets of a ``kk x kk`` kernel's
    points from its centre, row-major."""
    pad = (kk - 1) // 2
    by, bx = np.meshgrid(np.arange(-pad, pad + 1), np.arange(-pad, pad + 1),
                         indexing="ij")
    return np.stack([by.ravel(), bx.ravel()], 1).reshape(-1).astype(
        np.float32)


def gen_grid_from_reg(reg, prev_boxes, kk):
    """``(dx, dy, dw, dh)`` regressions ``(..., 4)`` from ``prev_boxes``
    ``(..., 4)`` -> a ``kk x kk`` y-first point grid over the regressed box
    ``(..., 2 * kk * kk)`` and the boxes."""
    cxy = (prev_boxes[..., :2] + prev_boxes[..., 2:]) * 0.5
    wh = (prev_boxes[..., 2:] - prev_boxes[..., :2]).clamp(min=1e-6)
    tl = cxy + wh * reg[..., :2] - 0.5 * wh * torch.exp(reg[..., 2:])
    new_wh = wh * torch.exp(reg[..., 2:])
    t = torch.linspace(0.0, 1.0, kk, device=reg.device)
    gy = tl[..., 1:2] + new_wh[..., 1:2] * t               # (..., kk)
    gx = tl[..., 0:1] + new_wh[..., 0:1] * t
    gy2 = gy[..., :, None].expand(gy.shape + (kk,))        # (..., kk, kk)
    gx2 = gx[..., None, :].expand(gx.shape[:-1] + (kk, kk))
    grid = torch.stack([gy2, gx2], dim=-1)
    return grid.reshape(grid.shape[:-3] + (2 * kk * kk,)), \
        torch.cat([tl, tl + new_wh], dim=-1)


class RepPointsHead(nn.Module):
    """Two towers of ``stacked_convs`` conv-GN-ReLUs, the init points from
    a 3x3 conv, ReLU and 1x1 conv on the reg tower, then the cls and refine
    branches: a deformable 3x3 conv steered by the init points, ReLU and a
    1x1 conv each.  Outputs float32: per level the logits ``(B, C, H,
    W)``, the init and refine point sets ``(B, 2n, H, W)`` (y-first, in
    strides from the cell), and the ``(2,)`` ``moment_transfer``."""

    def __init__(self, num_classes=1, in_channels=256, feat_channels=256,
                 point_feat_channels=256, stacked_convs=3, num_points=9,
                 gradient_mul=0.1, transform_method="moment",
                 use_grid_points=False, center_init=True,
                 point_base_scale=4):
        super().__init__()
        kk = int(math.isqrt(num_points))
        if kk * kk != num_points:
            raise ValueError("num_points must be a square")
        self.num_classes = num_classes
        self.num_points = num_points
        self.kk = kk
        self.gradient_mul = gradient_mul
        self.transform_method = transform_method
        self.use_grid_points = use_grid_points
        self.center_init = center_init
        self.cls_convs, self.reg_convs = towers(
            in_channels, feat_channels, stacked_convs,
            min(32, feat_channels))
        pts_out = 4 if use_grid_points else 2 * num_points
        self.reppoints_cls_conv = DeformConv2d(feat_channels,
                                               point_feat_channels, kk)
        self.reppoints_cls_out = nn.Conv2d(point_feat_channels, num_classes,
                                           1)
        self.reppoints_pts_init_conv = nn.Conv2d(
            feat_channels, point_feat_channels, 3, padding=1)
        self.reppoints_pts_init_out = nn.Conv2d(point_feat_channels, pts_out,
                                                1)
        self.reppoints_pts_refine_conv = DeformConv2d(
            feat_channels, point_feat_channels, kk)
        self.reppoints_pts_refine_out = nn.Conv2d(point_feat_channels,
                                                  pts_out, 1)
        self.moment_transfer = nn.Parameter(torch.zeros(2))
        base = base_grid(kk)
        scale = point_base_scale / 2.0
        self.register_buffer("base", torch.from_numpy(base),
                             persistent=False)
        self.register_buffer(
            "points_init0", torch.from_numpy(base / np.abs(base).max()
                                             * scale), persistent=False)
        self.register_buffer(
            "bbox_init0", torch.tensor([-scale, -scale, scale, scale]),
            persistent=False)

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=True)
        for m in (self.reppoints_pts_init_conv, self.reppoints_pts_init_out,
                  self.reppoints_pts_refine_out):
            init_output(m, gen)
        init_output(self.reppoints_cls_out, gen, BIAS_PRIOR)
        for m in (self.reppoints_cls_conv, self.reppoints_pts_refine_conv):
            normal_(m.weight, 0.01, gen)
        zeros_(self.moment_transfer)

    def _grid(self, raw, prev):
        """:func:`gen_grid_from_reg` on NCHW maps."""
        grid, boxes = gen_grid_from_reg(raw.permute(0, 2, 3, 1),
                                        prev.permute(0, 2, 3, 1), self.kk)
        return grid.permute(0, 3, 1, 2), boxes.permute(0, 3, 1, 2)

    def forward(self, feats):
        cls_out, init_out, refine_out = [], [], []
        base = self.base[None, :, None, None]
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            raw_init = self.reppoints_pts_init_out(
                F.relu(self.reppoints_pts_init_conv(r))).float()
            if self.use_grid_points:
                prev = self.bbox_init0[None, :, None, None].expand_as(
                    raw_init)
                pts_init, bbox_init = self._grid(raw_init, prev)
            else:
                pts_init = raw_init
                if not self.center_init:
                    pts_init = pts_init + self.points_init0[
                        None, :, None, None]
            pts_mix = (1 - self.gradient_mul) * pts_init.detach() \
                + self.gradient_mul * pts_init
            offset = pts_mix - base
            cls_feat = F.relu(self.reppoints_cls_conv(c, offset))
            ref_feat = F.relu(self.reppoints_pts_refine_conv(r, offset))
            cls_out.append(self.reppoints_cls_out(cls_feat).float())
            init_out.append(pts_init)
            raw_refine = self.reppoints_pts_refine_out(ref_feat).float()
            if self.use_grid_points:
                pts_refine, _ = self._grid(raw_refine, bbox_init.detach())
            else:
                pts_refine = raw_refine + pts_init.detach()
            refine_out.append(pts_refine)
        return cls_out, init_out, refine_out, self.moment_transfer.float()


def points2bbox(pts_xy, moment_transfer=None, moment_mul=0.01,
                method="moment"):
    """Point sets ``(..., n, 2)`` (x, y) -> boxes ``(..., 4)``: ``moment``,
    the mean +- ``sqrt(var + 1e-12)`` times ``exp`` of the transfer (its
    gradient scaled by ``moment_mul``); ``minmax``; ``partial_minmax``, the
    first four points' extent."""
    if method == "moment":
        mean = pts_xy.mean(dim=-2, keepdim=True)
        # sqrt(var + eps): coinciding points would give d(sqrt)/d(0)
        var = ((pts_xy - mean) ** 2).mean(dim=-2)
        std = torch.sqrt(var + 1e-12)
        mt = moment_transfer * moment_mul \
            + moment_transfer.detach() * (1 - moment_mul)
        half = std * torch.exp(mt)
        mean = mean[..., 0, :]
        return torch.cat([mean - half, mean + half], dim=-1)
    if method == "partial_minmax":
        pts_xy = pts_xy[..., :4, :]
    elif method != "minmax":
        raise KeyError(f"unknown transform_method {method}")
    return torch.cat([pts_xy.amin(dim=-2), pts_xy.amax(dim=-2)], dim=-1)


def pts_to_xy(pred, num_points):
    """``(..., 2n)`` y-first channel pairs -> ``(..., n, 2)`` x-y points."""
    return pred.reshape(pred.shape[:-1] + (num_points, 2)).flip(-1)


def point_assign(points_xy, points_lvl, gt_bboxes, gt_valid, scale=4,
                 pos_num=1):
    """The point assigner of a batch: each valid GT's ``pos_num`` nearest
    points (exact ties to the lower index) on its level, ``log2`` of its
    size over ``scale`` averaged over the two sides, truncated and clipped
    to the points' levels; a point several GTs take goes to the nearest
    (the first of equals).

    Args:
      points_xy: ``(P, 2)``; ``points_lvl`` ``(P,)`` int.
      gt_bboxes: ``(B, G, 4)``; ``gt_valid`` ``(B, G)``.

    Returns ``(B, P)`` int64: 0 background, ``i + 1`` GT ``i``.
    """
    lvl_min, lvl_max = points_lvl.min(), points_lvl.max()
    cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    w = (gt_bboxes[..., 2] - gt_bboxes[..., 0]).clamp(min=1e-6)
    h = (gt_bboxes[..., 3] - gt_bboxes[..., 1]).clamp(min=1e-6)
    glvl = ((torch.log2(w / scale) + torch.log2(h / scale)) / 2).to(
        torch.int32)
    glvl = torch.minimum(torch.maximum(glvl, lvl_min), lvl_max)
    d = torch.sqrt(((points_xy[:, 0] - cx[..., None]) / w[..., None]) ** 2
                   + ((points_xy[:, 1] - cy[..., None]) / h[..., None]) ** 2)
    ok = (points_lvl == glvl[..., None]) & gt_valid[..., None]
    inf = d.new_tensor(float("inf"))
    d = torch.where(ok, d, inf)                             # (B, G, P)
    top = torch.sort(-d, dim=-1, descending=True, stable=True).indices[
        ..., :pos_num]
    is_top = torch.zeros_like(ok).scatter_(-1, top, True) & torch.isfinite(d)
    cand = torch.where(is_top, d, inf)
    best, best_gt = cand.min(dim=1)                         # the first min
    return torch.where(torch.isfinite(best), best_gt + 1, 0)


def _assigned_targets(assigned, gt_bboxes):
    matched = (assigned - 1).clamp(min=0)
    return matched, gather_rows(gt_bboxes.float(), matched)


def reppoints_loss(cls_scores, pts_init, pts_refine, moment_transfer,
                   centers, strides, lvls, gt_bboxes, gt_valid, gt_labels,
                   num_classes, num_points=9, point_base_scale=4, gamma=2.0,
                   alpha=0.25, init_assign_scale=4, init_pos_num=1,
                   refine_pos_iou=0.5, refine_neg_iou=0.4,
                   loss_init_weight=0.5, loss_refine_weight=1.0,
                   bbox_beta=0.11, transform_method="moment",
                   init_assigner="point", init_pos_iou=0.5,
                   init_neg_iou=0.4):
    """RepPoints' losses of a batch over the ``(P, 2)`` concatenated point
    centres with their ``(P,)`` strides and levels: smooth L1 of the init
    and the refine boxes over ``point_base_scale * stride``, each over its
    stage's positive count, and focal loss over the non-ignored points of
    the refine assignment."""
    cls_flat = flatten_levels(cls_scores, num_classes)
    init_flat = flatten_levels(pts_init, 2 * num_points)
    refine_flat = flatten_levels(pts_refine, 2 * num_points)

    def boxes(pred):
        xy = pts_to_xy(pred, num_points) * strides[:, None, None] \
            + centers[:, None, :]
        return points2bbox(xy, moment_transfer, method=transform_method)

    bbox_init, bbox_refine = boxes(init_flat), boxes(refine_flat)
    norm = (point_base_scale * strides)[:, None]
    if init_assigner == "max_iou":
        half = (point_base_scale * strides * 0.5)[:, None]
        squares = torch.cat([centers - half, centers + half], dim=-1)
        assigned, _ = max_iou_assign(
            squares, gt_bboxes, gt_valid, pos_iou_thr=init_pos_iou,
            neg_iou_thr=init_neg_iou, min_pos_iou=0.0,
            match_low_quality=True)
    else:
        assigned = point_assign(centers, lvls, gt_bboxes, gt_valid,
                                scale=init_assign_scale,
                                pos_num=init_pos_num)
    pos_i = assigned > 0
    _, tgt_i = _assigned_targets(assigned, gt_bboxes)
    wi = pos_i[..., None].float().expand_as(bbox_init)
    loss_init = loss_init_weight * smooth_l1_loss(
        bbox_init / norm, tgt_i / norm, bbox_beta, wi,
        avg_factor=pos_i.sum().float().clamp(min=1.0))

    assigned, _ = max_iou_assign(
        bbox_init.detach(), gt_bboxes, gt_valid, pos_iou_thr=refine_pos_iou,
        neg_iou_thr=refine_neg_iou, min_pos_iou=0.0, match_low_quality=True)
    pos_r = assigned > 0
    matched, tgt_r = _assigned_targets(assigned, gt_bboxes)
    npos_r = pos_r.sum().float().clamp(min=1.0)
    wr = pos_r[..., None].float().expand_as(bbox_refine)
    loss_refine = loss_refine_weight * smooth_l1_loss(
        bbox_refine / norm, tgt_r / norm, bbox_beta, wr, avg_factor=npos_r)
    labels = torch.where(pos_r, gt_labels.long().gather(1, matched),
                         num_classes)
    onehot = F.one_hot(labels, num_classes + 1)[..., :num_classes].float()
    loss_cls = sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                  (assigned >= 0)[..., None].float(),
                                  avg_factor=npos_r)
    return {"loss_cls": loss_cls, "loss_pts_init": loss_init,
            "loss_pts_refine": loss_refine}


def reppoints_bboxes(cls_scores, pts_refine, moment_transfer,
                     centers_levels, strides, img_shape, num_classes, cfg,
                     num_points=9, transform_method="moment"):
    """Detections of a batch: per level the refine point sets' boxes
    (clipped to ``img_shape`` ``(B, 2)``) of the ``nms_pre`` points of the
    highest class score, then multi-class NMS over the levels."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    boxes_all, scores_all = [], []
    for cs, pr, ctr, st in zip(cls_scores, pts_refine, centers_levels,
                               strides):
        s = torch.sigmoid(flatten_levels([cs], num_classes))
        xy = pts_to_xy(flatten_levels([pr], 2 * num_points), num_points) \
            * float(st) + ctr[:, None, :]
        boxes = clip_to(points2bbox(xy, moment_transfer,
                                    method=transform_method), img_shape)
        idx = top_per_level(s.max(dim=-1).values, min(nms_pre, s.shape[1]))
        boxes_all.append(gather_rows(boxes, idx))
        scores_all.append(gather_rows(s, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
