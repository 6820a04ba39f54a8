"""Guided Anchoring: the RPN's and RetinaNet's heads, square and
approximate anchors, guided-anchor decode, location and shape targets,
losses, proposals and detections (counterpart of
``bonai_tpu/models/dense_heads/ga_rpn_head.py``: ``GARPNHead``,
``square_anchors``, ``approx_anchors``, ``decode_guided_anchors``,
``_region_bounds``, ``_paint``, ``ga_loc_targets``, ``ga_shape_targets``,
``ga_rpn_loss``, ``ga_proposals_single``, ``GARetinaHead``,
``ga_retina_loss`` and ``ga_retina_bboxes_single``, batched over images
here).

Each cell predicts an objectness location score and an anchor shape
``(dw, dh)`` that scales the cell's square; a deformable 3x3 conv whose
offsets a 1x1 conv reads from the detached shape adapts the features, and
the RPN's classification and deltas run on the adapted features over the
guided anchors.  The shape targets come from approximate max-IoU: each
square takes the best IoU of its cell's 9 approximate anchors.

The RetinaNet head runs the retina towers, reads the location from the
classification tower and the shape from the regression tower, adapts each
tower by its own deformable conv and ends in RetinaNet's 3x3 outputs over
one guided anchor a cell; its loss is RetinaNet's focal and L1 over all
guided anchors beside the location and shape terms.

Keys are mmdetection v2.3's (``rpn_head.{rpn_conv,conv_loc,conv_shape,
feature_adaption.conv_offset,feature_adaption.conv_adaption,conv_cls,
conv_reg}``; ``bbox_head.{cls_convs.<i>.conv,reg_convs.<i>.conv,conv_loc,
conv_shape,feature_adaption_cls,feature_adaption_reg,retina_cls,
retina_reg}``), but a feature adaption has one offset group, as in the
JAX package: ``conv_offset`` predicts 18 channels, mmdetection's 72 (four
groups; ``utils/weights.py::mmdet_state_dict`` refuses them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign
from ...core.boxes import bbox_overlaps, clip_boxes, delta2bbox
from ...core.nms import batched_nms
from ...core.samplers import random_sample
from ...ops.deform_conv import DeformConv2d
from ..init import kaiming_fan_out_, zeros_
from ..losses import (binary_cross_entropy, bounded_iou_loss, l1_loss,
                      sigmoid_focal_loss)
from .retina_head import (BIAS_PRIOR, clip_to, flatten_levels, gather_rows,
                          init_output, init_towers, nms_detections,
                          retina_targets, top_per_level, towers)
from .rpn_head import rpn_targets

# approximate anchors a chunk of the shape targets' IoU (a bound on the
# step's peak memory; the IoUs do not depend on it)
APPROX_CHUNK = 65536


class FeatureAdaption(nn.Module):
    """mmdetection's ``FeatureAdaption`` with one offset group: a 1x1
    ``conv_offset`` without a bias (zero at the start) reads the shape
    prediction, a deformable 3x3 ``conv_adaption`` without a bias
    resamples the features, then a ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__()
        self.conv_offset = nn.Conv2d(2, 2 * kernel_size * kernel_size, 1,
                                     bias=False)
        self.conv_adaption = DeformConv2d(in_channels, out_channels,
                                          kernel_size)

    def init_weights(self, gen):
        zeros_(self.conv_offset.weight)
        kaiming_fan_out_(self.conv_adaption.weight, gen)

    def forward(self, x, shape):
        offset = self.conv_offset(shape.detach().to(x.dtype))
        return F.relu(self.conv_adaption(x, offset.float()))


class GARPNHead(nn.Module):
    """A 3x3 conv + ReLU, then 1x1 convs to the location logit and the
    shape, the feature adaption, and 1x1 convs to the objectness logit and
    the 4 deltas.  Outputs float32 per level: ``(B, 1, H, W)`` logits,
    ``(B, 4, H, W)`` deltas, ``(B, 2, H, W)`` shapes, ``(B, 1, H, W)``
    location logits."""

    def __init__(self, in_channels=256, feat_channels=256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.feature_adaption = FeatureAdaption(feat_channels, feat_channels)
        self.conv_cls = nn.Conv2d(feat_channels, 1, 1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 1)

    def init_weights(self, gen):
        for m in (self.rpn_conv, self.conv_shape, self.conv_cls,
                  self.conv_reg):
            init_output(m, gen)
        init_output(self.conv_loc, gen, BIAS_PRIOR)

    def forward(self, feats):
        cls_scores, bbox_preds, shape_preds, loc_preds = [], [], [], []
        for x in feats:
            x = F.relu(self.rpn_conv(x))
            loc_preds.append(self.conv_loc(x).float())
            shape = self.conv_shape(x).float()
            shape_preds.append(shape)
            x = self.feature_adaption(x, shape)
            cls_scores.append(self.conv_cls(x).float())
            bbox_preds.append(self.conv_reg(x).float())
        return cls_scores, bbox_preds, shape_preds, loc_preds


def _centres(h, w, s):
    gx, gy = np.meshgrid((np.arange(w, dtype=np.float32) + 0.5) * s,
                         (np.arange(h, dtype=np.float32) + 0.5) * s)
    return gx.ravel(), gy.ravel()


def square_anchors(featmap_sizes, strides, octave_base_scale):
    """Per level ``(H*W, 4)`` squares of side ``octave_base_scale *
    stride`` on the cell centres, row-major."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        half = octave_base_scale * s / 2.0
        gx, gy = _centres(h, w, s)
        out.append(np.stack([gx - half, gy - half, gx + half, gy + half],
                            -1))
    return out


def approx_anchors(featmap_sizes, strides, octave_base_scale,
                   scales_per_octave=3, ratios=(0.5, 1.0, 2.0)):
    """Per level ``(H*W, 9, 4)`` approximate anchors: each cell's scales
    (octave-major) and ratios."""
    scales = [octave_base_scale * 2 ** (i / scales_per_octave)
              for i in range(scales_per_octave)]
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        cx, cy = _centres(h, w, s)
        boxes = []
        for sc in scales:
            for r in ratios:
                aw = sc * s * np.sqrt(1.0 / r)
                ah = sc * s * np.sqrt(r)
                boxes.append(np.stack([cx - aw / 2, cy - ah / 2,
                                       cx + aw / 2, cy + ah / 2], -1))
        out.append(np.stack(boxes, 1))
    return out


def decode_guided_anchors(squares, shape_pred, stds=(1.0, 1.0)):
    """Guided anchors ``(..., N, 4)``: the squares ``(N, 4)`` with their
    width and height scaled by ``exp`` of the shape ``(..., N, 2)``
    (clipped to +-6)."""
    cx = (squares[:, 0] + squares[:, 2]) * 0.5
    cy = (squares[:, 1] + squares[:, 3]) * 0.5
    w = squares[:, 2] - squares[:, 0]
    h = squares[:, 3] - squares[:, 1]
    nw = w * torch.exp((shape_pred[..., 0] * stds[0]).clamp(-6.0, 6.0))
    nh = h * torch.exp((shape_pred[..., 1] * stds[1]).clamp(-6.0, 6.0))
    return torch.stack([cx - nw / 2, cy - nh / 2, cx + nw / 2, cy + nh / 2],
                       -1)


def region_bounds(boxes, ratio, h, w):
    """The centred sub-box of ``ratio`` of each side of ``(..., 4)`` boxes
    (in cells), rounded half to even and clipped to the ``(h, w)`` map."""
    def edge(a, b):
        return torch.round((1 - ratio) * 0.5 * (a + b) + ratio * a)
    x1 = edge(boxes[..., 0], boxes[..., 2])
    y1 = edge(boxes[..., 1], boxes[..., 3])
    x2 = edge(boxes[..., 2], boxes[..., 0])
    y2 = edge(boxes[..., 3], boxes[..., 1])
    return (x1.clamp(0, w - 1), y1.clamp(0, h - 1), x2.clamp(0, w - 1),
            y2.clamp(0, h - 1))


def paint(boxes, sel, h, w, ratio):
    """``(B, h, w)``: the union of the selected ``(B, G)`` boxes' centred
    regions."""
    x1, y1, x2, y2 = region_bounds(boxes, ratio, h, w)
    xx = torch.arange(w, dtype=torch.float32, device=boxes.device)
    yy = torch.arange(h, dtype=torch.float32, device=boxes.device)
    inx = (xx >= x1[..., None]) & (xx <= x2[..., None])
    iny = (yy >= y1[..., None]) & (yy <= y2[..., None])
    return (iny[..., :, None] & inx[..., None, :] & sel[..., None, None]
            ).any(dim=1)


def ga_loc_targets(gt_bboxes, gt_valid, featmap_sizes, strides,
                   octave_base_scale, center_ratio=0.2, ignore_ratio=0.5):
    """Location targets of a batch: each GT's level (``log2`` of its
    ``sqrt(area)`` over the first level's anchor size, rounded) gets its
    centre region as positives; its ignore ring there and on the
    neighbouring levels weight 0, the other cells 0.1.  Returns per level
    ``(B, h, w)`` targets and weights, and the loss's average factor (the
    cells over 200)."""
    num_lvls = len(featmap_sizes)
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = torch.sqrt(((gt_bboxes[..., 2] - gt_bboxes[..., 0])
                        * (gt_bboxes[..., 3] - gt_bboxes[..., 1])).clamp(
                            min=1e-6))
    min_size = float(octave_base_scale * strides[0])
    lvl = torch.floor(torch.log2(scale / min_size) + 0.5).clamp(
        0, num_lvls - 1).long()
    targets, weights, total = [], [], 0
    for li, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        boxes = gt_bboxes / float(s)
        sel = (lvl == li) & gt_valid
        pos = paint(boxes, sel, h, w, r1)
        ign = paint(boxes, sel, h, w, r2)
        near = ((lvl == li - 1) | (lvl == li + 1)) & gt_valid
        ign = ign | paint(boxes, near, h, w, r2)
        targets.append(pos.float())
        weights.append(torch.where(pos, 1.0, torch.where(ign, 0.0, 0.1)))
        total += gt_bboxes.shape[0] * h * w
    return targets, weights, total / 200.0


def approx_max_iou(approxs, gt_bboxes):
    """``(B, N, G)``: each cell's best IoU over its approximate anchors
    ``(N, K, 4)`` with each GT ``(B, G, 4)``, in chunks of cells."""
    n, k = approxs.shape[:2]
    step = max(1, APPROX_CHUNK // k)
    return torch.cat([bbox_overlaps(approxs[i:i + step].reshape(-1, 4),
                                    gt_bboxes).reshape(
        gt_bboxes.shape[0], -1, k, gt_bboxes.shape[1]).amax(dim=2)
        for i in range(0, n, step)], dim=1)


def ga_shape_targets(squares, approxs, gt_bboxes, gt_valid, draw,
                     pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                     sample_num=256, pos_fraction=0.5):
    """Shape targets of a batch: the squares ``(N, 4)`` assigned by
    approximate max-IoU, a random sample (``draw``'s uniforms), and its
    positives' mask ``(B, N)``, matched GT boxes ``(B, N, 4)`` and the
    sample's size ``(B,)``."""
    assigned, _ = max_iou_assign(
        squares, gt_bboxes, gt_valid, pos_iou_thr, neg_iou_thr,
        min_pos_iou=min_pos_iou, match_low_quality=True,
        overlaps=approx_max_iou(approxs, gt_bboxes))
    u_pos, u_neg = draw(assigned.shape, assigned.device)
    n = assigned.shape[1]
    res = random_sample(assigned, min(sample_num, n), pos_fraction, u_pos,
                        u_neg)
    pos_mask = torch.zeros_like(assigned, dtype=torch.bool).scatter(
        1, res["inds"], res["is_pos"])
    bbox_gts = gather_rows(gt_bboxes.float(), (assigned - 1).clamp(min=0))
    return pos_mask, bbox_gts, res["valid"].float().sum(1)


def _ga_loc_shape_losses(shape_preds, loc_preds, squares, approxs,
                         gt_bboxes, gt_valid, draw, train_cfg, strides,
                         octave_base_scale, assigner_defaults):
    """The location and shape losses of a batch and the guided anchors
    ``(B, N, 4)``: focal location loss over the levels, bounded-IoU shape
    loss on the sampled positive squares (``draw``'s uniforms; the
    ``ga_assigner``'s thresholds default to ``assigner_defaults``'s:
    ``pos_iou_thr``, ``neg_iou_thr``, ``min_pos_iou``)."""
    b = gt_bboxes.shape[0]
    ga_cfg = dict(train_cfg.get("ga_assigner", {}))
    samp_cfg = dict(train_cfg.get("ga_sampler", {}))
    sizes = [tuple(lp.shape[2:]) for lp in loc_preds]
    loc_t, loc_w, loc_avg = ga_loc_targets(
        gt_bboxes, gt_valid, sizes, strides, octave_base_scale,
        center_ratio=train_cfg.get("center_ratio", 0.2),
        ignore_ratio=train_cfg.get("ignore_ratio", 0.5))
    loss_loc = sum(sigmoid_focal_loss(lp[:, 0], t, weight=w,
                                      avg_factor=loc_avg)
                   for lp, t, w in zip(loc_preds, loc_t, loc_w))
    pos_mask, bbox_gts, n_sampled = ga_shape_targets(
        squares, approxs, gt_bboxes, gt_valid, draw,
        **{k: ga_cfg.get(k, v) for k, v in assigner_defaults.items()},
        sample_num=samp_cfg.get("num", 256),
        pos_fraction=samp_cfg.get("pos_fraction", 0.5))
    shape_flat = torch.cat([s.permute(0, 2, 3, 1).reshape(b, -1, 2)
                            for s in shape_preds], 1)
    guided = decode_guided_anchors(squares, shape_flat)
    loss_shape = (bounded_iou_loss(guided, bbox_gts,
                                   beta=train_cfg.get("shape_beta", 0.2))
                  * pos_mask.float()[..., None] * 0.5).sum() \
        / n_sampled.sum().clamp(min=1.0)
    return loss_loc, loss_shape, guided


def ga_rpn_loss(cls_scores, bbox_preds, shape_preds, loc_preds, squares,
                approxs, gt_bboxes, gt_valid, draw, train_cfg, strides,
                octave_base_scale):
    """GA-RPN's losses of a batch: focal location loss, bounded-IoU shape
    loss on the sampled positive squares, and the RPN's classification and
    L1 losses on the detached guided anchors.  ``squares`` ``(N, 4)`` and
    ``approxs`` ``(N, 9, 4)`` are the levels' concatenated; ``draw`` gives
    the shape sampler's uniforms, then the RPN sampler's."""
    b = gt_bboxes.shape[0]
    loss_loc, loss_shape, guided = _ga_loc_shape_losses(
        shape_preds, loc_preds, squares, approxs, gt_bboxes, gt_valid, draw,
        train_cfg, strides, octave_base_scale,
        dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3))
    cls_flat = torch.cat([s.reshape(b, -1) for s in cls_scores], 1)
    reg_flat = torch.cat([r.permute(0, 2, 3, 1).reshape(b, -1, 4)
                          for r in bbox_preds], 1)
    u_pos, u_neg = draw(cls_flat.shape, cls_flat.device)
    labels, lw, bt, bw, ns = rpn_targets(
        guided.detach(), gt_bboxes, gt_valid, u_pos, u_neg,
        dict(train_cfg["assigner"]), dict(train_cfg["sampler"]))
    num_total = ns.sum().clamp(min=1.0)
    return {"loss_rpn_cls": binary_cross_entropy(cls_flat, labels, lw,
                                                 avg_factor=num_total),
            "loss_rpn_bbox": l1_loss(reg_flat, bt, bw, avg_factor=num_total),
            "loss_rpn_shape": loss_shape, "loss_rpn_loc": loss_loc}


def ga_proposals(cls_scores, bbox_preds, shape_preds, loc_preds,
                 squares_levels, img_shape, cfg, loc_filter_thr=0.01):
    """Proposals of a batch: per level the guided anchors, the objectness
    zeroed where the location score is below ``loc_filter_thr``, the
    ``nms_pre`` best decoded and clipped to ``img_shape`` ``(B, 2)``; then
    NMS with the levels apart and the ``max_num`` best.  Returns ``(B, K,
    4)`` boxes, ``(B, K)`` scores and their validity, ``K = min(max_num,
    candidates)``."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    b = cls_scores[0].shape[0]
    hw = (img_shape[:, 0:1].float(), img_shape[:, 1:2].float())
    boxes_all, scores_all, lvl_all = [], [], []
    for li, (cs, bp, sp, lp, sq) in enumerate(zip(
            cls_scores, bbox_preds, shape_preds, loc_preds, squares_levels)):
        guided = decode_guided_anchors(
            sq, sp.permute(0, 2, 3, 1).reshape(b, -1, 2).float())
        score = torch.sigmoid(cs.reshape(b, -1).float())
        keep = torch.sigmoid(lp.reshape(b, -1).float()) >= loc_filter_thr
        score = torch.where(keep, score, score.new_zeros(()))
        k = min(nms_pre, score.shape[1])
        idx = top_per_level(score, k)
        deltas = gather_rows(bp.permute(0, 2, 3, 1).reshape(b, -1, 4)
                             .float(), idx)
        boxes_all.append(clip_boxes(delta2bbox(gather_rows(guided, idx),
                                               deltas), hw))
        scores_all.append(score.gather(1, idx))
        lvl_all.append(torch.full((b, k), li, device=cs.device))
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    keep = batched_nms(boxes, scores, torch.cat(lvl_all, 1),
                       float(cfg.get("nms_thr", 0.7)), valid=scores > 0)
    kept = torch.where(keep, scores, scores.new_zeros(()))
    idx = top_per_level(kept, min(int(cfg.get("max_num", 1000)),
                                  kept.shape[1]))
    top = kept.gather(1, idx)
    return gather_rows(boxes, idx), top, top > 0


class GARetinaHead(nn.Module):
    """Guided Anchoring's RetinaNet head: the retina towers (3x3
    conv-ReLUs shared over the levels), 1x1 convs to the location logit
    (on the classification tower) and the shape (on the regression
    tower), a feature adaption of each tower, and 3x3 convs to the ``C``
    logits and the 4 deltas of the cell's guided anchor.  Outputs float32
    per level: ``(B, C, H, W)``, ``(B, 4, H, W)``, ``(B, 2, H, W)`` and
    ``(B, 1, H, W)``."""

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 stacked_convs=4):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs, self.reg_convs = towers(in_channels, feat_channels,
                                                stacked_convs)
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.feature_adaption_cls = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.feature_adaption_reg = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.retina_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=False)
        init_output(self.conv_loc, gen, BIAS_PRIOR)
        init_output(self.conv_shape, gen)
        init_output(self.retina_cls, gen, BIAS_PRIOR)
        init_output(self.retina_reg, gen)

    def forward(self, feats):
        cls_scores, bbox_preds, shape_preds, loc_preds = [], [], [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            loc_preds.append(self.conv_loc(c).float())
            shape = self.conv_shape(r).float()
            shape_preds.append(shape)
            c = self.feature_adaption_cls(c, shape)
            r = self.feature_adaption_reg(r, shape)
            cls_scores.append(self.retina_cls(c).float())
            bbox_preds.append(self.retina_reg(r).float())
        return cls_scores, bbox_preds, shape_preds, loc_preds


def ga_retina_loss(cls_scores, bbox_preds, shape_preds, loc_preds, squares,
                   approxs, gt_bboxes, gt_valid, gt_labels, num_classes, draw,
                   train_cfg, strides, octave_base_scale, gamma=2.0,
                   alpha=0.25):
    """GA RetinaNet's losses of a batch: the location and shape losses (the
    ``ga_assigner``'s thresholds 0.5 / 0.4 / 0.0 by default; ``draw``
    called once, for the shape sampler), then RetinaNet's focal loss over
    the non-ignored and L1 over the positive detached guided anchors, both
    over the batch's positive count."""
    loss_loc, loss_shape, guided = _ga_loc_shape_losses(
        shape_preds, loc_preds, squares, approxs, gt_bboxes, gt_valid, draw,
        train_cfg, strides, octave_base_scale,
        dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0))
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4)
    onehot, cls_w, bt, bw, npos, _ = retina_targets(
        guided.detach(), gt_bboxes, gt_valid, gt_labels, num_classes,
        dict(train_cfg["assigner"]))
    total_pos = npos.sum().clamp(min=1.0)
    return {"loss_cls": sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                           cls_w[..., None],
                                           avg_factor=total_pos),
            "loss_bbox": l1_loss(reg_flat, bt, bw, avg_factor=total_pos),
            "loss_shape": loss_shape, "loss_loc": loss_loc}


def ga_retina_bboxes(cls_scores, bbox_preds, shape_preds, loc_preds,
                     squares_levels, img_shape, num_classes, cfg,
                     target_stds=(1., 1., 1., 1.), loc_filter_thr=0.01):
    """Detections of a batch: per level the guided anchors, the sigmoid
    class scores zeroed where the location score is below
    ``loc_filter_thr``, the ``nms_pre`` cells of the highest class score
    decoded (``target_stds``) and clipped to ``img_shape`` ``(B, 2)``;
    then multi-class NMS over the levels."""
    nms_pre = int(cfg.get("nms_pre", 1000))
    b = cls_scores[0].shape[0]
    boxes_all, scores_all = [], []
    for cs, bp, sp, lp, sq in zip(cls_scores, bbox_preds, shape_preds,
                                  loc_preds, squares_levels):
        guided = decode_guided_anchors(
            sq, sp.permute(0, 2, 3, 1).reshape(b, -1, 2).float())
        keep = torch.sigmoid(lp.reshape(b, -1).float()) >= loc_filter_thr
        s = torch.sigmoid(flatten_levels([cs], num_classes)) * keep[..., None]
        idx = top_per_level(s.max(dim=-1).values, min(nms_pre, s.shape[1]))
        dec = delta2bbox(gather_rows(guided, idx),
                         gather_rows(flatten_levels([bp], 4), idx),
                         stds=tuple(target_stds))
        boxes_all.append(clip_to(dec, img_shape))
        scores_all.append(gather_rows(s, idx))
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
