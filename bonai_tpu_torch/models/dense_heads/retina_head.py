"""RetinaNet's head and its all-anchor targets, loss and decode
(counterpart of ``bonai_tpu/models/dense_heads/retina_head.py``:
``RetinaHead``, ``RetinaSepBNHead``, ``retina_targets``, ``retina_loss``
and ``retina_bboxes_single``, batched over images here), with the pieces
the other dense heads share: the conv towers and the flattening of the
levels' NCHW outputs to the anchors' ``(level, y, x, a)`` order.

The head's keys are mmdetection v2.3's (``bbox_head.cls_convs.<i>.conv``,
``reg_convs.<i>.conv``, ``retina_cls``, ``retina_reg``; the SepBN head's
``cls_convs.<level>.<i>.{conv,bn}``, the convs level 0's alone).  Every
loss term computes in float32 whatever the head's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign
from ...core.boxes import bbox2delta, clip_boxes, delta2bbox
from ...core.nms import multiclass_nms
from ..backbones.resnet import FrozenBatchNorm2d
from ..init import kaiming_fan_out_, normal_, zeros_
from ..losses import (GHMC, GHMR, balanced_l1_loss, carl_loss, isr_p,
                      l1_loss, sigmoid_focal_loss)

GN_EPS = 1e-6                   # flax's GroupNorm epsilon
BIAS_PRIOR = -math.log((1 - 0.01) / 0.01)   # initial foreground prob 0.01


class TowerConv(nn.Module):
    """mmcv ``ConvModule`` of a 3x3 conv, an optional GroupNorm and a ReLU:
    ``.conv`` and ``.gn``.  The conv keeps its bias before the GroupNorm
    and the GroupNorm takes flax's epsilon, as in the JAX package
    (mmdetection's conv has no bias there and its epsilon is 1e-5:
    ROADMAP.md queue C)."""

    def __init__(self, cin, cout, gn_groups=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.gn = None if gn_groups is None else nn.GroupNorm(
            gn_groups, cout, eps=GN_EPS)

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x if self.gn is None else self.gn(x))


class Scale(nn.Module):
    """mmcv ``Scale``: one learnable scalar ``scale``, 1 at the start."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale.float()


def towers(in_channels, feat_channels, stacked_convs, gn_groups=None):
    """The ``cls_convs`` and ``reg_convs`` towers."""
    return [nn.ModuleList(
        [TowerConv(in_channels if i == 0 else feat_channels, feat_channels,
                   gn_groups) for i in range(stacked_convs)])
        for _ in range(2)]


def init_towers(head, gen, kaiming):
    """The towers' convs: He normal over the fan-out (the GN towers) or
    normal 0.01 (RetinaNet's), zero biases, GroupNorm 1 and 0."""
    for tower in (head.cls_convs, head.reg_convs):
        for m in tower:
            if kaiming:
                kaiming_fan_out_(m.conv.weight, gen)
            else:
                normal_(m.conv.weight, 0.01, gen)
            if m.conv.bias is not None:     # a deformable conv has none
                zeros_(m.conv.bias)
            if m.gn is not None:
                nn.init.ones_(m.gn.weight)
                zeros_(m.gn.bias)


def init_output(conv, gen, bias=0.0):
    normal_(conv.weight, 0.01, gen)
    nn.init.constant_(conv.bias, bias)


def flatten_levels(outs, last):
    """Per-level ``(B, A*last, H, W)`` -> float32 ``(B, N, last)`` in the
    anchors' ``(level, y, x, a)`` order."""
    b = outs[0].shape[0]
    return torch.cat([o.permute(0, 2, 3, 1).reshape(b, -1, last)
                      for o in outs], dim=1).float()


def top_per_level(rank, k):
    """Indices ``(B, k)`` of each row's ``k`` largest ``rank`` values,
    exact ties to the lower index (``jax.lax.top_k``)."""
    return torch.sort(rank, dim=-1, descending=True, stable=True).indices[
        :, :k]


def gather_rows(x, idx):
    """``x[b, idx[b, j]]`` for ``x`` ``(B, N, ...)``, ``idx`` ``(B, K)``."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def nms_detections(boxes, scores, cfg, iou_threshold):
    """The detections of ``(B, N, 4)`` boxes and ``(B, N, C)`` sigmoid
    scores: multi-class NMS (a zero background column appended) at the
    test config's ``score_thr``, ``nms`` and ``max_per_img``."""
    scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                       dim=-1)
    return multiclass_nms(boxes, scores, cfg.get("score_thr", 0.05),
                          dict(cfg.get("nms", dict(
                              type="nms", iou_threshold=iou_threshold))),
                          cfg.get("max_per_img", 100))


def clip_to(boxes, img_shape):
    """Clip ``(B, K, 4)`` boxes to each image's ``(h, w)`` of
    ``img_shape`` ``(B, 2)``."""
    return clip_boxes(boxes, (img_shape[:, 0, None].float(),
                              img_shape[:, 1, None].float()))


class RetinaHead(nn.Module):
    """Two towers of ``stacked_convs`` 3x3 conv-ReLUs shared over the
    levels, then a 3x3 conv to ``A * C`` logits and one to ``A * 4``
    deltas."""

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=9):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs, self.reg_convs = towers(in_channels, feat_channels,
                                                stacked_convs)
        self.retina_cls = nn.Conv2d(feat_channels, num_anchors * num_classes,
                                    3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, num_anchors * 4, 3,
                                    padding=1)

    def init_weights(self, gen):
        init_towers(self, gen, kaiming=False)
        init_output(self.retina_cls, gen, BIAS_PRIOR)
        init_output(self.retina_reg, gen)

    def forward(self, feats):
        """NCHW levels -> per-level ``(B, A*C, H, W)`` and ``(B, A*4, H,
        W)``."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            c = r = x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds


class SepBNConv(nn.Module):
    """One tower conv of :class:`RetinaSepBNHead` at one level: its
    frozen BatchNorm ``bn``, and the bias-free 3x3 ``conv`` that the
    levels share (level 0's alone: ``None`` elsewhere)."""

    def __init__(self, cin, cout, with_conv):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False) \
            if with_conv else None
        self.bn = FrozenBatchNorm2d(cout)


class RetinaSepBNHead(nn.Module):
    """RetinaNet's head with its tower convs shared over the levels and a
    BatchNorm for each level and conv (mmdetection's ``RetinaSepBNHead``,
    the NAS-FPN crop640 configs), then ReLUs and the shared outputs.  The
    norms run over their stored statistics, as every BatchNorm of the JAX
    package does, whatever ``norm_cfg`` says (mmdetection trains them in
    batch mode: ROADMAP.md queue C); ``num_levels`` is the neck's output
    count (the JAX head makes a norm for each level it is given)."""

    def __init__(self, num_classes=80, in_channels=256, feat_channels=256,
                 stacked_convs=4, num_anchors=9, num_levels=5):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs, self.reg_convs = ([nn.ModuleList([nn.ModuleList(
            [SepBNConv(in_channels if i == 0 else feat_channels,
                       feat_channels, lvl == 0)
             for i in range(stacked_convs)]) for lvl in range(num_levels)])
            for _ in range(2)])
        self.retina_cls = nn.Conv2d(feat_channels, num_anchors * num_classes,
                                    3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, num_anchors * 4, 3,
                                    padding=1)

    def init_weights(self, gen):
        for tower in (self.cls_convs[0], self.reg_convs[0]):
            for m in tower:
                normal_(m.conv.weight, 0.01, gen)
        init_output(self.retina_cls, gen, BIAS_PRIOR)
        init_output(self.retina_reg, gen)

    def forward(self, feats):
        """As :meth:`RetinaHead.forward`."""
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            c = r = x
            for shared_c, shared_r, own_c, own_r in zip(
                    self.cls_convs[0], self.reg_convs[0],
                    self.cls_convs[lvl], self.reg_convs[lvl]):
                c = F.relu(own_c.bn(shared_c.conv(c)))
                r = F.relu(own_r.bn(shared_r.conv(r)))
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds


def retina_targets(anchors, gt_bboxes, gt_valid, gt_labels, num_classes,
                   assigner_cfg):
    """All-anchor targets of a batch (no sampling) over the ``(A, 4)``
    anchors, or each image's own ``(B, A, 4)`` (Guided Anchoring's):
    ``(B, A, C)`` one-hot labels of the positives, ``(B, A)``
    classification weights (0 for the ignored anchors), ``(B, A, 4)``
    delta targets and weights (the positives'), the positive count
    ``(B,)``, and ``aux``: ``is_pos``, ``matched`` (the GT index),
    ``labels`` and ``gt_boxes`` of each anchor."""
    assigned, _ = max_iou_assign(
        anchors, gt_bboxes, gt_valid,
        pos_iou_thr=assigner_cfg.get("pos_iou_thr", 0.5),
        neg_iou_thr=assigner_cfg.get("neg_iou_thr", 0.4),
        min_pos_iou=assigner_cfg.get("min_pos_iou", 0.0),
        match_low_quality=assigner_cfg.get("match_low_quality", True))
    is_pos = assigned > 0
    matched = (assigned - 1).clamp(min=0)
    labels = gt_labels.long().gather(1, matched)
    onehot = F.one_hot(labels, num_classes).float() * is_pos[..., None]
    cls_w = (assigned >= 0).float()
    gt_boxes = gather_rows(gt_bboxes.float(), matched)
    reg_w = is_pos.float()[..., None]
    deltas = bbox2delta(anchors, gt_boxes)
    aux = dict(is_pos=is_pos, matched=matched, labels=labels,
               gt_boxes=gt_boxes)
    return (onehot, cls_w, deltas * reg_w, reg_w.expand_as(deltas),
            is_pos.float().sum(1), aux)


def _pisa(cls_flat, reg_flat, anchors, onehot, cls_w, bt, bw, aux,
          num_classes, total_pos, pisa_cfg, gamma, alpha, g):
    """PISA on the all-anchor targets: ISR-P's classification weights and
    the CARL loss (``{}`` without ``carl``)."""
    b, a = cls_flat.shape[:2]
    pos_mask = aux["is_pos"].reshape(-1)
    labels = aux["labels"].reshape(-1)
    # per-image GT ids, so IoU-HLR's groups do not mix images
    matched = (aux["matched"] + torch.arange(
        b, device=anchors.device)[:, None] * g).reshape(-1)
    extra = {}
    isr = dict(pisa_cfg.get("isr") or {})
    if isr:
        with torch.no_grad():
            dec = delta2bbox(anchors, reg_flat.detach())
            gtb = aux["gt_boxes"]
            inter = ((torch.minimum(dec[..., 2], gtb[..., 2])
                      - torch.maximum(dec[..., 0], gtb[..., 0])).clamp(min=0)
                     * (torch.minimum(dec[..., 3], gtb[..., 3])
                        - torch.maximum(dec[..., 1], gtb[..., 1])).clamp(
                             min=0))

            def area(v):
                return (v[..., 2] - v[..., 0]).clamp(min=0) * \
                    (v[..., 3] - v[..., 1]).clamp(min=0)
            ious = inter / (area(dec) + area(gtb) - inter).clamp(min=1e-6)
            focal = sigmoid_focal_loss(cls_flat.detach(), onehot, gamma,
                                       alpha, reduction="none").sum(-1)
            cls_w = isr_p(cls_w.reshape(-1), ious.reshape(-1), pos_mask,
                          labels, matched,
                          torch.where(pos_mask, focal.reshape(-1), 0.0),
                          k=isr.get("k", 2.0),
                          bias=isr.get("bias", 0.0)).reshape(b, a)
    carl = dict(pisa_cfg.get("carl") or {})
    if carl:
        prob = torch.sigmoid(cls_flat).reshape(-1, num_classes)
        pos_prob = prob.gather(1, labels.clamp(0, num_classes - 1)[:, None])[
            :, 0]
        reg_raw = ((reg_flat - bt).abs() * bw).reshape(-1, 4)
        extra["loss_carl"] = carl.get("loss_weight", 5.0) * carl_loss(
            pos_prob, pos_mask, reg_raw, k=carl.get("k", 1.0),
            bias=carl.get("bias", 0.2), avg_factor=total_pos)
    return cls_w, extra


def retina_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_valid,
                gt_labels, num_classes, train_cfg, gamma=2.0, alpha=0.25,
                loss_cls_cfg=None, loss_bbox_cfg=None, pisa_cfg=None):
    """RetinaNet's losses of a batch over the ``(A, 4)`` concatenated
    anchors: sigmoid focal loss over the non-ignored anchors and L1 over
    the positives' deltas, both over the batch's positive count.
    ``loss_cls_cfg``/``loss_bbox_cfg`` replace them with GHM-C/GHM-R (or
    the box loss with Libra's ``BalancedL1Loss``);
    ``pisa_cfg`` (``dict(isr=..., carl=...)``) applies ISR-P to the
    classification weights and adds ``loss_carl``."""
    cls_flat = flatten_levels(cls_scores, num_classes)
    reg_flat = flatten_levels(bbox_preds, 4)
    onehot, cls_w, bt, bw, npos, aux = retina_targets(
        anchors, gt_bboxes, gt_valid, gt_labels, num_classes,
        dict(train_cfg["assigner"]))
    total_pos = npos.sum().clamp(min=1.0)
    extra = {}
    if pisa_cfg:
        cls_w, extra = _pisa(cls_flat, reg_flat, anchors, onehot, cls_w, bt,
                             bw, aux, num_classes, total_pos, pisa_cfg,
                             gamma, alpha, gt_bboxes.shape[1])
    if loss_cls_cfg:
        loss_cls = GHMC(**_loss_kwargs(loss_cls_cfg))(
            cls_flat, onehot, cls_w[..., None].expand_as(cls_flat),
            avg_factor=total_pos)
    else:
        loss_cls = sigmoid_focal_loss(cls_flat, onehot, gamma, alpha,
                                      cls_w[..., None], avg_factor=total_pos)
    if loss_bbox_cfg and loss_bbox_cfg["type"] == "GHMR":
        loss_bbox = GHMR(**_loss_kwargs(loss_bbox_cfg))(
            reg_flat, bt, bw, avg_factor=total_pos)
    elif loss_bbox_cfg:
        loss_bbox = balanced_l1_loss(reg_flat, bt, bw, avg_factor=total_pos,
                                     **_loss_kwargs(loss_bbox_cfg))
    else:
        loss_bbox = l1_loss(reg_flat, bt, bw, avg_factor=total_pos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, **extra}


def _loss_kwargs(cfg):
    cfg = dict(cfg)
    cfg.pop("type")
    return cfg


def retina_bboxes(cls_scores, bbox_preds, anchors_levels, img_shape,
                  num_classes, cfg):
    """Detections of a batch: per level the ``nms_pre`` anchors of the
    highest class score, their boxes decoded (stds ``cfg['bbox_std']``,
    unit by default) and clipped to ``img_shape`` ``(B, 2)``, then
    multi-class NMS over the levels."""
    nms_pre = cfg.get("nms_pre", 1000)
    stds = cfg.get("bbox_std", (1., 1., 1., 1.))
    boxes_all, scores_all = [], []
    for scores, deltas, anchors in zip(cls_scores, bbox_preds,
                                       anchors_levels):
        s = torch.sigmoid(flatten_levels([scores], num_classes))
        d = flatten_levels([deltas], 4)
        a = anchors.expand(s.shape[0], -1, 4)
        if s.shape[1] > nms_pre:
            idx = top_per_level(s.max(dim=-1).values, nms_pre)
            s, d, a = (gather_rows(x, idx) for x in (s, d, a))
        boxes_all.append(clip_to(delta2bbox(a, d, stds=stds), img_shape))
        scores_all.append(s)
    return nms_detections(torch.cat(boxes_all, 1), torch.cat(scores_all, 1),
                          cfg, 0.5)
