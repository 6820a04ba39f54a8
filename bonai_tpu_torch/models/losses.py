"""Weighted, masked losses with an explicit ``avg_factor`` (counterpart of
``bonai_tpu/models/losses.py``: ``weight_reduce_loss``, ``cross_entropy``,
``binary_cross_entropy``, ``l1_loss``, ``smooth_l1_loss``, ``mse_loss``,
Libra R-CNN's ``BalancedL1Loss``; the dense detectors' focal, IoU,
GIoU, GHM-C/R, quality and distribution focal losses and PISA's ISR-P and
CARL; the bounded IoU loss of Guided Anchoring and of the R-CNN box
head; CornerNet's gaussian focal and associative embedding losses).

Padded samples carry weight 0.  Every loss computes in float32 whatever
the dtype of its inputs (the heads may run under bfloat16 autocast).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.samplers import within_group_rank


def _f32(*xs):
    return [None if x is None else x.float() for x in xs]


def weight_reduce_loss(loss, weight=None, avg_factor=None):
    """Weight ``loss`` elementwise, then average: over ``avg_factor`` when
    given, else over the summed weights (or the element count)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if weight is None:
            return loss.mean()
        return loss.sum() / weight.sum().clamp(min=1e-6)
    if not torch.is_tensor(avg_factor):
        avg_factor = loss.new_tensor(float(avg_factor))
    return loss.sum() / avg_factor.float().clamp(min=1e-6)


def cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Softmax cross-entropy with integer ``labels`` (padded labels carry
    weight 0)."""
    logits, weight = _f32(logits, weight)
    logp = F.log_softmax(logits, dim=-1)
    labels = labels.long().clamp(0, logits.shape[-1] - 1)
    loss = -logp.gather(-1, labels[..., None])[..., 0]
    return weight_reduce_loss(loss, weight, avg_factor)


def binary_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Sigmoid cross-entropy; ``labels`` has ``logits``' shape."""
    logits, labels, weight = _f32(logits, labels, weight)
    loss = (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return weight_reduce_loss(loss, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    pred, target, weight = _f32(pred, target, weight)
    return weight_reduce_loss((pred - target).abs(), weight, avg_factor)


def smooth_l1_loss(pred, target, beta=1.0, weight=None, avg_factor=None):
    pred, target, weight = _f32(pred, target, weight)
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, avg_factor)


def mse_loss(pred, target, weight=None, avg_factor=None):
    pred, target, weight = _f32(pred, target, weight)
    return weight_reduce_loss((pred - target) ** 2, weight, avg_factor)


def balanced_l1_loss(pred, target, weight=None, avg_factor=None, alpha=0.5,
                     gamma=1.5, beta=1.0, loss_weight=1.0):
    """Libra R-CNN's balanced L1 loss (``BalancedL1Loss``): with ``b =
    e^(gamma / alpha) - 1``, ``alpha / b * (b x + 1) * log(b x / beta + 1)
    - alpha x`` below ``beta``, ``gamma x + gamma / b - alpha beta`` at and
    above it, of ``x = |pred - target|``, times ``loss_weight``."""
    pred, target, weight = _f32(pred, target, weight)
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1)
        - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return loss_weight * weight_reduce_loss(loss, weight, avg_factor)


def sigmoid_focal_loss(logits, labels, gamma=2.0, alpha=0.25, weight=None,
                       avg_factor=None, reduction="mean"):
    """Elementwise sigmoid focal loss; ``labels`` a one-hot-like float of
    ``logits``' shape.  ``reduction='none'`` returns the weighted
    elements."""
    logits, labels, weight = _f32(logits, labels, weight)
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * labels
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * labels + (1 - p) * (1 - labels)
    alpha_t = alpha * labels + (1 - alpha) * (1 - labels)
    loss = alpha_t * (1 - p_t) ** gamma * ce
    if reduction == "none":
        return loss if weight is None else loss * weight
    return weight_reduce_loss(loss, weight, avg_factor)


def bounded_iou_loss(pred, target, beta=0.2, eps=1e-3):
    """Elementwise bounded IoU loss of aligned ``(..., 4)`` boxes
    (``(..., 4)``: the centre-x, centre-y, width and height terms, each
    shaped as a smooth L1 at ``beta``).  The target's terms carry no
    gradient."""
    pred, target = _f32(pred, target)
    pred_cx = (pred[..., 0] + pred[..., 2]) * 0.5
    pred_cy = (pred[..., 1] + pred[..., 3]) * 0.5
    pred_w = pred[..., 2] - pred[..., 0]
    pred_h = pred[..., 3] - pred[..., 1]
    t = target.detach()
    t_cx = (t[..., 0] + t[..., 2]) * 0.5
    t_cy = (t[..., 1] + t[..., 3]) * 0.5
    t_w = t[..., 2] - t[..., 0]
    t_h = t[..., 3] - t[..., 1]
    dx = (t_cx - pred_cx).abs()
    dy = (t_cy - pred_cy).abs()
    zero = pred.new_zeros(())
    loss_dx = 1 - torch.maximum((t_w - 2 * dx) / (t_w + 2 * dx + eps), zero)
    loss_dy = 1 - torch.maximum((t_h - 2 * dy) / (t_h + 2 * dy + eps), zero)
    loss_dw = 1 - torch.minimum(t_w / (pred_w + eps), pred_w / (t_w + eps))
    loss_dh = 1 - torch.minimum(t_h / (pred_h + eps), pred_h / (t_h + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)


def iou_loss_terms(pred, target, eps=1e-7):
    """Aligned IoU of ``(..., 4)`` boxes, their union and the enclosing
    box's ``(w, h)``."""
    pred, target = _f32(pred, target)
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]).clamp(min=0) * \
        (pred[..., 3] - pred[..., 1]).clamp(min=0)
    at = (target[..., 2] - target[..., 0]).clamp(min=0) * \
        (target[..., 3] - target[..., 1]).clamp(min=0)
    union = (ap + at - inter).clamp(min=eps)
    ewh = (torch.maximum(pred[..., 2:], target[..., 2:])
           - torch.minimum(pred[..., :2], target[..., :2])).clamp(min=0)
    return inter / union, union, ewh


def aligned_iou_giou(a, b, eps=1e-6):
    """IoU and GIoU of aligned ``(..., 4)`` boxes, the union and the
    enclosing area floored at ``eps`` (the dense heads' 1e-6 by
    default)."""
    iou, union, ewh = iou_loss_terms(a, b, eps)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=eps)
    return iou, iou - (enclose - union) / enclose


class IoULoss:
    """``-log(IoU)`` (or ``1 - IoU`` when ``linear``) of aligned boxes."""

    def __init__(self, eps=1e-6, loss_weight=1.0, linear=False):
        self.eps, self.loss_weight, self.linear = eps, loss_weight, linear

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou, _, _ = iou_loss_terms(pred, target, self.eps)
        loss = 1 - iou if self.linear else -torch.log(iou.clamp(min=self.eps))
        return self.loss_weight * weight_reduce_loss(
            loss, *_f32(weight), avg_factor)


class GIoULoss:
    """``1 - GIoU`` of aligned boxes."""

    def __init__(self, eps=1e-7, loss_weight=1.0):
        self.eps, self.loss_weight = eps, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        _, giou = aligned_iou_giou(pred, target, self.eps)
        return self.loss_weight * weight_reduce_loss(
            1 - giou, *_f32(weight), avg_factor)


class BoundedIoULoss:
    """:func:`bounded_iou_loss` of aligned boxes, an ``(N,)`` weight per
    box."""

    def __init__(self, beta=0.2, eps=1e-3, loss_weight=1.0):
        self.beta, self.eps, self.loss_weight = beta, eps, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = bounded_iou_loss(pred, target, self.beta, self.eps)
        if weight is not None:
            weight = weight.float()[..., None]
        return self.loss_weight * weight_reduce_loss(loss, weight,
                                                     avg_factor)


def ghm_edges(bins):
    """GHM's bin edges as the JAX package's ``jnp.linspace(0, 1, bins +
    1)`` gives them: ``i`` times the float32 reciprocal of ``bins``, in
    float32 (XLA divides by a constant through its reciprocal), the last
    edge exactly 1.  An element on an edge belongs to the bin above it,
    so each edge must be JAX's to the bit; ``i / bins`` rounded once, or
    ``torch.linspace``, rounds some edges the other way."""
    step = np.float32(1.0) / np.float32(bins)
    return [float(np.float32(i) * step) for i in range(bins)] + [1.0]


def _ghm_weights(g, valid, bins):
    """Each valid element's inverse bin density: the valid count over its
    bin's count (0 for invalid elements)."""
    edges = ghm_edges(bins)
    tot = valid.sum().clamp(min=1.0)
    w = torch.zeros_like(g)
    for i in range(bins):
        hi = edges[i + 1] + (1e-6 if i == bins - 1 else 0.0)
        inds = (g >= edges[i]) & (g < hi) & (valid > 0)
        n = inds.sum()
        w = torch.where(inds, torch.where(n > 0, tot / n.clamp(min=1), 0.0),
                        w)
    return w, tot


class GHMC:
    """Gradient-harmonizing classification loss: sigmoid cross-entropy
    weighted by the inverse density of ``|sigmoid(pred) - target|`` over
    ``bins`` equal bins, the batch's valid (weight > 0) elements alone,
    over their count.  ``momentum`` is ignored: the JAX ``GHMC`` bins each
    batch on its own, where mmdetection keeps a moving average of the bin
    counts (ROADMAP.md queue C)."""

    def __init__(self, bins=10, momentum=0.0, use_sigmoid=True,
                 loss_weight=1.0):
        if not use_sigmoid:
            raise NotImplementedError("GHMC with use_sigmoid=False")
        self.bins, self.loss_weight = bins, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        pred, target, weight = _f32(pred, target, weight)
        valid = torch.ones_like(target) if weight is None \
            else (weight > 0).float()
        g = (torch.sigmoid(pred) - target).abs().detach()
        w, tot = _ghm_weights(g, valid, self.bins)
        loss = (pred.clamp(min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs())))
        return self.loss_weight * (loss * w).sum() / tot


class GHMR:
    """Gradient-harmonizing regression loss: ``sqrt(d^2 + mu^2) - mu`` of
    ``d = pred - target``, weighted by the inverse density of its
    gradient norm ``|d| / sqrt(d^2 + mu^2)``; ``momentum`` is ignored as
    in :class:`GHMC`."""

    def __init__(self, mu=0.02, bins=10, momentum=0.0, loss_weight=1.0):
        self.mu, self.bins, self.loss_weight = mu, bins, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        pred, target, weight = _f32(pred, target, weight)
        mu = self.mu
        diff = pred - target
        root = torch.sqrt(diff * diff + mu * mu)
        loss = root - mu
        valid = torch.ones_like(loss) if weight is None \
            else (weight > 0).float()
        w, tot = _ghm_weights((diff / root).abs().detach(), valid, self.bins)
        return self.loss_weight * (loss * w).sum() / tot


def quality_focal_loss(pred, labels, score, beta=2.0):
    """Quality focal loss per sample (summed over the classes): sigmoid
    cross-entropy against 0 modulated by ``sigmoid(pred)^beta`` on every
    class, and on a positive's label class (``labels < C``) against its
    quality ``score`` modulated by ``|score - sigmoid(pred)|^beta``."""
    pred, score = _f32(pred, score)
    c = pred.shape[-1]
    sig = torch.sigmoid(pred)
    softplus = torch.log1p(torch.exp(-pred.abs()))
    loss = (pred.clamp(min=0) + softplus) * sig ** beta
    pos = labels < c
    onehot = F.one_hot(torch.where(pos, labels, 0).long(), c).float()
    t = onehot * score[..., None]
    bce_pos = pred.clamp(min=0) - pred * t + softplus
    loss = torch.where(pos[..., None] & (onehot > 0),
                       bce_pos * (t - sig).abs() ** beta, loss)
    return loss.sum(-1)


def distribution_focal_loss(pred, target):
    """Distribution focal loss per side: cross-entropy of ``pred``'s
    ``(..., n)`` logits against the two integer bins bracketing the
    continuous ``target`` in ``[0, n - 1]``, weighted by proximity."""
    pred, target = _f32(pred, target)
    n = pred.shape[-1]
    disl = torch.floor(target).long()
    disr = (disl + 1).clamp(0, n - 1)
    disl = disl.clamp(0, n - 1)
    wl = disr.float() - target
    wr = target - disl.float()
    logp = F.log_softmax(pred, dim=-1)
    return -(logp.gather(-1, disl[..., None])[..., 0] * wl
             + logp.gather(-1, disr[..., None])[..., 0] * wr)


# ---------------------------------------------------------------- PISA

def isr_p(label_weights, ious, pos_mask, labels, matched_gt, pos_loss_cls,
          k=2.0, bias=0.0):
    """PISA's Importance-based Sample Reweighting of the positives: the
    positives ranked by IoU within their (label, GT) group, then across
    the groups of their label (IoU-HLR); the rank mapped linearly to a
    weight, raised to ``k`` with shift ``bias``, and scaled so the
    weighted positive classification loss keeps its sum.  All arguments
    are ``(N,)``; ``pos_loss_cls`` holds no gradient.  Returns the new
    ``(N,)`` label weights."""
    n = labels.shape[0]
    pf = pos_mask.float()
    num_pos = pf.sum()
    counts = torch.zeros(n, device=pf.device).index_add_(
        0, torch.where(pos_mask, labels, n - 1).long(), pf)
    max_l_num = counts.max().clamp(min=1.0)
    ious = ious.clamp(0.0, 1.0)
    iou_key = 1.0 - ious * (1.0 - 1e-6)
    g1 = torch.where(pos_mask, labels * (n + 1) + matched_gt + 1, 0)
    t_rank = within_group_rank(g1, iou_key).float()
    iou_aug = ious + (max_l_num - t_rank)
    key2 = 1.0 - iou_aug / (max_l_num + 2.0)
    g2 = torch.where(pos_mask, labels + 1, 0)
    l_rank = within_group_rank(g2, key2).float()
    w_raw = (max_l_num - l_rank) / max_l_num
    imp = (bias + label_weights * w_raw * (1.0 - bias)) ** k
    ori = (pos_loss_cls * label_weights * pf).sum()
    new = (pos_loss_cls * imp * pf).sum().clamp(min=1e-12)
    ratio = torch.where(num_pos > 0, ori / new, 1.0)
    return torch.where(pos_mask, imp * ratio, label_weights)


def carl_loss(pos_cls_prob, pos_mask, reg_loss_raw, k=1.0, bias=0.2,
              avg_factor=None):
    """PISA's Classification-Aware Regression Loss: each positive's
    ``(N, 4)`` regression loss scaled by ``(bias + (1 - bias) p)^k`` of its
    class probability ``p`` (which keeps its gradient), normalised to sum
    to the positive count, over ``avg_factor`` (default ``N``)."""
    pf = pos_mask.float()
    num_pos = pf.sum()
    w = (bias + (1.0 - bias) * pos_cls_prob.float()) ** k
    ratio = torch.where(num_pos > 0,
                        num_pos / (w * pf).sum().clamp(min=1e-12), 0.0)
    w = w * ratio
    if avg_factor is None:
        avg_factor = float(reg_loss_raw.shape[0])
    return (reg_loss_raw.float() * (w * pf)[:, None]).sum() / avg_factor


def gaussian_focal_loss(pred, gaussian_target, alpha=2.0, gamma=4.0,
                        weight=None, avg_factor=None):
    """CornerNet's focal loss on gaussian heatmap targets (JAX
    ``GaussianFocalLoss`` without its ``loss_weight``): ``pred`` holds
    probabilities; positives are the cells where the target is exactly 1,
    other cells weigh ``(1 - target)^gamma``."""
    pred, gaussian_target, weight = _f32(pred, gaussian_target, weight)
    eps = 1e-12
    pos = (gaussian_target == 1).float()
    neg_w = (1 - gaussian_target) ** gamma
    pos_loss = -torch.log(pred + eps) * (1 - pred) ** alpha * pos
    neg_loss = -torch.log(1 - pred + eps) * pred ** alpha * neg_w \
        * (1 - pos)
    return weight_reduce_loss(pos_loss + neg_loss, weight, avg_factor)


def associative_embedding_loss(tl, br, valid, pull_weight=0.25,
                               push_weight=0.25):
    """CornerNet's pull and push losses of ``(B, G)`` padded corner
    embeddings (JAX ``AssociativeEmbeddingLoss``, one image a row):
    each GT's two embeddings pulled to their mean, and every pair of
    valid GTs' means pushed apart by ``max(0, 1 - |e_i - e_j|)``.  Returns
    the ``(B,)`` weighted pull and push terms."""
    tl, br = tl.float(), br.float()
    v = valid.float()
    n = v.sum(1).clamp(min=1.0)
    mean = (tl + br) / 2.0
    pull = (((tl - mean) ** 2 + (br - mean) ** 2) * v).sum(1) / n
    diff = (mean[:, :, None] - mean[:, None, :]).abs()
    pair_v = v[:, :, None] * v[:, None, :] * (1.0 - torch.eye(
        tl.shape[1], device=tl.device))
    push = ((1.0 - diff).clamp(min=0.0) * pair_v).sum((1, 2)) \
        / (n * (n - 1.0)).clamp(min=1.0)
    return pull_weight * pull, push_weight * push
