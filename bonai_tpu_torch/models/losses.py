"""Weighted, masked losses with an explicit ``avg_factor`` (counterpart of
``bonai_tpu/models/losses.py``: ``weight_reduce_loss``, ``cross_entropy``,
``binary_cross_entropy``, ``l1_loss``, ``smooth_l1_loss``, ``mse_loss``
and Libra R-CNN's ``BalancedL1Loss``).

Padded samples carry weight 0.  Every loss computes in float32 whatever
the dtype of its inputs (the heads may run under bfloat16 autocast).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
