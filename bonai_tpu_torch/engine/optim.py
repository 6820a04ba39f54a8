"""Optimizer and LR schedule of the training recipe (counterpart of
``bonai_tpu/engine/optim.py``: ``build_lr_schedule``, ``build_optimizer``
and the frozen mask of ``frozen_mask_from_model``).

The JAX package's optax chain is, in order: clip by the global norm of the
trainable gradients, add weight decay, momentum (``torch.optim.SGD``
semantics: decay enters before the momentum buffer, the buffer holds no
LR), scale by the LR.  Here the clip is :func:`apply_gradients`' first
step and ``torch.optim.SGD`` does the rest.  With ``'Adam'`` or
``'AdamW'`` (CornerNet's recipe) the momentum is optax's
``scale_by_adam`` (betas 0.9 and 0.999, epsilon 1e-8 outside the square
root, bias correction), and the weight decay joins the gradient before
it, in both: ``torch.optim.Adam``'s coupled L2, not ``AdamW``'s decoupled
decay (ROADMAP.md queue C); the config's ``momentum`` is not read.  Frozen parameters (the
backbone stem when ``frozen_stages >= 0`` and the first ``frozen_stages``
stages, which the ResNet builds with ``requires_grad=False``) are not in
the optimizer: no update, no decay, and no part of the clipped norm.  A
norm of ``norm_cfg=dict(type='BN', requires_grad=False)`` outside them
(the caffe-style trunks) reads its affine behind a gradient stop: it gets
a zero gradient and stays in the optimizer, moved by weight decay and
momentum, as the JAX package's frozen mask (by stage only) leaves it;
mmdetection keeps it fixed (ROADMAP.md queue C).  ``paramwise_cfg``'s
``norm_decay_mult=0`` (the scratch and crop640 recipes) exempts every
norm's affine (a BatchNorm's, GroupNorm's or LayerNorm's weight and bias:
the JAX package's 1-D ``scale`` leaves and their ``bias``) from the
weight decay; its ``bypass_duplicate`` is read and ignored, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def build_lr_schedule(base_lr, steps_per_epoch, step_epochs, warmup="linear",
                      warmup_iters=500, warmup_ratio=0.001, gamma=0.1):
    """Step policy with iteration-level linear warmup (mmcv semantics:
    ``lr = base * (1 - (1 - i / warmup_iters) * (1 - warmup_ratio))``
    during warmup, ``base * gamma ** (boundaries passed)`` after).
    Returns ``step -> lr`` computed in float32, as the JAX schedule is."""
    f32 = np.float32
    boundaries = [e * steps_per_epoch for e in step_epochs]

    def schedule(count):
        count = f32(count)
        decay = f32(1.0)
        for b in boundaries:
            if count >= b:
                decay = decay * f32(gamma)
        lr = f32(base_lr) * decay
        if warmup == "linear" and warmup_iters > 0 and count < warmup_iters:
            k = (f32(1.0) - count / f32(warmup_iters)) * (f32(1.0)
                                                          - f32(warmup_ratio))
            lr = f32(base_lr) * (f32(1.0) - k)
        elif warmup not in (None, "linear"):
            raise NotImplementedError(f"warmup={warmup!r} is not ported to "
                                      f"bonai_tpu_torch yet")
        return float(lr)

    return schedule


def _norm_params(model):
    """The ids of the affine parameters of ``model``'s norms (the ones
    ``paramwise_cfg.norm_decay_mult`` scales)."""
    from ..models.backbones.resnet import FrozenBatchNorm2d
    norms = (FrozenBatchNorm2d, nn.modules.batchnorm._NormBase,
             nn.GroupNorm, nn.LayerNorm)
    return {id(p) for m in model.modules() if isinstance(m, norms)
            for p in m.parameters(recurse=False)}


def build_optimizer(model, optimizer_cfg):
    """``torch.optim.SGD`` over the trainable parameters of ``model`` from
    ``dict(type='SGD', lr=..., momentum=..., weight_decay=...)``, or
    ``torch.optim.Adam`` (coupled weight decay) for a type ``'Adam'`` or
    ``'AdamW'``; with ``paramwise_cfg=dict(norm_decay_mult=0)`` the norms'
    affine parameters are a second group without weight decay.  Another
    ``paramwise_cfg`` key or multiplier raises A7."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.get("type", "SGD")
    pw = dict(cfg.get("paramwise_cfg") or {})
    pw.pop("bypass_duplicate", None)
    norm_mult = pw.pop("norm_decay_mult", 1.0)
    if opt_type not in ("SGD", "Adam", "AdamW") or pw \
            or norm_mult not in (0, 1):
        raise NotImplementedError(
            f"optimizer {cfg.get('type')} / paramwise_cfg "
            f"{cfg.get('paramwise_cfg')} is not ported to bonai_tpu_torch "
            f"yet (ROADMAP.md item A7)")
    params = [p for p in model.parameters() if p.requires_grad]
    if norm_mult == 0:
        norms = _norm_params(model)
        params = [{"params": [p for p in params if id(p) not in norms]},
                  {"params": [p for p in params if id(p) in norms],
                   "weight_decay": 0.0}]
    if opt_type != "SGD":
        return torch.optim.Adam(params, lr=cfg.get("lr", 0.02),
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.get("weight_decay", 0.0))
    return torch.optim.SGD(params, lr=cfg.get("lr", 0.02),
                           momentum=cfg.get("momentum", 0.9),
                           weight_decay=cfg.get("weight_decay", 0.0))


def apply_gradients(optimizer, lr, max_norm=None):
    """One update from the gradients the parameters hold: clip them to
    ``max_norm`` by their global norm (when it is given and binds), set the
    LR, step.  A trainable parameter that got no gradient (HRNet's
    ``conv2``/``bn2`` behind the gradient stop of ``frozen_stages``) takes
    a zero one, so that weight decay and momentum move it as the JAX step
    does.  Returns the global norm before clipping (a device scalar; no
    host sync)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    if max_norm is not None:
        # optax.clip_by_global_norm: g * max_norm / norm once norm >= max
        scale = torch.where(norm < max_norm, norm.new_tensor(1.0),
                            max_norm / norm)
        for g in grads:
            g.mul_(scale)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return norm
