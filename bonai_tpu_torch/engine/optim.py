"""Optimizer and LR schedule of the training recipe (counterpart of
``bonai_tpu/engine/optim.py``: ``build_lr_schedule``, ``build_optimizer``
and the frozen mask of ``frozen_mask_from_model``).

The JAX package's optax chain is, in order: clip by the global norm of the
trainable gradients, add weight decay, momentum (``torch.optim.SGD``
semantics: decay enters before the momentum buffer, the buffer holds no
LR), scale by the LR.  Here the clip is :func:`apply_gradients`' first
step and ``torch.optim.SGD`` does the rest.  Frozen parameters (the
backbone stem when ``frozen_stages >= 0`` and the first ``frozen_stages``
stages, which the ResNet builds with ``requires_grad=False``) are not in
the optimizer: no update, no decay, and no part of the clipped norm.
"""

from __future__ import annotations

import numpy as np
import torch


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


def build_optimizer(model, optimizer_cfg):
    """``torch.optim.SGD`` over the trainable parameters of ``model`` from
    ``dict(type='SGD', lr=..., momentum=..., weight_decay=...)``."""
    cfg = dict(optimizer_cfg)
    if cfg.get("type", "SGD") != "SGD" or cfg.get("paramwise_cfg"):
        raise NotImplementedError(
            f"optimizer {cfg.get('type')} / paramwise_cfg is not ported to "
            f"bonai_tpu_torch yet (ROADMAP.md item A7)")
    params = [p for p in model.parameters() if p.requires_grad]
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
