"""One training step on one device (counterpart of
``bonai_tpu/engine/train_step.py::make_train_step`` without a mesh).

The step moves the padded batch to the model's device, normalises uint8
images there (the deferred half of the train pipeline's
``Normalize(device=True)``), runs ``forward_train`` under autocast when a
compute dtype is given (parameters stay float32: an SGD update at the
first warmup LR, 5e-6, vanishes in bfloat16 weights), sums the losses
whose names do not start with ``stat_``, and then backward, clip, step.
"""

from __future__ import annotations

import torch

from .optim import apply_gradients


def make_train_step(model, optimizer, lr_schedule, max_norm=None,
                    img_norm=None, compute_dtype=None):
    """Build ``train_step(batch, step, draw) -> metrics``.

    Args:
      model: a detector with ``forward_train``; its parameters stay in
        float32.
      optimizer: from :func:`~bonai_tpu_torch.engine.optim.build_optimizer`.
      lr_schedule: ``step -> lr``.
      max_norm: gradient clip (the config's ``grad_clip.max_norm``).
      img_norm: ``dict(mean=(3,), std=(3,))`` for uint8 images.
      compute_dtype: autocast dtype of the forward (``torch.bfloat16`` on
        the card), or ``None`` for float32.

    ``batch`` is a dict of arrays or tensors in the JAX package's batch
    contract; ``draw`` the samplers' draw source.  The metrics are the
    loss dict, ``loss`` (their sum), ``grad_norm`` (global norm of the
    trainable gradients before clipping) as device scalars, and ``lr``.
    """
    device = next(model.parameters()).device
    mean = std = None
    if img_norm is not None:
        mean = torch.tensor(img_norm["mean"], dtype=torch.float32,
                            device=device)
        std = torch.tensor(img_norm["std"], dtype=torch.float32,
                           device=device)

    def train_step(batch, step, draw):
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in batch.items()}
        if batch["image"].dtype == torch.uint8:
            img = batch["image"].float()
            batch["image"] = img if mean is None else (img - mean) / std
        optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=compute_dtype,
                            enabled=compute_dtype is not None):
            losses = model.forward_train(batch, draw)
        total = sum(v.float() for k, v in losses.items()
                    if not k.startswith("stat_"))
        total.backward()
        lr = lr_schedule(step)
        grad_norm = apply_gradients(optimizer, lr, max_norm)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm, lr=lr)
        return metrics

    return train_step
