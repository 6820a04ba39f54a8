"""Training entry point (counterpart of
``bonai_tpu/apis/train.py::train_detector`` on one device).

``train_detector`` builds the detector of a config with seeded random
weights (the config's ``pretrained`` backbone is a download and is not
fetched), the SGD optimizer and LR schedule of the config, and runs the
train step over an iterable of padded batches: the batch contract of
``bonai_tpu/datasets/builder.py`` (``image`` uint8 or normalised float,
``img_shape``, ``gt_bboxes``, ``gt_labels``, ``gt_valid``, ``gt_masks``,
``gt_offsets``) as numpy arrays or tensors.  It logs ``train_log.jsonl``
rows as the JAX loop does, checkpoints at the end of every
``checkpoint_config.interval`` epochs and at the end, and resumes from a
checkpoint.  Everything runs on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time

import torch

from ..config import Config
from ..core.samplers import generator_draws
from ..engine import (build_lr_schedule, build_optimizer, load_checkpoint,
                      make_train_step, provenance_meta, save_checkpoint)
from ..models.builder import build_detector
from ..utils.weights import load_mmdet_checkpoint
from .inference import resolve_device

logger = logging.getLogger("bonai_tpu_torch")


def _device_normalize(cfg):
    """The constants of the train pipeline's ``Normalize(device=True)``
    step, or ``None`` when the pipeline normalises on the host."""
    tcfg = cfg.data.get("train") or {}
    while "pipeline" not in tcfg and "dataset" in tcfg:    # dataset wrappers
        tcfg = tcfg["dataset"]
    for tr in tcfg.get("pipeline", []):
        if tr.get("type") == "Normalize" and tr.get("device"):
            return dict(mean=tr["mean"], std=tr["std"])
    return None


def build_trainer(cfg, device, seed=0, steps_per_epoch=1):
    """The detector of ``cfg`` with seeded random float32 weights on
    ``device`` (channels-last on the card) in train mode, its SGD optimizer
    and the train step with the config's LR schedule, gradient clip and
    device-side normalisation (bfloat16 autocast on the card).

    Returns ``(model, optimizer, train_step, generator)``; ``generator``
    is the samplers' ``torch.Generator``, seeded with ``seed``.
    """
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if cfg.model.get("pretrained"):
        logger.warning("pretrained=%s is not loaded: the backbone starts "
                       "from seeded random weights", cfg.model["pretrained"])
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    model.train()
    model.cfg = cfg

    opt_cfg = dict(cfg.optimizer)
    asl = dict(cfg.get("auto_scale_lr") or {})
    if asl.get("enable", False):    # opt-in linear scaling, one device
        opt_cfg["lr"] = (opt_cfg.get("lr", 0.02)
                         * cfg.data.get("samples_per_gpu", 2)
                         / asl.get("base_batch_size", 8))
    lr_cfg = dict(cfg.get("lr_config", {}))
    schedule = build_lr_schedule(
        opt_cfg.get("lr", 0.02), steps_per_epoch, list(lr_cfg.get("step", [])),
        warmup=lr_cfg.get("warmup"), warmup_iters=lr_cfg.get("warmup_iters", 0),
        warmup_ratio=lr_cfg.get("warmup_ratio", 0.1))
    optimizer = build_optimizer(model, opt_cfg)
    grad_clip = dict(cfg.get("optimizer_config", {}).get("grad_clip") or {})
    train_step = make_train_step(
        model, optimizer, schedule, max_norm=grad_clip.get("max_norm"),
        img_norm=_device_normalize(cfg),
        compute_dtype=torch.bfloat16 if device.type == "cuda" else None)
    generator = torch.Generator(device=device).manual_seed(seed)
    return model, optimizer, train_step, generator


def train_detector(cfg, batches, work_dir, seed=0, max_steps=None,
                   device=None, resume_from=None, load_from=None,
                   log_interval=None):
    """Train the detector of ``cfg`` (a path or a ``Config``).

    Args:
      batches: the batches of one epoch, iterated once per epoch (a list,
        or a loader that can be iterated again); its length is the epoch's
        step count for the LR steps.
      work_dir: where ``train_log.jsonl`` and ``checkpoints/`` go.
      seed: seeds the weights and the samplers' generator.
      max_steps: stop after this many steps in all (counting resumed ones).
      device: ``None`` means the GPU (raises without one); ``"cpu"``.
      resume_from: a checkpoint to continue from (weights, optimizer,
        step, generator); ``load_from`` one to take the weights of.

    Returns ``(model, history)``: the trained model (float32 parameters)
    and the logged rows.
    """
    device = resolve_device(device)
    if isinstance(cfg, (str, os.PathLike)):
        cfg = Config.fromfile(cfg)
    os.makedirs(work_dir, exist_ok=True)
    steps_per_epoch = len(batches)
    model, optimizer, train_step, generator = build_trainer(
        cfg, device, seed, steps_per_epoch)

    step = 0
    resume_from = resume_from or cfg.get("resume_from")
    load_from = load_from or cfg.get("load_from")
    if resume_from:
        step, _ = load_checkpoint(resume_from, model, optimizer, generator)
        logger.info("resumed from %s at step %d", resume_from, step)
    elif load_from:
        model.load_state_dict({k: v for k, v in
                               load_mmdet_checkpoint(load_from).items()
                               if not k.endswith("num_batches_tracked")})
        logger.info("loaded weights from %s", load_from)

    draw = generator_draws(generator)
    log_interval = log_interval or cfg.get("log_config", {}).get("interval",
                                                                 10)
    ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 1)
    provenance = provenance_meta(cfg)
    log_path = osp.join(work_dir, "train_log.jsonl")
    history = []
    t0 = time.time()

    def save(**meta):
        return save_checkpoint(work_dir, step, model, optimizer,
                               dict(meta, **provenance), generator)

    for epoch in range(step // steps_per_epoch, cfg.get("total_epochs", 12)):
        for batch in batches:
            if max_steps is not None and step >= max_steps:
                break
            metrics = train_step(batch, step, draw)
            step += 1
            if step % log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t0) / log_interval
                t0 = time.time()
                rec = dict(epoch=epoch + 1, iter=step, time=dt,
                           **metrics)
                history.append(rec)
                logger.info("Epoch [%d] iter %d %s", epoch + 1, step,
                            " ".join(f"{k}: {v:.4f}"
                                     for k, v in metrics.items()))
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if max_steps is not None and step >= max_steps:
            break
        if (epoch + 1) % ckpt_interval == 0:
            save(epoch=epoch + 1)
    save(final=True)
    return model, history
