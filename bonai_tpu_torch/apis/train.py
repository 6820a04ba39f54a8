"""Training entry point (counterpart of
``bonai_tpu/apis/train.py::train_detector``).

``train_detector`` builds the detector of a config with seeded random
weights (the config's ``pretrained`` backbone is a download and is not
fetched), the SGD optimizer and LR schedule of the config, and runs the
train step over the batches of the config's ``data.train`` through the
port's loader (``datasets/builder.py``), or over an iterable of padded
batches the caller gives: the batch contract of
``bonai_tpu/datasets/builder.py`` (``image`` uint8 or normalised float,
``img_shape``, ``gt_bboxes``, ``gt_labels``, ``gt_valid``, ``gt_masks``,
``gt_offsets``) as numpy arrays or tensors.  It logs ``train_log.jsonl``
rows as the JAX loop does (plus ``data_time``, the host's wait for the
next batch), checkpoints at the end of every
``checkpoint_config.interval`` epochs (keeping the newest
``checkpoint_config.max_keep_ckpts``) and at the end, and resumes from a
checkpoint.  Everything runs on ``cuda`` unless the caller passes
``device="cpu"``.

Dynamic R-CNN's host schedule, as the JAX loop runs it
(:class:`DynamicRCNNSchedule`): each batch carries the current R-CNN IoU
threshold and SmoothL1 beta, the step's ``stat_dyn_*`` statistics are kept
(and not logged), and every ``update_iter_interval`` steps the threshold
and beta follow them.  The schedule is not checkpointed: a resumed run
starts it again from the initial values, as the JAX loop does.

The host-RSS watchdog of the JAX loop: every log row carries the
process's resident set (``host_rss_gb``); past ``BONAI_MAX_RSS_GB`` (100 by
default) the loop writes a checkpoint with ``preempt_rss`` in its meta and
exits with code 75, which ``tools/train_chunked.py`` answers by resuming
in a fresh process.

Data parallelism, as the JAX mesh step does it, in PyTorch's idiom: one
process per card in a ``torch.distributed`` group (NCCL on the card, gloo
on the CPU), the detector under ``DistributedDataParallel``.  Rank ``r``
trains on its rows of the global batch of ``samples_per_gpu * W``, draws
its samplers' uniforms from its own generator (seeded from ``(seed, r)``;
rank 0 keeps ``seed``), and every rank applies the mean gradient.  Rank 0
writes ``train_log.jsonl`` and the checkpoints; the logged losses are the
mean over the ranks, the watchdog reads the largest RSS of any rank, so
all ranks checkpoint and exit 75 together.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import re
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..config import Config
from ..core.samplers import generator_draws
from ..datasets import build_dataloader, build_dataset
from ..engine import (build_lr_schedule, build_optimizer, latest_checkpoint,
                      load_checkpoint, make_train_step, provenance_meta,
                      save_checkpoint)
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


def _host_rss_gb():
    """The process's resident set in GB (``VmRSS`` of
    ``/proc/self/status``; 0.0 where that file is missing)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


BETA_EPS = 1e-15        # mmdetection's ``dynamic_roi_head.py`` EPS


class DynamicRCNNSchedule:
    """Dynamic R-CNN's host-side schedule of the R-CNN IoU threshold and
    SmoothL1 beta (counterpart of ``bonai_tpu/apis/train.py:181-250``;
    reference ``dynamic_roi_head.py:103-150``).

    :meth:`feed` adds ``dyn_iou_thr`` and ``dyn_beta`` (float32) to a
    batch; :meth:`update` takes ``stat_dyn_iou`` and ``stat_dyn_beta`` out
    of a step's metrics (device scalars, read only at an update), and
    every ``update_iter_interval`` steps sets the threshold to
    ``max(initial_iou, mean of the IoU statistics)`` and beta to
    ``min(initial_beta, median of the beta statistics >= 0)``.  Beta is
    kept when there is no such statistic, and, as mmdetection keeps it,
    when their median is below ``1e-15``: the GTs among the positives have
    zero targets, so the median is often 0, and the JAX loop's beta of 0
    makes the SmoothL1 gradient NaN (ROADMAP.md queue C).  In a process
    group every rank's statistics are the global batch's
    (``models/detectors/two_stage.py::dynamic_rcnn_stats``), so the ranks
    stay on one schedule."""

    def __init__(self, dyn_cfg):
        self.initial_iou = float(dyn_cfg.get("initial_iou", 0.4))
        self.initial_beta = float(dyn_cfg.get("initial_beta", 1.0))
        self.interval = int(dyn_cfg.get("update_iter_interval", 100))
        self.iou_thr, self.beta = self.initial_iou, self.initial_beta
        self.iou_hist, self.beta_hist = [], []

    @classmethod
    def of(cls, cfg):
        """The schedule of ``cfg``'s ``train_cfg.rcnn.dynamic_rcnn``, or
        ``None``."""
        rcnn = (cfg.get("train_cfg") or {}).get("rcnn")
        dyn = rcnn.get("dynamic_rcnn") if isinstance(rcnn, dict) else None
        return cls(dyn) if dyn else None

    def feed(self, batch):
        return dict(batch, dyn_iou_thr=np.float32(self.iou_thr),
                    dyn_beta=np.float32(self.beta))

    def update(self, metrics):
        """Take the step's statistics out of ``metrics``; at the interval,
        update the threshold and beta."""
        self.iou_hist.append(metrics.pop("stat_dyn_iou"))
        self.beta_hist.append(metrics.pop("stat_dyn_beta"))
        if len(self.iou_hist) < self.interval:
            return
        ious = [float(x) for x in self.iou_hist]
        betas = [v for v in (float(x) for x in self.beta_hist) if v >= 0]
        self.iou_thr = max(self.initial_iou, float(np.mean(ious)))
        if betas and np.median(betas) >= BETA_EPS:
            self.beta = min(self.initial_beta, float(np.median(betas)))
        self.iou_hist, self.beta_hist = [], []
        logger.info("dynamic-rcnn update: iou_thr=%.3f beta=%.3f",
                    self.iou_thr, self.beta)


def optimizer_cfg(cfg, world_size=1):
    """The config's optimizer, its LR scaled linearly to the global batch
    ``samples_per_gpu * world_size`` when the config opts in with
    ``auto_scale_lr = dict(enable=True, base_batch_size=N)``."""
    opt_cfg = dict(cfg.optimizer)
    asl = dict(cfg.get("auto_scale_lr") or {})
    if asl.get("enable", False):
        base_bs = int(asl.get("base_batch_size", 8))
        global_bs = cfg.data.get("samples_per_gpu", 2) * world_size
        opt_cfg["lr"] = opt_cfg.get("lr", 0.02) * (global_bs / base_bs)
        logger.info("auto_scale_lr: global batch %d vs base %d -> lr %.6f",
                    global_bs, base_bs, opt_cfg["lr"])
    return opt_cfg


def build_trainer(cfg, device, seed=0, steps_per_epoch=1):
    """The detector of ``cfg`` with seeded random float32 weights on
    ``device`` (channels-last on the card) in train mode, its SGD optimizer
    and the train step with the config's LR schedule, gradient clip and
    device-side normalisation (on the card, autocast to the config's
    ``compute_dtype``, bfloat16 by default; none for ``'float32'``).

    Inside a process group the step runs the detector under
    ``DistributedDataParallel`` (``broadcast_buffers=False``: BatchNorm is
    frozen) and the LR scales to the global batch.

    Returns ``(model, optimizer, train_step, generator)``; ``model`` is the
    detector itself, ``generator`` the samplers' ``torch.Generator``,
    seeded with ``parallel.rank_seed(seed, rank)``.
    """
    rank, world_size = parallel.world()
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

    opt_cfg = optimizer_cfg(cfg, world_size)
    lr_cfg = dict(cfg.get("lr_config", {}))
    schedule = build_lr_schedule(
        opt_cfg.get("lr", 0.02), steps_per_epoch, list(lr_cfg.get("step", [])),
        warmup=lr_cfg.get("warmup"), warmup_iters=lr_cfg.get("warmup_iters", 0),
        warmup_ratio=lr_cfg.get("warmup_ratio", 0.1))
    optimizer = build_optimizer(model, opt_cfg)
    grad_clip = dict(cfg.get("optimizer_config", {}).get("grad_clip") or {})
    forward = model
    if dist.is_initialized():
        # a backbone that stops the gradient behind trained parameters
        # (HRNet's conv2/bn2 at frozen_stages >= 1) leaves them out of the
        # graph: DDP must look for them, and apply_gradients zeroes them
        forward = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda"
            else None, broadcast_buffers=False,
            find_unused_parameters=getattr(model.backbone, "stops_gradient",
                                           False))
    compute_dtype = None
    if device.type == "cuda" and cfg.get("compute_dtype",
                                         "bfloat16") != "float32":
        compute_dtype = getattr(torch, cfg.get("compute_dtype", "bfloat16"))
    train_step = make_train_step(
        forward, optimizer, schedule, max_norm=grad_clip.get("max_norm"),
        img_norm=_device_normalize(cfg), compute_dtype=compute_dtype)
    generator = torch.Generator(device=device).manual_seed(
        parallel.rank_seed(seed, rank))
    return model, optimizer, train_step, generator


def build_train_loader(cfg, seed=0, rank=0, world_size=1):
    """The loader of ``cfg.data.train`` for data-parallel rank ``rank`` of
    ``world_size``: its rows of the JAX ``train_detector``'s global batch
    (the whole batch on one device)."""
    data = cfg.data
    return build_dataloader(
        build_dataset(data.train), samples_per_gpu=data.get(
            "samples_per_gpu", 2),
        workers_per_gpu=data.get("workers_per_gpu", 2), seed=seed,
        max_gt=data.get("max_gt", 256),
        inst_mask_size=data.get("inst_mask_size", 112),
        loader_mode=data.get("loader_mode", "thread"), rank=rank,
        world_size=world_size)


def train_detector(cfg, batches, work_dir, seed=0, max_steps=None,
                   device=None, resume_from=None, load_from=None,
                   log_interval=None, n_devices=None):
    """Train the detector of ``cfg`` (a path or a ``Config``).

    Args:
      batches: ``None`` to train on ``cfg.data.train`` through the port's
        loader (``set_epoch`` is called every epoch, as the JAX loop does);
        or the batches of one epoch, iterated once per epoch (a list, or a
        loader that can be iterated again; its items may be ``(batch,
        metas)`` pairs); its length is the epoch's step count for the LR
        steps.  Inside a process group they are this rank's rows; for the
        ranks this call spawns, a list of global batches whose rows are
        split evenly over the ranks.
      work_dir: where ``train_log.jsonl`` and ``checkpoints/`` go.
      seed: seeds the weights, the samplers' generators and the loader.
      max_steps: stop after this many steps in all (counting resumed ones).
      device: ``None`` means the GPU (raises without one); ``"cpu"``.
      resume_from: a checkpoint to continue from (weights, optimizer,
        step, generators); ``load_from`` one to take the weights of.
      n_devices: data-parallel ranks, as in JAX: by default every visible
        card, or 1 on the CPU.  Inside a process group (a rank of
        :func:`~bonai_tpu_torch.parallel.launch` or ``torchrun``) it is the
        group's size, and the detector runs under DDP even in a group of
        one.  Outside one, 1 trains in this process without DDP, and more
        than 1 spawns one process per rank (gloo ranks on the CPU), which
        run deterministic when this process does: their exit code 75 exits
        this process with 75, any other failure raises, and the final
        checkpoint's weights come back.  A caller that must train in this
        process (to read its kernel counters, say) passes 1.

    Returns ``(model, history)``: the trained model (float32 parameters)
    and the logged rows.
    """
    device = resolve_device(device)
    if isinstance(cfg, (str, os.PathLike)):
        cfg = Config.fromfile(cfg)
    os.makedirs(work_dir, exist_ok=True)
    rank, world_size = parallel.world()
    if dist.is_initialized():
        if n_devices not in (None, world_size):
            raise ValueError(f"n_devices={n_devices} inside a process group "
                             f"of {world_size}")
    elif (n_devices or (torch.cuda.device_count() if device.type == "cuda"
                        else 1)) > 1:
        return _spawn_train(
            cfg, batches, work_dir, n_devices or torch.cuda.device_count(),
            device, dict(seed=seed, max_steps=max_steps,
                         resume_from=resume_from, load_from=load_from,
                         log_interval=log_interval))
    device = parallel.rank_device(device)
    own_loader = batches is None
    if own_loader:
        batches = build_train_loader(cfg, seed, rank, world_size)
    try:
        return _train(cfg, batches, work_dir, seed, max_steps, device,
                      resume_from, load_from, log_interval)
    finally:
        if own_loader:
            batches.close()


def rank_rows(item, rank, world_size):
    """Rank ``rank``'s rows of a global batch (or ``(batch, metas)``)."""
    batch = item[0] if isinstance(item, tuple) else item
    per, rest = divmod(len(batch["image"]), world_size)
    if rest:
        raise ValueError(f"a batch of {len(batch['image'])} images does not "
                         f"split over {world_size} ranks")
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _train_in_rank(cfg, batches, work_dir, device, level, files,
                   deterministic, kwargs):
    """A rank that :func:`train_detector` spawned: log as the caller does
    (rank 0 into the caller's log files), run deterministic where the
    caller does, take this rank's rows of the caller's batches, train."""
    rank, world_size = parallel.world()
    rank_logging(rank, world_size, level, files)
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    if batches is not None:
        batches = [rank_rows(b, rank, world_size) for b in batches]
    train_detector(cfg, batches, work_dir, device=device, **kwargs)


def rank_logging(rank, world_size, level=logging.INFO, files=()):
    """Add handlers to the ``bonai_tpu_torch`` logger of rank ``rank`` of
    ``world_size`` and return them: rank 0 logs at ``level`` to the stream
    and appends to ``files``, the other ranks log warnings to the stream;
    each line names its rank when there are several."""
    log = logging.getLogger("bonai_tpu_torch")
    log.setLevel(level if rank == 0 else logging.WARNING)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        if world_size == 1 else
        f"%(asctime)s - %(name)s - rank {rank} - %(levelname)s - "
        f"%(message)s")
    handlers = [logging.StreamHandler()]
    if rank == 0:
        handlers += [logging.FileHandler(f) for f in files]
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    return handlers


def _spawn_train(cfg, batches, work_dir, n_devices, device, kwargs):
    """:func:`train_detector` over ``n_devices`` spawned ranks; returns
    the final checkpoint's model and the rows the run logged.  Exits 75
    when the ranks did (the watchdog); raises when a rank failed."""
    log_path = osp.join(work_dir, "train_log.jsonl")
    before = _rows(log_path)
    log = logging.getLogger("bonai_tpu_torch")
    files = [h.baseFilename for h in log.handlers
             if isinstance(h, logging.FileHandler)]
    rc = parallel.launch(
        _train_in_rank, n_devices, device, cfg,
        None if batches is None else list(batches), work_dir, device.type,
        log.getEffectiveLevel(), files,
        torch.are_deterministic_algorithms_enabled(), kwargs,
        work_dir=work_dir)
    if rc == parallel.RSS_EXIT:
        sys.exit(rc)
    if rc:
        raise RuntimeError(f"a data-parallel rank exited with code {rc}")
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    load_checkpoint(latest_checkpoint(work_dir), model)
    return model.to(device), _rows(log_path)[len(before):]


def _rows(log_path):
    if not osp.exists(log_path):
        return []
    with open(log_path) as f:
        return [json.loads(line) for line in f]


def _train(cfg, batches, work_dir, seed, max_steps, device, resume_from,
           load_from, log_interval):
    rank, world_size = parallel.world()
    steps_per_epoch = max(len(batches), 1)
    model, optimizer, train_step, generator = build_trainer(
        cfg, device, seed, steps_per_epoch)
    if world_size > 1:
        logger.info("data parallel: %d ranks (%s), global batch %d",
                    world_size, dist.get_backend(),
                    cfg.data.get("samples_per_gpu", 2) * world_size)

    step = 0
    resume_from = resume_from or cfg.get("resume_from")
    load_from = load_from or cfg.get("load_from")
    if resume_from:
        step, _ = load_checkpoint(resume_from, model, optimizer, generator,
                                  rank)
        logger.info("resumed from %s at step %d", resume_from, step)
    elif load_from:
        model.load_state_dict({k: v for k, v in
                               load_mmdet_checkpoint(load_from).items()
                               if not k.endswith("num_batches_tracked")})
        logger.info("loaded weights from %s", load_from)

    draw = generator_draws(generator)
    dynamic = DynamicRCNNSchedule.of(cfg)
    log_interval = log_interval or cfg.get("log_config", {}).get("interval",
                                                                 10)
    ckpt_cfg = cfg.get("checkpoint_config", {})
    ckpt_interval = ckpt_cfg.get("interval", 1)
    # the reference CheckpointHook's max_keep_ckpts: -1/None keeps all
    max_keep = ckpt_cfg.get("max_keep_ckpts")
    if max_keep is not None and max_keep <= 0:
        max_keep = None
    max_rss_gb = float(os.environ.get("BONAI_MAX_RSS_GB", "100"))
    provenance = provenance_meta(cfg, getattr(
        getattr(batches, "dataset", None), "CLASSES", None))
    log_path = osp.join(work_dir, "train_log.jsonl")
    history = []
    t0 = time.time()
    data_time = 0.0

    def save(max_keep=None, **meta):
        """Rank 0 writes the checkpoint, with every rank's generator."""
        states = parallel.gather_objects(generator.get_state())
        if rank == 0:
            save_checkpoint(work_dir, step, model, optimizer,
                            dict(meta, **provenance), states, max_keep)

    for epoch in range(step // steps_per_epoch, cfg.get("total_epochs", 12)):
        if hasattr(batches, "set_epoch"):
            batches.set_epoch(epoch)
        items = iter(batches)
        while max_steps is None or step < max_steps:
            t_wait = time.time()
            item = next(items, None)
            data_time += time.time() - t_wait
            if item is None:
                break
            batch = item[0] if isinstance(item, tuple) else item
            if dynamic:
                batch = dynamic.feed(batch)
            metrics = train_step(batch, step, draw)
            step += 1
            if dynamic:
                dynamic.update(metrics)
            if step % log_interval == 0:
                metrics = parallel.mean_over_ranks(metrics)
                dt = (time.time() - t0) / log_interval
                # the largest of any rank, so that every rank stops here
                rss = parallel.max_over_ranks(_host_rss_gb())
                rec = dict(epoch=epoch + 1, iter=step, time=round(dt, 3),
                           data_time=round(data_time / log_interval, 3),
                           host_rss_gb=round(rss, 2),
                           **{k: round(v, 4) for k, v in metrics.items()})
                t0, data_time = time.time(), 0.0
                if getattr(batches, "truncated_samples", 0):
                    rec["gt_truncated"] = batches.truncated_instances
                    rec["gt_truncated_samples"] = batches.truncated_samples
                history.append(rec)
                logger.info("Epoch [%d][%d/%d] %s", epoch + 1,
                            step - epoch * steps_per_epoch, steps_per_epoch,
                            " ".join(f"{k}: {v:.4f}"
                                     for k, v in metrics.items()))
                if rank == 0:
                    with open(log_path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                if rss > max_rss_gb:
                    logger.warning(
                        "host RSS %.1f GB > BONAI_MAX_RSS_GB=%.0f; "
                        "checkpointing and exiting 75 for a clean restart",
                        rss, max_rss_gb)
                    save(epoch=epoch + 1, preempt_rss=rss)
                    _log_run_end(device)
                    sys.exit(parallel.RSS_EXIT)
        if max_steps is not None and step >= max_steps:
            break
        if (epoch + 1) % ckpt_interval == 0:
            save(max_keep, epoch=epoch + 1)
    save(final=True)
    _log_run_end(device)
    return model, history


def _log_run_end(device):
    """Log the card's peak memory and the RoIAlign kernel launches (each
    wrapper's count) of every rank's process (a restarted run logs its
    own)."""
    if device.type != "cuda":
        return
    from ..ops import launch_counts
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    ranks = parallel.gather_objects((peak, launch_counts()))
    for r, (peak, launches) in enumerate(ranks):
        logger.info("rank %d of %d: peak device memory %.2f GiB "
                    "(max_memory_allocated); kernel launches %s", r,
                    len(ranks), peak, json.dumps(launches))


def rank_launches(text):
    """Each rank's kernel launches, by rank, from the lines that
    :func:`_log_run_end` logged (``rank r of W: ...; kernel launches
    {...}``) in ``text``, a run's log."""
    ranks = {}
    for line in text.splitlines():
        m = re.search(r"rank (\d+) of \d+: .*kernel launches (\{.*\})", line)
        if m:
            ranks[int(m[1])] = json.loads(m[2])
    return [ranks[r] for r in sorted(ranks)]
