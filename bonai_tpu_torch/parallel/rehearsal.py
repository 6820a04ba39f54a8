"""The data-parallel rehearsal: one step of ``build_trainer``'s step under
``DistributedDataParallel`` in every rank of a process group, held to one
process that applies the mean of the ranks' gradients, each taken on that
rank's rows of the batch with that rank's draws.

Every process runs with deterministic kernels and no TF32, so the ranks
and the reference compute each rank's gradient alike.  On one card the
ranks are gloo ranks (NCCL refuses two ranks on one device)::

    from bonai_tpu_torch.parallel.rehearsal import rehearse
    report = rehearse(cfg, batch, out_dir)      # raises on a mismatch
"""

from __future__ import annotations

import os
import os.path as osp
import time

import torch

from . import launch, mean_over_ranks, rank_device, rank_seed, world

CUBLAS_WORKSPACE = ":4096:8"    # cuBLAS is deterministic with it set


def deterministic():
    """Deterministic kernels, no TF32, no cuDNN autotuning."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ddp_step_rank(cfg, batch, device, out_dir):
    """A rank of the rehearsal: ``build_trainer`` of ``cfg`` in the process
    group (DDP), one step on this rank's rows of ``batch`` with its own
    generator.  Writes its weights, the step's metrics (mean over the
    ranks), the step's ms and its RoIAlign wrappers' launches to
    ``out_dir/rank<r>.pt``."""
    from ..apis.train import build_trainer, rank_rows
    from ..core.samplers import generator_draws
    from ..ops import launch_counts
    deterministic()
    rank, world_size = world()
    device = rank_device(device)
    model, _, train_step, generator = build_trainer(cfg, device)
    rows = rank_rows(batch, rank, world_size)
    before = launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    metrics = train_step(rows, 0, generator_draws(generator))
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()},
                "metrics": mean_over_ranks(metrics), "ms": ms,
                "counts": counts}, osp.join(out_dir, f"rank{rank}.pt"))


def mean_of_halves_rank(cfg, batch, device, out_dir, world_size):
    """The rehearsal's reference, one process: the same model and
    optimizer, the gradient of each rank's rows with that rank's generator
    (seeded ``rank_seed(0, r)``), their mean, then clip and SGD.  Writes
    the weights to ``out_dir/reference.pt``."""
    from ..apis.train import build_trainer, rank_rows
    from ..core.samplers import generator_draws
    from ..engine import apply_gradients, build_lr_schedule
    deterministic()
    device = rank_device(device)
    model, optimizer, _, _ = build_trainer(cfg, device)
    params = [p for p in model.parameters() if p.requires_grad]
    total = [torch.zeros_like(p) for p in params]
    for r in range(world_size):
        rows = {k: torch.as_tensor(v).to(device)
                for k, v in rank_rows(batch, r, world_size).items()}
        generator = torch.Generator(device=device).manual_seed(
            rank_seed(0, r))
        optimizer.zero_grad(set_to_none=True)
        losses = model(rows, generator_draws(generator))
        sum(v.float() for v in losses.values()).backward()
        for acc, p in zip(total, params):
            acc += p.grad / world_size
    for acc, p in zip(total, params):
        p.grad = acc
    grad_clip = dict(cfg.get("optimizer_config", {}).get("grad_clip") or {})
    lr = build_lr_schedule(cfg.optimizer.lr, 1, [], warmup=None)(0)
    apply_gradients(optimizer, lr, grad_clip.get("max_norm"))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               osp.join(out_dir, "reference.pt"))


def rehearse(cfg, batch, out_dir, world_size=2, device="cuda", tol=1e-4,
             timeout=600):
    """Run the rehearsal of ``cfg`` (float32 and a constant LR, so that each
    tensor's update stands far above its rounding) on ``batch`` (numpy
    arrays) over ``world_size`` gloo ranks on ``device``, then its
    reference in a process of its own, and hold every rank's weights to
    the reference's within ``tol`` of each tensor's largest update.

    Returns ``dict(worst=, moved=, tensors=, launch_s=, ranks=)``:
    the largest difference as a share of its tensor's update, how many of
    the tensors moved, the ranks' launch-to-exit seconds, and each rank's
    ``metrics``, ``ms`` and ``counts``.  Raises ``AssertionError`` when a
    process fails or a tensor differs."""
    from ..models.builder import build_detector
    os.makedirs(out_dir, exist_ok=True)
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    try:
        t0 = time.perf_counter()
        rc = launch(ddp_step_rank, world_size, device, cfg, batch, device,
                    out_dir, work_dir=out_dir, backend="gloo",
                    timeout=timeout)
        launch_s = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"the rehearsal's ranks exited {rc}")
        rc = launch(mean_of_halves_rank, 1, device, cfg, batch, device,
                    out_dir, world_size, work_dir=out_dir, backend="gloo",
                    timeout=timeout)
        if rc:
            raise AssertionError(f"the rehearsal's reference exited {rc}")
    finally:
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    ranks = [torch.load(osp.join(out_dir, f"rank{r}.pt"), map_location="cpu",
                        weights_only=True) for r in range(world_size)]
    want = torch.load(osp.join(out_dir, "reference.pt"), map_location="cpu",
                      weights_only=True)
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    start = init.state_dict()
    worst, moved = 0.0, 0
    for name, w in want.items():
        update = max(float((w - start[name]).abs().max()), 1e-12)
        moved += update > 1e-12
        for r, got in enumerate(ranks):
            err = float((got["state_dict"][name] - w).abs().max())
            worst = max(worst, err / update)
            if err > tol * update:
                raise AssertionError(
                    f"rehearsal rank {r}: {name} differs from the "
                    f"mean-of-halves step by {err:.3g} (its largest update "
                    f"{update:.3g})")
    return dict(worst=worst, moved=moved, tensors=len(want),
                launch_s=launch_s,
                ranks=[{k: v for k, v in r.items() if k != "state_dict"}
                       for r in ranks])


__all__ = ["deterministic", "ddp_step_rank", "mean_of_halves_rank",
           "rehearse"]
