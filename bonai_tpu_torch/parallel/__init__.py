"""Data parallelism over the local devices: one process per card,
``torch.distributed`` (NCCL on the card, gloo on the CPU) and DDP
(counterpart of ``bonai_tpu/parallel/__init__.py``, whose mesh step gives
device ``r`` rows ``r*spg:(r+1)*spg`` of the global batch and ``pmean``s
the gradients).

- :func:`init_distributed` joins the process group of a launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, as ``torchrun``
  sets them) or of explicit arguments;
- :func:`launch` spawns one rank per device and returns their exit code;
- :func:`collect_results_shards` merges the ranks' eval results into
  dataset order (:func:`merge_shards` on the host);
- :func:`rank_seed` is the seed of rank ``r``'s draws (rank 0 keeps the
  run's seed, so one rank draws what a one-process run draws);
- :func:`world`, :func:`gather_objects`, :func:`gather_cat`,
  :func:`mean_over_ranks` and :func:`max_over_ranks` are the few
  collectives the train and test loops (and Dynamic R-CNN's batch
  statistics) use; outside a process group they act on this process
  alone.

``parallel.rehearsal`` holds a DDP step to one process's step on the mean
of the ranks' gradients (chip_smoke's ddp phase and the card tests).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as dist

RSS_EXIT = 75           # the host-RSS watchdog's exit code
# how long ``launch`` lets the other ranks run on once one has failed
GRACE_S = 30.0


def world():
    """``(rank, world_size)`` of the default process group; ``(0, 1)``
    outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_seed(seed, rank):
    """The seed of rank ``rank``'s draws: ``seed`` itself for rank 0,
    else a 32-bit seed drawn from ``(seed, rank)``."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


def rank_device(device):
    """The torch device of this rank: on the card the current CUDA device
    (:func:`launch` sets it to ``local rank % device_count()``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def init_distributed(device="cuda", backend=None, init_method=None,
                     rank=None, world_size=None, local_rank=None,
                     timeout=None):
    """Join the process group of this rank (a no-op for one rank).

    ``rank``, ``world_size`` and ``local_rank`` default to the launcher's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``); ``backend`` to NCCL on
    the card and gloo on the CPU.  On the card the rank's current device
    becomes ``local_rank % device_count()``.  Returns ``(rank,
    world_size)``."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else int(local_rank))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if world_size > 1 or init_method is not None:
        kw = {} if timeout is None else {
            "timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world_size, **kw)
    return rank, world_size


def _rank_main(fn, rank, world_size, device, backend, init_file, timeout,
               args):
    """A spawned rank: join the group through the rendezvous file, run
    ``fn(*args)``, leave the group.  ``sys.exit(75)`` in ``fn`` becomes the
    process's exit code; an exception exits 1."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    init_distributed(device, backend, "file://" + init_file, rank,
                     world_size, rank, timeout)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _exit_code(code):
    return 128 - code if code < 0 else code       # killed by signal -code


def launch(fn, n_devices, device, *args, work_dir, backend=None,
           timeout=None):
    """Run ``fn(*args)`` in ``n_devices`` local ranks, each a process of
    the ``spawn`` start method in the process group of all of them, and
    return their exit code.

    The rendezvous is a ``file://`` under ``work_dir`` (never a fixed TCP
    port: several launches may run side by side).  ``backend`` defaults
    to NCCL with one rank per card for ``device='cuda'`` (rank ``r`` on
    card ``r % device_count()``) and gloo for ``device='cpu'``; gloo also
    runs several ranks on one card, which NCCL refuses.  ``timeout``
    (seconds) bounds each collective.

    Returns 0 when every rank exits 0, 75 (the host-RSS watchdog's code)
    when every rank exits 0 or 75 and one 75, and otherwise the code of
    the first rank to end with another (``128 + n`` for signal ``n``).
    Once a rank has failed, the others are killed after ``GRACE_S``
    seconds: a collective with a dead peer would wait for its whole
    timeout."""
    os.makedirs(work_dir, exist_ok=True)
    init_file = osp.join(osp.abspath(work_dir), f".rendezvous_{os.getpid()}_"
                                                f"{time.monotonic_ns()}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, n_devices, str(device), backend, init_file, timeout, args))
        for r in range(n_devices)]
    failed, failed_at = None, None
    codes = [None] * n_devices
    try:
        for p in procs:
            p.start()
        while None in codes:
            for r, p in enumerate(procs):
                p.join(timeout=0.1)
                if codes[r] is None and p.exitcode is not None:
                    codes[r] = _exit_code(p.exitcode)
                    if failed is None and codes[r] not in (0, RSS_EXIT):
                        failed, failed_at = codes[r], time.monotonic()
            if failed is not None and time.monotonic() - failed_at > GRACE_S:
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if osp.exists(init_file):
            os.remove(init_file)
    if failed is not None:
        return failed
    return RSS_EXIT if RSS_EXIT in codes else 0


def _collective_device():
    """Where a collective's tensors live: the card for NCCL, else host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_objects(obj):
    """``[obj of rank 0, obj of rank 1, ...]`` on every rank (``[obj]``
    outside a process group)."""
    _, n = world()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def gather_cat(tensor):
    """Every rank's ``tensor`` (the same shape on each) concatenated along
    dimension 0 in rank order, on every rank, on ``tensor``'s device;
    ``tensor`` itself outside a process group.  No gradient flows."""
    _, n = world()
    if n == 1:
        return tensor
    local = tensor.detach().to(_collective_device()).contiguous()
    out = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(out, local)
    return torch.cat(out).to(tensor.device)


def _reduce(values, op):
    _, n = world()
    t = torch.tensor(values, dtype=torch.float64)
    if n > 1:
        t = t.to(_collective_device())
        dist.all_reduce(t, op)
    return t.cpu()


def mean_over_ranks(metrics):
    """The mean over the ranks of a dict of scalars (the step's losses at
    a logged row, as the mesh step ``pmean``s them), in the dict's order;
    floats out."""
    keys = list(metrics)
    _, n = world()
    t = _reduce([float(metrics[k]) for k in keys], dist.ReduceOp.SUM) / n
    return dict(zip(keys, t.tolist()))


def max_over_ranks(value):
    """The largest ``value`` of any rank (a float)."""
    return float(_reduce([float(value)], dist.ReduceOp.MAX)[0])


def merge_shards(shards, total):
    """Merge every shard's eval result list back into dataset order.

    The eval loader gives shard ``s`` the wrap-padded indices
    ``padded[s::num_shards]`` (``datasets/builder.py::_epoch_indices``),
    so global position ``j * num_shards + s`` holds shard ``s``'s ``j``-th
    result; the wrap padding falls off the truncation to ``total``.  This
    is the reference's ``collect_results_cpu`` interleave-unshard and
    truncate."""
    merged = []
    per = max(len(s) for s in shards)
    for j in range(per):
        for s in range(len(shards)):
            if j < len(shards[s]):
                merged.append(shards[s][j])
    return merged[:total]


def collect_results_shards(local_results, total):
    """This rank's eval results merged with every other rank's into
    dataset order (:func:`merge_shards` of the lists gathered through
    ``dist.all_gather_object``); at one rank its first ``total``."""
    if world()[1] == 1:
        return list(local_results)[:total]
    return merge_shards(gather_objects(list(local_results)), total)


__all__ = ["RSS_EXIT", "collect_results_shards", "gather_objects",
           "init_distributed", "launch", "max_over_ranks", "mean_over_ranks",
           "merge_shards", "rank_device", "rank_seed", "world"]
