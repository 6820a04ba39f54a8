"""Training checkpoints as mmdet-style ``.pth`` files (counterpart of
``bonai_tpu/engine/checkpoint.py``: ``provenance_meta``, ``save_checkpoint``,
``load_checkpoint``, ``latest_checkpoint``).

A checkpoint is ``<work_dir>/checkpoints/step_<N>.pth`` holding ``meta``,
the model's mmdet-keyed ``state_dict`` (which ``init_detector(checkpoint=)``
loads as it is), the optimizer state, the step and the samplers' generator
states: ``generator`` (rank 0's) and ``generators`` (every data-parallel
rank's, by rank).  It is written to a temporary name and renamed, so a save
killed midway never looks finished.  In a data-parallel run rank 0 writes
it, and every rank reads it back.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import re
import subprocess

import torch

logger = logging.getLogger("bonai_tpu_torch")

VERSION = "0.1.0"
_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def provenance_meta(cfg=None, classes=None):
    """The package version with the git revision, the config text and the
    dataset's classes, as mmdet checkpoints carry them."""
    try:
        git = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=_ROOT, capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        git = ""
    meta = {"bonai_tpu_torch_version": f"{VERSION}+{git}" if git
            else VERSION}
    if cfg is not None:
        meta["config"] = getattr(cfg, "pretty_text", str(cfg))
    if classes is not None:
        meta["CLASSES"] = list(classes)
    return meta


def _dir(work_dir):
    return osp.join(osp.abspath(work_dir), "checkpoints")


def save_checkpoint(work_dir, step, model, optimizer, meta=None,
                    generator=None, max_keep=None):
    """Write ``step_<step>.pth`` under ``work_dir/checkpoints``; returns its
    path.

    ``model`` is the detector itself (not a ``DistributedDataParallel``
    wrapper: the keys carry no ``module.`` prefix); ``generator`` the
    samplers' ``torch.Generator``, or the list of every rank's generator
    state.

    ``max_keep`` is the reference ``CheckpointHook``'s ``max_keep_ckpts``:
    after the save, the finished checkpoints older than the newest
    ``max_keep`` are deleted, but never the one just written (``None`` or
    ``<= 0`` keeps all).  The train loop passes it at epoch ends only, so
    its final and preemption checkpoints never prune.
    """
    os.makedirs(_dir(work_dir), exist_ok=True)
    path = osp.join(_dir(work_dir), f"step_{int(step)}.pth")
    payload = {"meta": dict(meta or {}, step=int(step)),
               "state_dict": {k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
               "optimizer": optimizer.state_dict(), "step": int(step)}
    if generator is not None:
        states = (list(generator) if isinstance(generator, (list, tuple))
                  else [generator.get_state()])
        payload.update(generator=states[0], generators=states)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if max_keep and max_keep > 0:
        steps = sorted(_finished_steps(_dir(work_dir)))
        keep = set(steps[-max_keep:]) | {int(step)}
        for s in steps:
            if s not in keep:
                os.remove(osp.join(_dir(work_dir), f"step_{s}.pth"))
    return path


def _finished_steps(root):
    """Step numbers of the finished checkpoints under ``root`` (a save
    killed midway leaves only its ``.tmp``)."""
    return [int(m[1]) for f in os.listdir(root)
            if (m := re.fullmatch(r"step_(\d+)\.pth", f))]


def load_checkpoint(path, model, optimizer=None, generator=None, rank=0):
    """Restore the model (and the optimizer and generator when given) from
    ``path``; returns ``(step, meta)``.

    ``generator`` takes the saved state of data-parallel rank ``rank``.  A
    checkpoint of fewer ranks holds none for it (a resume at another world
    size, which JAX allows too): the generator is then left as it is, seeded
    from ``(seed, rank)``, and the load says so in the log."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if generator is not None:
        states = ckpt.get("generators") or (
            [ckpt["generator"]] if "generator" in ckpt else [])
        if rank < len(states):
            generator.set_state(states[rank])
        else:
            logger.warning(
                "%s holds the sampler state of %d rank(s), none for rank %d: "
                "its draws restart from its seed (seed, %d)", path,
                len(states), rank, rank)
    return int(ckpt["step"]), ckpt.get("meta", {})


def latest_checkpoint(work_dir):
    """The newest finished checkpoint under ``work_dir``, or ``None``."""
    root = _dir(work_dir)
    if not osp.isdir(root):
        return None
    steps = _finished_steps(root)
    return osp.join(root, f"step_{max(steps)}.pth") if steps else None
