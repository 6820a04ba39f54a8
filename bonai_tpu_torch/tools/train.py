"""Train a detector from a config (counterpart of ``tools/train.py``).

On the card, from the repository root:

    python -m bonai_tpu_torch.tools.train \\
        configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py \\
        [--work-dir DIR] [--resume-from CKPT] [--seed N] [--max-steps N] \\
        [--options k=v ...] [--deterministic] [--n-devices N] [--device cpu]

It trains on the config's ``data.train`` through the port's loader,
writes the config, a log file, ``train_log.jsonl`` and ``checkpoints/``
into the work dir (``work_dirs/<config name>`` by default), and runs on the
GPU unless ``--device`` names another device.  ``--deterministic`` runs
under ``torch.use_deterministic_algorithms(True)``.  Past
``BONAI_MAX_RSS_GB`` of host RSS it checkpoints and exits with code 75
(``train_chunked`` resumes it).

``--n-devices N`` (the JAX CLI's flag: by default every visible card, or 1
on the CPU) is ``train_detector``'s ``n_devices``: with N > 1 this process
spawns N ranks, one per card, in a NCCL process group (gloo ranks with
``--device cpu``), and exits 75 when the watchdog stopped them; each rank
trains on its ``samples_per_gpu`` rows of a global batch of
``samples_per_gpu * N``, and rank 0 writes the log and the checkpoints.
With N = 1 it trains in this process.  Run as a rank of a process group
(``parallel.launch(main, N, 'cuda', argv, work_dir=...)``), it trains as
that rank, under ``DistributedDataParallel`` even in a group of one.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import os.path as osp
import time

import torch

from .. import parallel
from ..apis import train_detector
from ..apis.train import rank_logging
from ..config import Config


def parse_options(pairs):
    """``['a.b=1', 'c=x']`` -> ``{'a.b': 1, 'c': 'x'}`` (values as Python
    literals where they parse)."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a detector")
    parser.add_argument("config")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--n-devices", type=int, default=None,
                        help="data-parallel ranks (default: every visible "
                             "card, or 1 on the CPU)")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--options", nargs="+", default=None,
                        help="config overrides k=v (dotted keys)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    if args.deterministic:
        # cuBLAS needs a fixed workspace before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    work_dir = args.work_dir or osp.join(
        "work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    rank, world_size = parallel.world()
    files = []
    if rank == 0:
        cfg.dump(osp.join(work_dir, osp.basename(args.config)))
        files.append(osp.join(work_dir,
                              time.strftime("%Y%m%d_%H%M%S") + ".log"))
    handlers = rank_logging(rank, world_size, logging.INFO, files)
    logger = logging.getLogger("bonai_tpu_torch")
    try:
        logger.info("torch %s, device %s", torch.__version__,
                    args.device or (torch.cuda.get_device_name(0)
                                    if torch.cuda.is_available() else None))
        logger.info("Config:\n%s", cfg.pretty_text)
        train_detector(cfg, None, work_dir, seed=args.seed,
                       max_steps=args.max_steps, device=args.device,
                       resume_from=args.resume_from,
                       n_devices=args.n_devices)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
