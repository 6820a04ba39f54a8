"""Train a detector from a config (counterpart of ``tools/train.py``).

On the card, from the repository root:

    python -m bonai_tpu_torch.tools.train \\
        configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py \\
        [--work-dir DIR] [--resume-from CKPT] [--seed N] [--max-steps N] \\
        [--options k=v ...] [--device cpu]

It trains on the config's ``data.train`` through the port's loader,
writes the config, a log file, ``train_log.jsonl`` and ``checkpoints/``
into the work dir (``work_dirs/<config name>`` by default), and runs on the
GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import os.path as osp
import time

import torch

from ..apis import train_detector
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
    parser.add_argument("--options", nargs="+", default=None,
                        help="config overrides k=v (dotted keys)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    work_dir = args.work_dir or osp.join(
        "work_dirs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(osp.join(work_dir, osp.basename(args.config)))

    logger = logging.getLogger("bonai_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    handlers = [logging.StreamHandler(), logging.FileHandler(osp.join(
        work_dir, time.strftime("%Y%m%d_%H%M%S") + ".log"))]
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        logger.info("torch %s, device %s", torch.__version__,
                    args.device or (torch.cuda.get_device_name(0)
                                    if torch.cuda.is_available() else None))
        logger.info("Config:\n%s", cfg.pretty_text)
        train_detector(cfg, None, work_dir, seed=args.seed,
                       max_steps=args.max_steps, device=args.device,
                       resume_from=args.resume_from)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


if __name__ == "__main__":
    main()
