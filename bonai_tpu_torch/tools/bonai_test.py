"""BONAI test CLI (counterpart of ``tools/bonai/bonai_test.py``):
inference over a BONAI test split, dumping the pkl that the evaluation
CLI scores.

On the card, from the repository root:

    python -m bonai_tpu_torch.tools.bonai_test CONFIG CHECKPOINT \\
        --out results.pkl [--city shanghai_xian|config] [--nms-score T] \\
        [--max-images N] [--device cpu]

``--city config`` keeps the config's ``data.test``; any other city reads
``<data_root>coco/bonai_<city>_test.json`` and ``<data_root>test/images/``.
``CHECKPOINT`` is a ``.pth``: the port's own ``step_N.pth`` or an mmdet
v2.3 checkpoint.  The model computes in the config's ``compute_dtype``
(bfloat16 by default).  The pkl holds ``dict(results=..., filenames=...)``
in numpy arrays, lists, dicts and Python scalars only, so that the JAX
package's evaluation CLI reads it too.
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle

import torch

from ..apis import init_detector, run_inference
from ..apis.inference import resolve_device
from ..config import Config
from ..datasets import build_dataloader, build_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description="BONAI test")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--out", required=True, help="output pkl")
    parser.add_argument("--city", default="shanghai_xian")
    parser.add_argument("--nms-score", type=float, default=None,
                        help="override rcnn nms iou_threshold")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    if osp.isdir(args.checkpoint):
        raise ValueError(
            f"{args.checkpoint} is a directory (a JAX checkpoint?): the "
            "port reads .pth checkpoints only")

    cfg = Config.fromfile(args.config)
    # the shanghai+xian test set (reference bonai_test.py:108-113);
    # --city config keeps the config's data.test
    data_root = cfg.get("data_root", "data/BONAI/")
    test_cfg = dict(cfg.data.test)
    if args.city != "config":
        test_cfg["ann_file"] = data_root + f"coco/bonai_{args.city}_test.json"
        test_cfg["img_prefix"] = data_root + "test/images/"
    test_cfg["test_mode"] = True
    if args.nms_score is not None:
        cfg.test_cfg.rcnn.nms.iou_threshold = args.nms_score

    device = resolve_device(args.device)
    dataset = build_dataset(test_cfg)
    loader = build_dataloader(
        dataset, samples_per_gpu=cfg.data.get("samples_per_gpu", 2),
        shuffle=False, train=False)
    model = init_detector(cfg, args.checkpoint, device=device,
                          dtype=getattr(torch, cfg.get("compute_dtype",
                                                       "bfloat16")))
    try:
        results = run_inference(model, loader, max_images=args.max_images)
    finally:
        loader.close()
    payload = dict(results=results,
                   filenames=[d["filename"] for d in dataset.data_infos])
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    print(f"wrote {args.out} ({len(results)} images)")
    return payload


if __name__ == "__main__":
    main()
