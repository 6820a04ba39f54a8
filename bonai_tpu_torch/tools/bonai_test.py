"""BONAI test CLI (counterpart of ``tools/bonai/bonai_test.py``):
inference over a BONAI test split, dumping the pkl that the evaluation
CLI scores.

On the card, from the repository root:

    python -m bonai_tpu_torch.tools.bonai_test CONFIG CHECKPOINT \\
        --out results.pkl [--city shanghai_xian|config] [--nms-score T] \\
        [--max-images N] [--aug-test [--aug-test-mode det|proposal]] \\
        [--device cpu]

``--city config`` keeps the config's ``data.test``; any other city reads
``<data_root>coco/bonai_<city>_test.json`` and ``<data_root>test/images/``.
``CHECKPOINT`` is a ``.pth``: the port's own ``step_N.pth`` or an mmdet
v2.3 checkpoint, run as ``apis.test.test_split`` runs it.  The pkl holds
``dict(results=..., filenames=...)`` in numpy arrays, lists, dicts and
Python scalars only, so that the JAX package's evaluation CLI reads it
too.  ``--aug-test`` runs test-time augmentation as the generic test CLI
does (BONAI's test pipeline declares no views: horizontal and vertical
flips at scale 1), merged at ``--aug-test-mode`` (``det`` by default).
The JAX CLI declares ``--aug-test`` but reads an ``aug_test_mode`` that
its parser lacks, and crashes; this one defines the flag (ROADMAP.md
queue C).
"""

from __future__ import annotations

import argparse
import pickle

from ..apis.test import test_split
from ..config import Config


def main(argv=None):
    parser = argparse.ArgumentParser(description="BONAI test")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--out", required=True, help="output pkl")
    parser.add_argument("--city", default="shanghai_xian")
    parser.add_argument("--nms-score", type=float, default=None,
                        help="override rcnn nms iou_threshold")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--aug-test", action="store_true",
                        help="multi-view TTA (h+v flip or the views "
                             "declared by MultiScaleFlipAug)")
    parser.add_argument("--aug-test-mode", default="det",
                        choices=["det", "proposal"],
                        help="TTA merge level: det or proposal")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    # the shanghai+xian test set (reference bonai_test.py:108-113);
    # --city config keeps the config's data.test
    data_root = cfg.get("data_root", "data/BONAI/")
    test_cfg = dict(cfg.data.test)
    if args.city != "config":
        test_cfg["ann_file"] = data_root + f"coco/bonai_{args.city}_test.json"
        test_cfg["img_prefix"] = data_root + "test/images/"
    if args.nms_score is not None:
        cfg.test_cfg.rcnn.nms.iou_threshold = args.nms_score
    dataset, results = test_split(
        cfg, args.checkpoint, test_cfg, device=args.device,
        max_images=args.max_images,
        tta=dict(mode=args.aug_test_mode) if args.aug_test else None)
    payload = dict(results=results,
                   filenames=[d["filename"] for d in dataset.data_infos])
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    print(f"wrote {args.out} ({len(results)} images)")
    return payload


if __name__ == "__main__":
    main()
