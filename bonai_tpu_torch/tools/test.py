"""Test CLI (counterpart of the JAX package's ``tools/test.py``): inference
over a config's test split, an optional results pkl, and COCO-style
evaluation.

On the card, from the repository root:

    python -m bonai_tpu_torch.tools.test CONFIG CHECKPOINT [--out r.pkl] \\
        [--eval bbox segm] [--max-images N] [--options k=v ...] \\
        [--aug-test [--aug-test-mode det|proposal]] [--device cpu]

``CHECKPOINT`` is a ``.pth``: the port's own ``step_N.pth`` or an mmdet
v2.3 checkpoint, run as ``apis.test.test_split`` runs it.  The pkl holds
the results list (per image, the per-class boxes, or a tuple of boxes, RLE
masks and offsets) in numpy arrays, lists, dicts and Python scalars only,
as the JAX CLI writes it.
``--eval`` prints ``key: value`` for each of
``bonai_tpu_torch.evaluation.evaluate_coco``'s metrics.  ``--aug-test``
runs test-time augmentation over the views that the test pipeline's
``MultiScaleFlipAug`` declares (else horizontal and vertical flips at
scale 1), merged at the detection level (``--aug-test-mode det``, the
default) or the proposal level (``proposal``): ``apis.test.run_inference``
with ``tta``.
"""

from __future__ import annotations

import argparse
import pickle

from ..apis.test import test_split
from ..config import Config
from ..evaluation import evaluate_coco
from .train import parse_options


def main(argv=None):
    parser = argparse.ArgumentParser(description="Test a detector")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--out", default=None, help="pkl results path")
    parser.add_argument("--eval", nargs="+", default=None,
                        help="metrics: bbox segm")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--options", nargs="+", default=None,
                        help="config overrides k=v (dotted keys)")
    parser.add_argument("--aug-test", action="store_true",
                        help="multi-view TTA (scales x flips declared by "
                             "MultiScaleFlipAug in the test pipeline; "
                             "defaults to h+v flip)")
    parser.add_argument("--aug-test-mode", default="det",
                        choices=["det", "proposal"],
                        help="TTA merge level: det (NMS over the views' "
                             "detections) or proposal (merged proposals, "
                             "averaged boxes and masks)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    dataset, results = test_split(
        cfg, args.checkpoint, device=args.device, max_images=args.max_images,
        tta=dict(mode=args.aug_test_mode) if args.aug_test else None)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        print(f"wrote {args.out}")
    metrics = {}
    if args.eval:
        metrics = evaluate_coco(dataset, results, metric_types=args.eval)
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")
    return results, metrics


if __name__ == "__main__":
    main()
