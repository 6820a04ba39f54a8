"""Corruption robustness benchmark (counterpart of the JAX package's
``tools/test_robustness.py``): every corruption at every severity through
the config's test split, evaluated, aggregated into one pkl, and the
P / mPC / rPC tables of ``robustness_eval`` printed.

    python -m bonai_tpu_torch.tools.test_robustness CONFIG CHECKPOINT \\
        [--out r.pkl] [--corruptions benchmark|noise|blur|weather|digital|
        NAME ...] [--severities 0 1 2 3 4 5] [--eval bbox segm] \\
        [--iou-thr 0.5] [--final-prints P mPC rPC] [--max-images N] \\
        [--device cpu]

``CHECKPOINT`` is a ``.pth``, run as ``apis.test.test_split`` runs it, on
the card unless ``--device`` says otherwise.  ``Corrupt`` is inserted
after the test pipeline's first step; severity 0 is the clean run,
evaluated once and shared.  The pkl (``--out`` and its sibling
``*_results.pkl``) is ``{corruption: {severity: {task: {metric: value}}}}``
for a COCO-style set, ``{corruption: {severity: [{"ap": v}, ...]}}`` for
a VOC one.  Each corruption draws from its batch's ``RandomState`` (the
loader's seed for that batch), so a run repeats to the bit.
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle

import numpy as np
import torch

from ..apis.inference import init_detector, resolve_device
from ..apis.test import run_inference
from ..config import Config
from ..datasets import build_dataloader, build_dataset
from .robustness_eval import get_results

BENCHMARK_CORRUPTIONS = [
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "fog",
    "brightness", "contrast", "elastic_transform", "pixelate",
    "jpeg_compression",
]
GROUPS = dict(
    benchmark=BENCHMARK_CORRUPTIONS,
    noise=["gaussian_noise", "shot_noise", "impulse_noise"],
    blur=["defocus_blur", "glass_blur", "motion_blur", "zoom_blur"],
    weather=["snow", "frost", "fog", "brightness"],
    digital=["contrast", "elastic_transform", "pixelate",
             "jpeg_compression"],
)


def _coco_metric_dict(metrics, task):
    """``evaluate``'s keys -> the reference's AP names."""
    m = {
        "AP": metrics.get(f"{task}_mAP", 0.0),
        "AP50": metrics.get(f"{task}_mAP_50", 0.0),
        "AP75": metrics.get(f"{task}_mAP_75", 0.0),
    }
    for name, key in [("APs", f"{task}_mAP_s"), ("APm", f"{task}_mAP_m"),
                      ("APl", f"{task}_mAP_l"), ("AR100", "AR@100"),
                      ("AR300", "AR@300"), ("AR1000", "AR@1000")]:
        if key in metrics:
            m[name] = metrics[key]
    return m


def expand_corruptions(names):
    out = []
    for c in names:
        out.extend(GROUPS.get(c, [c]))
    return out


def run_robustness(model, cfg, corruptions, severities, eval_types=("bbox",),
                   iou_thr=0.5, max_images=None, out=None):
    """The aggregated evaluation of ``model`` on ``cfg.data.test`` under
    each corruption at each severity (see the module's docstring)."""
    is_voc = str(cfg.data.test.get("type", "")).startswith("VOC")
    aggregated, clean_eval = {}, None
    for corruption in corruptions:
        aggregated[corruption] = {}
        for sev in severities:
            if sev == 0 and clean_eval is not None:
                aggregated[corruption][0] = clean_eval
                continue
            test_cfg = dict(cfg.data.test, test_mode=True)
            pipeline = [dict(t) for t in test_cfg["pipeline"]]
            if sev > 0:
                pipeline.insert(1, dict(type="Corrupt",
                                        corruption=corruption,
                                        severity=sev))
            test_cfg["pipeline"] = pipeline
            print(f"\nTesting {corruption} at severity {sev}")
            ds = build_dataset(test_cfg)
            loader = build_dataloader(ds, samples_per_gpu=1, shuffle=False,
                                      train=False)
            try:
                results = run_inference(model, loader, max_images=max_images,
                                        progress=False)
            finally:
                loader.close()
            if is_voc:
                from ..evaluation.mean_ap import eval_map
                anns = [ds.get_ann_info(i) for i in range(len(results))]
                dets = [r[0] if isinstance(r, tuple) else r
                        for r in results]
                _, per_class = eval_map(dets, anns, iou_thr=iou_thr)
                entry = [{"ap": c["ap"]} for c in per_class]
            else:
                metrics = ds.evaluate(results, metric=list(eval_types))
                entry = {t: _coco_metric_dict(metrics, t)
                         for t in eval_types}
            aggregated[corruption][sev] = entry
            if sev == 0:
                clean_eval = entry
            if out:
                with open(osp.splitext(out)[0] + "_results.pkl", "wb") as f:
                    pickle.dump(aggregated, f)
    if out:
        with open(out, "wb") as f:
            pickle.dump(aggregated, f)
    return aggregated


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Corruption robustness benchmark")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--out", default=None,
                        help="raw results pkl; aggregated eval saved "
                             "beside it as *_results.pkl")
    parser.add_argument("--corruptions", nargs="+", default=["benchmark"],
                        help="'benchmark' (all 15), 'noise', 'blur', "
                             "'weather', 'digital', or explicit names")
    parser.add_argument("--severities", type=int, nargs="+",
                        default=[0, 1, 2, 3, 4, 5])
    parser.add_argument("--eval", nargs="+", default=["bbox"],
                        choices=["bbox", "segm"])
    parser.add_argument("--iou-thr", type=float, default=0.5)
    parser.add_argument("--final-prints", nargs="+",
                        default=["P", "mPC", "rPC"],
                        choices=["P", "mPC", "rPC"])
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    model = init_detector(cfg, args.checkpoint,
                          device=resolve_device(args.device),
                          dtype=getattr(torch, cfg.get("compute_dtype",
                                                       "bfloat16")))
    aggregated = run_robustness(
        model, cfg, expand_corruptions(args.corruptions), args.severities,
        args.eval, args.iou_thr, args.max_images, args.out)
    is_voc = str(cfg.data.test.get("type", "")).startswith("VOC")
    print("\nAggregated results:")
    with np.errstate(invalid="ignore"):
        for task in (["bbox"] if is_voc else list(args.eval)):
            get_results(aggregated, dataset="voc" if is_voc else "coco",
                        task=task, prints=list(args.final_prints),
                        aggregate="all")
    return aggregated


if __name__ == "__main__":
    main()
