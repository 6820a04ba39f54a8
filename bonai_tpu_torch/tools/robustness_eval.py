"""Corruption-robustness aggregation (counterpart of the JAX package's
``tools/robustness_eval.py``: the same tables from the same pkl).

    python -m bonai_tpu_torch.tools.robustness_eval RESULTS.pkl \\
        [--dataset coco|voc|cityscapes] [--task bbox segm] \\
        [--prints P mPC rPC] [--aggregate all|benchmark]

Consumes the per-corruption x per-severity eval pkl written by
``bonai_tpu_torch.tools.test_robustness --out`` — structure
``{distortion: {severity: {task: {metric: value}}}}`` for COCO-style
datasets, or ``{distortion: {severity: [{"ap": v}, ...20 classes]}}``
for VOC — and prints the clean performance [P], mean performance under
corruption [mPC] and relative performance [rPC] tables in the
reference's layout (12-row COCO AP/AR table, VOC AP50 summary).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import pickle
import sys

import numpy as np

COCO_METRICS = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]

# rows of the standard 12-entry COCO summary: (is_ap, iouThr, area, maxDets)
_COCO_ROWS = [
    (True, None, "all", 100), (True, 0.5, "all", 100),
    (True, 0.75, "all", 100), (True, None, "small", 100),
    (True, None, "medium", 100), (True, None, "large", 100),
    (False, None, "all", 1), (False, None, "all", 10),
    (False, None, "all", 100), (False, None, "small", 100),
    (False, None, "medium", 100), (False, None, "large", 100),
]


def load_results_file(path):
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def print_coco_results(values):
    """The reference's 12-line COCO summary layout
    (``robustness_eval.py:8-31``)."""
    for v, (is_ap, iou, area, max_dets) in zip(values, _COCO_ROWS):
        title = "Average Precision" if is_ap else "Average Recall"
        kind = "(AP)" if is_ap else "(AR)"
        iou_s = "0.50:0.95" if iou is None else f"{iou:0.2f}"
        print(f" {title:<18} {kind} @[ IoU={iou_s:<9} | area={area:>6s} | "
              f"maxDets={max_dets:>3d} ] = {v:0.3f}")


def _stack_coco(eval_output, task, metrics):
    """-> (num_distortions, 6 severities, num_metrics) array."""
    distortions = list(eval_output)
    out = np.zeros((len(distortions), 6, len(metrics)), np.float32)
    for i, dist in enumerate(distortions):
        for sev, by_task in eval_output[dist].items():
            row = by_task[task] if task in by_task else by_task
            for j, m in enumerate(metrics):
                out[i, int(sev), j] = row.get(m, 0.0)
    return out


def get_coco_style_results(filename, task="bbox", metric=None,
                           prints="mPC", aggregate="benchmark"):
    prints = ["P", "mPC", "rPC"] if prints == "all" else (
        [prints] if isinstance(prints, str) else list(prints))
    assert aggregate in ("benchmark", "all")
    assert all(p in ("P", "mPC", "rPC") for p in prints)
    metrics = (COCO_METRICS if metric is None
               else (metric if isinstance(metric, list) else [metric]))
    assert all(m in COCO_METRICS for m in metrics)

    eval_output = load_results_file(filename) \
        if isinstance(filename, str) else filename
    results = _stack_coco(eval_output, task, metrics)

    clean = results[0, 0, :]
    # "benchmark" mode averages the 15 standard imagecorruptions only
    span = results[:15] if aggregate == "benchmark" else results
    mpc = span[:, 1:, :].mean(axis=(0, 1))
    rpc = mpc / np.maximum(clean, 1e-12)

    if isinstance(filename, str):
        print(f"\nmodel: {osp.basename(filename)}")
    blocks = [("P", clean, "Performance on Clean Data [P]"),
              ("mPC", mpc, "Mean Performance under Corruption [mPC]"),
              ("rPC", rpc, "Relative Performance under Corruption [rPC]")]
    for key, vals, header in blocks:
        if key not in prints:
            continue
        print(f"{header} ({task})")
        if metric is None:
            print_coco_results(vals)
        elif key == "rPC":
            for m, v in zip(metrics, vals):
                print(f"{m:5} => {v * 100:0.1f} %")
        else:
            for m, v in zip(metrics, vals):
                print(f"{m:5} =  {v:0.3f}")
    return results


def get_voc_style_results(filename, prints="mPC", aggregate="benchmark"):
    """VOC mode: per-class AP50 lists, reported as their mean
    (reference ``robustness_eval.py:113-152``)."""
    prints = ["P", "mPC", "rPC"] if prints == "all" else (
        [prints] if isinstance(prints, str) else list(prints))
    assert aggregate in ("benchmark", "all")

    eval_output = load_results_file(filename) \
        if isinstance(filename, str) else filename
    distortions = list(eval_output)
    num_classes = max(len(v) for d in eval_output.values()
                      for v in d.values())
    results = np.zeros((len(distortions), 6, num_classes), np.float32)
    for i, dist in enumerate(distortions):
        for sev, per_class in eval_output[dist].items():
            results[i, int(sev), :len(per_class)] = [
                c["ap"] for c in per_class]

    clean = results[0, 0, :]
    span = results[:15] if aggregate == "benchmark" else results
    mpc = span[:, 1:, :].mean(axis=(0, 1))
    rpc = mpc / np.maximum(clean, 1e-12)

    if isinstance(filename, str):
        print(f"\nmodel: {osp.basename(filename)}")
    if "P" in prints:
        print("Performance on Clean Data [P] in AP50 = "
              f"{clean.mean():0.3f}")
    if "mPC" in prints:
        print("Mean Performance under Corruption [mPC] in AP50 = "
              f"{mpc.mean():0.3f}")
    if "rPC" in prints:
        print("Relative Performance under Corruption [rPC] in % = "
              f"{rpc.mean() * 100:0.1f}")
    return results.mean(axis=2, keepdims=True)


def get_results(filename, dataset="coco", task="bbox", metric=None,
                prints="mPC", aggregate="benchmark"):
    assert dataset in ("coco", "voc", "cityscapes")
    if dataset == "voc":
        if task != "bbox":
            print("Only bbox analysis is supported for Pascal VOC\n"
                  "Will report bbox results\n")
        if metric not in (None, ["AP"], ["AP50"]):
            print("Only the AP50 metric is supported for Pascal VOC\n"
                  "Will report AP50 metric\n")
        return get_voc_style_results(filename, prints=prints,
                                     aggregate=aggregate)
    return get_coco_style_results(filename, task=task, metric=metric,
                                  prints=prints, aggregate=aggregate)


def get_distortions_from_results(eval_output):
    return [d.replace("_", " ") for d in eval_output]


def get_distortions_from_file(filename):
    return get_distortions_from_results(load_results_file(filename))


def main():
    parser = argparse.ArgumentParser(
        description="Corruption Result Analysis")
    parser.add_argument("filename", help="result file path")
    parser.add_argument("--dataset", default="coco",
                        choices=["coco", "voc", "cityscapes"])
    parser.add_argument("--task", nargs="+", default=["bbox"],
                        choices=["bbox", "segm"])
    parser.add_argument("--metric", nargs="+", default=None,
                        choices=COCO_METRICS)
    parser.add_argument("--prints", nargs="+", default="mPC",
                        choices=["P", "mPC", "rPC"])
    parser.add_argument("--aggregate", default="benchmark",
                        choices=["all", "benchmark"])
    args = parser.parse_args()

    for task in args.task:
        get_results(args.filename, dataset=args.dataset, task=task,
                    metric=args.metric, prints=args.prints,
                    aggregate=args.aggregate)


if __name__ == "__main__":
    sys.exit(main())
