"""COCO error analysis with F1 curves (counterpart of
``tools/coco_error_analysis_f1.py``; reference:
``tools/coco_error_analysis_f1.py:1-229``).

    python -m bonai_tpu_torch.tools.coco_error_analysis_f1 RESULT.pkl \\
        OUT_DIR --ann GT.json [--img-prefix P] [--types bbox segm] \\
        [--dataset-type BONAI] [--no-plots]

For each class and their mean: the stacked precision curves over recall
with progressive error removal (C75, C50, Loc at 0.3, Sim, Oth, BG, FN)
from ``evaluation/coco_eval.py``'s ``per_image_records`` and
``coco_pr_curve``, written as ``curves.npz`` in ``OUT_DIR/<type>/``
(``rs`` and, per class name, its ``(7, 101)`` precisions), and
``maxF1score.txt``, the best-F1 operating point of each curve.  The curves
and the text need no matplotlib: the JAX tool writes the text only from
inside its plotting function.  The PNG plots, the JAX tool's, need
matplotlib (not installed on the machine with the card): ``--no-plots``
skips them, and without matplotlib the tool raises unless asked to.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..datasets import build_dataset
from ..evaluation.coco_eval import coco_pr_curve, per_image_records

CURVE_TYPES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]
CURVE_COLORS = [(0.31, 0.51, 0.74), (0.75, 0.31, 0.30),
                (0.36, 0.90, 0.38), (0.50, 0.39, 0.64), (1.0, 0.6, 0.0),
                (0.83, 0.83, 0.83), (0.93, 0.93, 0.93)]


def compute_curves(dataset, results, cls, metric="bbox", max_dets=1500):
    """Recall points ``(101,)`` and stacked precision curves ``(7, 101)``
    of class ``cls``."""
    plain = per_image_records(dataset, results, cls, metric)
    ignore = per_image_records(dataset, results, cls, metric,
                               ignore_other_classes=True)
    rs, c75 = coco_pr_curve(plain, 0.75, max_dets)
    _, c50 = coco_pr_curve(plain, 0.50, max_dets)
    _, loc = coco_pr_curve(plain, 0.30, max_dets)
    # one supercategory (BONAI: one class): Sim == Oth
    _, oth = coco_pr_curve(ignore, 0.30, max_dets)
    sim = oth
    bg = (oth > 0).astype(float)
    fn = np.ones_like(bg)
    ps = np.stack([c75, c50, loc, sim, oth, bg, fn])
    # stacking needs curves non-decreasing across the error types
    return rs, np.maximum.accumulate(ps, axis=0)


def f1_lines(rs, ps, class_name):
    """The ``maxF1score.txt`` line of each curve of one class."""
    lines = []
    for k, name in enumerate(CURVE_TYPES):
        curve = 2 * rs * ps[k] / (rs + ps[k] + 1e-6)
        i = int(np.argmax(curve))
        lines.append(f"{class_name} {name}: maxF1={curve[i]:.4f} "
                     f"precision={ps[k][i]:.4f} recall={rs[i]:.4f}\n")
    return lines


def _plot(rs, ps, out_dir, class_name, metric, f1=False):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    title = f"{metric}-{class_name}" + ("-F1" if f1 else "")
    fig = plt.figure()
    ax = plt.subplot(111)
    prev = np.zeros_like(ps[0])
    for k, name in enumerate(CURVE_TYPES):
        curve = ps[k].copy()
        if f1:
            curve = 2 * rs * curve / (rs + curve + 1e-6)
        auc = ps[k].mean()
        ax.plot(rs, curve, color="k", linewidth=0.5)
        ax.fill_between(rs, prev, np.maximum(prev, curve),
                        color=CURVE_COLORS[k], label=f"[{auc:.3f}]{name}")
        prev = np.maximum(prev, curve)
    plt.xlabel("recall")
    plt.ylabel("F1" if f1 else "precision")
    plt.xlim(0, 1.0)
    plt.ylim(0, 1.0)
    plt.title(title)
    plt.legend()
    fig.savefig(osp.join(out_dir, f"{title}.png"))
    plt.close(fig)


def analyze(results, dataset, out_dir, metrics=("bbox",), with_f1=True,
            plots=True):
    """Write each metric's curves (and with ``with_f1`` its
    ``maxF1score.txt``, and with ``plots`` its PNGs) under
    ``out_dir/<metric>``; returns those directories."""
    if plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise RuntimeError("the error-analysis plots need matplotlib, "
                               "which is not installed: pass plots=False "
                               "(--no-plots) for the curves and "
                               "maxF1score.txt alone") from e
    written = []
    for metric in metrics:
        mdir = osp.join(out_dir, metric)
        os.makedirs(mdir, exist_ok=True)
        curves, f1_text, all_ps = {}, [], []
        names = list(dataset.CLASSES) + ["allclass"]
        for c, name in enumerate(names):
            if c < len(dataset.CLASSES):
                rs, ps = compute_curves(dataset, results, c, metric)
                all_ps.append(ps)
            else:
                ps = np.mean(all_ps, axis=0)
            curves[name] = ps
            if with_f1:
                f1_text += f1_lines(rs, ps, name)
            if plots:
                _plot(rs, ps, mdir, name, metric)
                if with_f1:
                    _plot(rs, ps, mdir, name, metric, f1=True)
        np.savez(osp.join(mdir, "curves.npz"), rs=rs, **curves)
        if with_f1:
            with open(osp.join(mdir, "maxF1score.txt"), "w") as f:
                f.writelines(f1_text)
        written.append(mdir)
    return written


def main(argv=None, with_f1=True):
    parser = argparse.ArgumentParser(description="COCO error analysis")
    parser.add_argument("result", help="pkl results of the test CLIs")
    parser.add_argument("out_dir")
    parser.add_argument("--ann", required=True, help="GT coco json")
    parser.add_argument("--img-prefix", default="")
    parser.add_argument("--types", nargs="+", default=["bbox"])
    parser.add_argument("--dataset-type", default="BONAI")
    parser.add_argument("--no-plots", action="store_true",
                        help="write the curves and maxF1score.txt only")
    args = parser.parse_args(argv)
    dataset = build_dataset(dict(
        type=args.dataset_type, ann_file=args.ann,
        img_prefix=args.img_prefix, test_mode=True,
        pipeline=[dict(type="LoadImageFromFile"),
                  dict(type="Collect", keys=["img"])]))
    with open(args.result, "rb") as f:
        payload = pickle.load(f)
    results = payload["results"] if isinstance(payload, dict) else payload
    dirs = analyze(results, dataset, args.out_dir, tuple(args.types),
                   with_f1=with_f1, plots=not args.no_plots)
    print("wrote " + ", ".join(dirs))


if __name__ == "__main__":
    main(with_f1=True)
