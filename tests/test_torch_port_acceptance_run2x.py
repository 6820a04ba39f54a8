"""The port's 2x synthetic run held to the JAX run (slow: about nine
minutes of one CPU core, out of the tier-1 run).

The 40 val scenes of the acceptance set are generated again with the
port's generator (seed 77, 2048^2).  Against them:

- the port's merged predictions (``data/torch_run2x/merged_{roof,
  footprint}.csv``) must score the counts of the committed
  ``data/torch_run2x/eval_merged.csv`` exactly, and its aEPE within 0.001
  px (the CSVs round the footprints, and so the offsets, to 0.01 px);
- for each run (the JAX run's ``data/synth_run2x/merged_r5_*.csv`` and the
  port's), each scene's roof and footprint TP/FP/FN and its offset errors'
  sum and count (the footprint pairs, as the evaluation CLI takes them)
  must sum to the run's merged counts: ``polygon_f1`` counts pairs per
  image, so the scenes add up;
- the scene bootstrap: 2000 resamples of the 40 scenes with replacement,
  each run resampled on its own (one ``numpy.random.default_rng(0)``, the
  JAX run's draws first), the counts pooled per resample; a metric's
  standard error ``SE`` for a run is its standard deviation over the
  resamples.  Merged roof F1, footprint F1 and aEPE each pass when
  ``|port - JAX| <= 2 * sqrt(SE_jax^2 + SE_port^2)``.  Per-crop scores are
  printed beside them, not gated (the JAX run's per-crop predictions are
  not in the repository).

It imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -m slow \
        tests/test_torch_port_acceptance_run2x.py -s
"""

import csv
import os.path as osp
import time

import numpy as np
import pytest

from bonai_tpu_torch.evaluation.bonai_eval import (offset_error_vector,
                                                   polygon_f1)
from bonai_tpu_torch.tools.bonai_evaluation import gt_records_from_json
from bonai_tpu_torch.tools.make_synthetic_bonai import write_scene_split
from torch_port_common import (RUN2X, TORCH_RUN2X, run2x_records,
                               stem_keys)

RESAMPLES = 2000
# columns of a run's per-scene counts
COLS = ("roof_tp", "roof_fp", "roof_fn", "footprint_tp", "footprint_fp",
        "footprint_fn", "epe_sum", "matched")


def _csv(path):
    with open(path, newline="") as f:
        header, row = list(csv.reader(f))
    return dict(zip(header, row))


def scene_counts(pred, gt):
    """``(scenes, len(COLS))``: each scene scored on its own."""
    rows = []
    for stem in sorted(gt):
        p, g = {stem: pred.get(stem, [])}, {stem: gt[stem]}
        row = []
        for key in ("polygon", "footprint_polygon"):
            m, matches = polygon_f1(p, g, key=key)
            row += [m["tp"], m["fp"], m["fn"]]
        off = offset_error_vector(p, g, matches)
        row += [off["aEPE"] * off["matched"] if off["matched"] else 0.0,
                off["matched"]]
        rows.append(row)
    return np.array(rows, np.float64)


def pooled_metrics(sums):
    """Roof F1, footprint F1 and aEPE of pooled counts ``(..., COLS)``, as
    ``polygon_f1`` and ``offset_error_vector`` compute them."""
    def f1(tp, fp, fn):
        p = tp / np.maximum(tp + fp, 1)
        r = tp / np.maximum(tp + fn, 1)
        return 2 * p * r / np.maximum(p + r, 1e-9)
    s = np.moveaxis(sums, -1, 0)
    return {"roof_f1": f1(*s[0:3]), "footprint_f1": f1(*s[3:6]),
            "aEPE": s[6] / np.maximum(s[7], 1)}


@pytest.mark.slow
def test_port_2x_run_is_within_the_scene_bootstrap_band(tmp_path):
    t0 = time.perf_counter()
    write_scene_split(str(tmp_path), "val", 40, 77, scene_size=2048,
                      crop=1024)
    gt = stem_keys(gt_records_from_json(
        osp.join(tmp_path, "val_originals", "val_originals.json")))
    runs = {"jax": run2x_records(),
            "port": run2x_records(TORCH_RUN2X, "merged")}
    recorded = {"jax": _csv(osp.join(RUN2X, "eval_merged_r5.csv")),
                "port": _csv(osp.join(TORCH_RUN2X, "eval_merged.csv"))}
    t1 = time.perf_counter()
    counts = {}
    for name, pred in runs.items():
        assert len(pred) <= len(gt) == 40 and set(pred) <= set(gt)
        c = counts[name] = scene_counts(pred, gt)
        total = dict(zip(COLS, c.sum(0)))
        # the scenes add up to the run's merged counts, as recorded
        for k in COLS[:6]:
            assert total[k] == int(recorded[name][k]), (name, k)
        assert total["matched"] == int(recorded[name]["matched"]), name
        assert abs(total["epe_sum"] / total["matched"]
                   - float(recorded[name]["aEPE"])) <= 1e-3, name
    t2 = time.perf_counter()

    rng = np.random.default_rng(0)
    point, se = {}, {}
    for name in ("jax", "port"):
        idx = rng.integers(0, 40, (RESAMPLES, 40))
        boot = pooled_metrics(counts[name][idx].sum(1))
        point[name] = {k: float(v) for k, v in
                       pooled_metrics(counts[name].sum(0)).items()}
        se[name] = {k: float(np.std(v, ddof=1)) for k, v in boot.items()}
    percrop = {"jax": _csv(osp.join(RUN2X, "eval_percrop_r5.csv")),
               "port": _csv(osp.join(TORCH_RUN2X, "eval_percrop.csv"))}
    print(f"\nscored in {t2 - t1:.1f} s (40 scenes, both runs; generated in "
          f"{t1 - t0:.1f} s); scene bootstrap, {RESAMPLES} resamples each:")
    failed = []
    for k in ("roof_f1", "footprint_f1", "aEPE"):
        band = 2 * np.hypot(se["jax"][k], se["port"][k])
        diff = point["port"][k] - point["jax"][k]
        ok = abs(diff) <= band
        failed += [] if ok else [k]
        print(f"  merged {k:12s} JAX {point['jax'][k]:.4f} (SE "
              f"{se['jax'][k]:.4f})  port {point['port'][k]:.4f} (SE "
              f"{se['port'][k]:.4f})  diff {diff:+.4f}  band +-{band:.4f}  "
              f"{'pass' if ok else 'FAIL'}")
        print(f"  per crop {k:10s} JAX {float(percrop['jax'][k]):.4f}  "
              f"port {float(percrop['port'][k]):.4f}  (not gated)")
    assert not failed, f"outside the band: {failed}"
