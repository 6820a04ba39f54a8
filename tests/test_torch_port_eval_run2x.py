"""The port's evaluator on the whole recorded JAX 2x run (slow: about five
minutes of one CPU core, out of the tier-1 run).

The 40 val scenes of the acceptance set are generated again with the
port's generator (seed 77, 2048^2), and the run's checked-in merged
predictions (``data/synth_run2x/merged_r5_{roof,footprint}.csv``) are
scored against them with the port's evaluator only.  The counts must be
``data/synth_run2x/eval_merged_r5.csv``'s exactly, and aEPE within 0.001
px of it (the CSVs round the footprints, and so the recovered offsets,
to 0.01 px).

This file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -m slow \
        tests/test_torch_port_eval_run2x.py -s
"""

import csv
import os.path as osp
import time

import pytest

from bonai_tpu_torch.evaluation.bonai_eval import (offset_error_vector,
                                                   polygon_f1)
from bonai_tpu_torch.tools.bonai_evaluation import gt_records_from_json
from bonai_tpu_torch.tools.make_synthetic_bonai import write_scene_split
from torch_port_common import RUN2X, run2x_records, stem_keys


@pytest.mark.slow
def test_port_evaluator_reproduces_the_recorded_2x_run(tmp_path):
    with open(osp.join(RUN2X, "eval_merged_r5.csv"), newline="") as f:
        header, row = list(csv.reader(f))
    recorded = dict(zip(header, row))
    t0 = time.perf_counter()
    write_scene_split(str(tmp_path), "val", 40, 77, scene_size=2048,
                      crop=1024)
    t1 = time.perf_counter()
    gt = stem_keys(gt_records_from_json(
        osp.join(tmp_path, "val_originals", "val_originals.json")))
    pred = run2x_records()
    assert len(pred) == len(gt) == 40
    got = {}
    for key, name in (("polygon", "roof"), ("footprint_polygon", "footprint")):
        metrics, matches = polygon_f1(pred, gt, key=key)
        got[name] = (metrics["tp"], metrics["fp"], metrics["fn"])
    aepe = offset_error_vector(pred, gt, matches)["aEPE"]
    t2 = time.perf_counter()
    print(f"\nrun2x merged: roof TP/FP/FN {got['roof']}, footprint "
          f"{got['footprint']}, aEPE {aepe!r}; generate {t1 - t0:.1f} s, "
          f"score {t2 - t1:.1f} s")
    for name in ("roof", "footprint"):
        assert got[name] == tuple(int(recorded[f"{name}_{k}"])
                                  for k in ("tp", "fp", "fn")), name
    assert got["roof"] == (1375, 167, 128)
    assert got["footprint"] == (1373, 177, 125)
    assert abs(aepe - float(recorded["aEPE"])) <= 1e-3
