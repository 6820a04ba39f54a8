"""The record of the port's 2x synthetic run (``data/torch_run2x/``): the
train log is whole, and every chunk of the run started at an epoch
boundary.  Printed with ``-s``: each loss component's mean per epoch
beside the JAX run's (``data/synth_run2x/train_log.jsonl``), and the
port's step time, host wait and host RSS quartiles.

    python -m pytest tests/test_torch_port_run2x_record.py -q -s
"""

import json
import math
import os.path as osp
import re

import numpy as np

from torch_port_common import RUN2X, TORCH_RUN2X

STEPS, EPOCH_STEPS, LOG = 9600, 400, 10
LOSSES = ("loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
          "loss_mask", "loss_offset")
TABLE_EPOCHS = (1, 4, 8, 16, 17, 22, 24)


def lineage(path):
    """The rows of a train log that the finished run kept: a restarted run
    repeats the iterations after its checkpoint, and the last row of each
    iteration is the one its weights went on from."""
    with open(path) as f:
        rows = {}
        for line in f:
            r = json.loads(line)
            rows[r["iter"]] = r
    return [rows[k] for k in sorted(rows)]


def epoch_means(rows):
    by = {}
    for r in rows:
        by.setdefault(r["epoch"], []).append(r)
    return {e: {k: float(np.mean([r[k] for r in rs])) for k in LOSSES}
            for e, rs in by.items()}


def test_train_log_is_whole_and_no_chunk_resumed_mid_epoch():
    with open(osp.join(TORCH_RUN2X, "train_log.jsonl")) as f:
        raw = [json.loads(line) for line in f]
    # every chunk resumed at an epoch boundary, so no row repeats
    assert [r["iter"] for r in raw] == list(range(LOG, STEPS + 1, LOG))
    for r in raw:
        assert r["epoch"] == math.ceil(r["iter"] / EPOCH_STEPS)
        assert all(math.isfinite(r[k]) for k in LOSSES + ("grad_norm",))
    with open(osp.join(TORCH_RUN2X, "train_chunked.log")) as f:
        log = f.read()
    resumed = [int(s) for s in re.findall(
        r"\[train_chunked\] attempt \d+ resume='[^']*step_(\d+)\.pth'", log)]
    assert all(s % EPOCH_STEPS == 0 for s in resumed), resumed
    assert log.rstrip().endswith("[train_chunked] complete")

    port, jax = epoch_means(raw), epoch_means(
        lineage(osp.join(RUN2X, "train_log.jsonl")))
    assert sorted(port) == sorted(jax) == list(range(1, 25))
    print(f"\nchunks resumed at steps {resumed or 'none'}; per-epoch mean "
          f"of the logged rows, JAX / port:")
    print("epoch " + " ".join(f"{k:>17s}" for k in LOSSES))
    for e in TABLE_EPOCHS:
        print(f"{e:5d} " + " ".join(f"{jax[e][k]:8.4f}/{port[e][k]:<8.4f}"
                                    for k in LOSSES))
    for k in ("time", "data_time", "host_rss_gb"):
        q = np.percentile([r[k] for r in raw], [0, 25, 50, 75, 100])
        print(f"port {k} min/Q1/median/Q3/max " + "/".join(
            f"{v:.3f}" for v in q))
