"""The port's long-run training path on the CPU at tiny widths: the
host-RSS watchdog (``host_rss_gb`` rows, ``BONAI_MAX_RSS_GB``, checkpoint
and exit 75) against the JAX loop's row and checkpoint meta, the chunked
wrapper (``python -m bonai_tpu_torch.tools.train_chunked``) driven through
restarts to the same weights, to the bit, as an unbroken run under
``--deterministic``, and ``checkpoint_config.max_keep_ckpts``.

Four 128^2 tiles at batch 2 make an epoch of 2 steps, read by the process
loader; the runs log every epoch, so each watchdog exit falls on an epoch
boundary (a resumed epoch replays from its first batch, in both
packages).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (ROOT, RUN2X, synth_data, synth_train_cfg,
                               tiny_train_cfg, train_batch)

STEPS, LOG = 7, 2


def _cli(module, *args, env=None):
    """Start ``python -m bonai_tpu_torch.tools.<module> args`` on one CPU
    thread (the runs go side by side; every run uses the same thread
    count, so their float sums split alike)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"bonai_tpu_torch.tools.{module}",
         *map(str, args)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


def _done(proc):
    out, err = proc.communicate()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _running(arg):
    """The live processes whose command line names ``arg`` (forked
    loader workers keep their parent's)."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if str(arg).encode() in f.read():
                    found.append(int(pid))
        except OSError:
            pass
    return found


def _rows(work_dir):
    with open(work_dir / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def _ckpts(work_dir):
    return sorted(int(p.stem.split("_")[1])
                  for p in (work_dir / "checkpoints").glob("step_*.pth"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train CLI stopped by the watchdog, the wrapper taking it to
    ``STEPS`` steps, and an unbroken run of the same steps."""
    tmp = tmp_path_factory.mktemp("train_long")
    cfg = synth_train_cfg(synth_data(tmp / "data", n=4, size=128))
    cfg.log_config.interval = LOG
    cfg.data.loader_mode = "process"
    cfg.dump(str(tmp / "tiny.py"))
    args = ["--device", "cpu", "--deterministic", "--max-steps", STEPS,
            "--options", "checkpoint_config.interval=1",
            "checkpoint_config.max_keep_ckpts=1"]
    low = {"BONAI_MAX_RSS_GB": "0.001"}
    chunked, unbroken = tmp / "chunked", tmp / "unbroken"
    whole = _cli("train", tmp / "tiny.py", "--work-dir", unbroken, *args)
    first = _done(_cli("train", tmp / "tiny.py", "--work-dir", chunked,
                       *args, env=low))
    left = _running(chunked)
    preempt = torch.load(chunked / "checkpoints" / f"step_{LOG}.pth",
                         map_location="cpu", weights_only=True)
    first_rows = _rows(chunked)
    wrapper = _done(_cli("train_chunked", tmp / "tiny.py", chunked, *args,
                         env=low))
    whole = _done(whole)
    return dict(first=first, left=left, preempt=preempt, first_rows=first_rows,
                wrapper=wrapper, whole=whole, chunked=chunked,
                unbroken=unbroken)


def test_watchdog_exits_75_at_the_first_log_interval(runs):
    from bonai_tpu.engine.checkpoint import provenance_meta as jax_meta
    first = runs["first"]
    assert first.returncode == 75, first.stderr[-2000:]
    assert "BONAI_MAX_RSS_GB" in first.stderr
    assert runs["left"] == []       # the process loader's workers are gone
    assert [r["iter"] for r in runs["first_rows"]] == [LOG]
    meta = runs["preempt"]["meta"]
    assert runs["preempt"]["step"] == LOG
    assert meta["epoch"] == 1 and meta["step"] == LOG
    assert meta["preempt_rss"] > 0.001
    assert meta["CLASSES"] == ["building"]
    # the JAX loop's preemption meta: epoch, step, preempt_rss and its
    # provenance, the version under the port's own package name
    jax_keys = {"epoch", "step", "preempt_rss"} | set(
        jax_meta({}, ("building",)))
    assert set(meta) == {k.replace("bonai_tpu_", "bonai_tpu_torch_")
                         for k in jax_keys}


def test_log_rows_carry_the_jax_rows_keys_and_rounding(runs):
    with open(os.path.join(RUN2X, "train_log.jsonl")) as f:
        jax_row = json.loads(f.readlines()[-1])     # a row with host_rss_gb
    for row in _rows(runs["unbroken"]):
        # data_time (the host's wait for the batch) is the port's one extra
        assert set(row) - {"data_time"} == set(jax_row)
        assert row["host_rss_gb"] > 0
        for k, places in (("time", 3), ("data_time", 3), ("host_rss_gb", 2),
                          ("loss", 4), ("grad_norm", 4), ("lr", 4)):
            assert row[k] == round(row[k], places), k


def test_chunked_wrapper_equals_an_unbroken_run_to_the_bit(runs):
    wrapper, whole = runs["wrapper"], runs["whole"]
    assert whole.returncode == 0, whole.stderr[-2000:]
    assert wrapper.returncode == 0, wrapper.stderr[-2000:]
    out = wrapper.stdout.splitlines()
    # resumed at steps 2 (the CLI's own exit), 4 and 6: two restarts
    assert sum("RSS-limit restart (rc=75)" in line for line in out) == 2
    assert [line.split("step_")[-1] for line in out
            if line.startswith("[train_chunked] attempt")] == [
                "2.pth'", "4.pth'", "6.pth'"]
    assert out[-1] == "[train_chunked] complete"
    chunked, unbroken = runs["chunked"], runs["unbroken"]
    rows_c, rows_u = _rows(chunked), _rows(unbroken)
    assert [r["iter"] for r in rows_c] == [r["iter"] for r in rows_u] == [
        2, 4, 6]
    skip = {"time", "data_time", "host_rss_gb"}
    for rc, ru in zip(rows_c, rows_u):
        assert {k: v for k, v in rc.items() if k not in skip} == {
            k: v for k, v in ru.items() if k not in skip}
    a, b = (torch.load(d / "checkpoints" / f"step_{STEPS}.pth",
                       map_location="cpu", weights_only=True)
            for d in (chunked, unbroken))
    assert a["step"] == b["step"] == STEPS
    assert a["meta"]["final"] and b["meta"]["final"]
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for sa, sb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        assert torch.equal(sa["momentum_buffer"], sb["momentum_buffer"])
    assert torch.equal(a["generator"], b["generator"])
    # max_keep_ckpts=1 at every epoch end: the unbroken run keeps its last
    # epoch's and its final; the chunked one saved no epoch end (each
    # attempt stopped at its first log row), and neither the preemption
    # nor the final saves prune
    assert _ckpts(unbroken) == [6, 7]
    assert _ckpts(chunked) == [2, 4, 6, 7]


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(2, 2)


@pytest.mark.parametrize("max_keep,expected", [
    (3, [3, 4, 5]), (1, [5]), (None, [1, 2, 3, 4, 5]), (-1, [1, 2, 3, 4, 5])])
def test_save_checkpoint_keeps_the_newest(tmp_path, max_keep, expected):
    from bonai_tpu_torch.engine import latest_checkpoint, save_checkpoint
    net = _Net()
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    (tmp_path / "checkpoints").mkdir()
    torn = tmp_path / "checkpoints" / "step_9.pth.123.tmp"   # a killed save
    torn.write_bytes(b"")
    for step in range(1, 6):
        save_checkpoint(tmp_path, step, net, opt, max_keep=max_keep)
    assert _ckpts(tmp_path) == expected and torn.exists()
    assert latest_checkpoint(tmp_path).endswith("step_5.pth")
    # neither the save just written nor the newest is ever pruned
    save_checkpoint(tmp_path, 2, net, opt, max_keep=max_keep)
    assert {2, 5} <= set(_ckpts(tmp_path))


def test_train_loop_keeps_the_newest_epochs_and_the_final(tmp_path):
    from bonai_tpu_torch.apis import train_detector
    cfg = tiny_train_cfg()
    cfg.checkpoint_config = dict(interval=1, max_keep_ckpts=2)
    _, hist = train_detector(cfg, [train_batch()], str(tmp_path),
                             max_steps=5, device="cpu", log_interval=5)
    # epoch ends at 1..4 kept the newest two; the final at 5 stays
    assert _ckpts(tmp_path) == [3, 4, 5]
    meta = torch.load(tmp_path / "checkpoints" / "step_5.pth",
                      map_location="cpu", weights_only=True)["meta"]
    assert meta["final"] and "preempt_rss" not in meta
    assert [h["iter"] for h in hist] == [5]
    assert np.isfinite(hist[0]["loss"]) and hist[0]["host_rss_gb"] > 0
