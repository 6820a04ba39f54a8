"""Data parallelism in bonai_tpu_torch (``parallel``, the rank loaders,
DDP in the train step, per-rank draws, checkpoints, the watchdog and
sharded testing) on the CPU: gloo ranks that ``parallel.launch`` spawns
(the rank functions are in ``torch_port_common`` and import torch only;
inputs and outputs go through files), held to the JAX package's
2-device mesh step and loaders.

Tolerances: each loss and the gradient norm to 1e-4 relative, each
updated weight to 1e-4 of its tensor's largest update, as in
``test_torch_port_train.py`` and ``test_torch_port_train_core.py``; the
sharded results as in ``test_torch_port_detector.py``; the loaders' rows
and the chunked run's weights exactly.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (ROOT, SYNTH_CONFIG, jax_forward_train_draws,
                               jax_model, port_model, synth_data,
                               synth_train_cfg, t, tiny_cfg, train_batch)

RANKS = 2


def _no_gt_on_rank1(batch):
    """The batch with rank 1's image (row 1) holding no valid GT."""
    batch = {k: v.copy() for k, v in batch.items()}
    batch["gt_valid"][1] = False
    batch["gt_bboxes"][1] = 0.0
    return batch


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    """The JAX mesh step over 2 of the 8 virtual CPU devices from the same
    state on two batches: ``train_batch()`` with rank 1's GT removed, and
    as it is; and the same two steps through two gloo ranks of the port
    (one after the other, so a DDP step after a rank without GT is
    covered, each from the same weights), each rank handed its shard's JAX
    draws for ``fold_in(fold_in(key, rank), step)``."""
    from bonai_tpu import engine as jax_engine
    from bonai_tpu.engine.optim import build_lr_schedule as jax_schedule
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu.engine.train_step import make_mesh
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis.train import rank_rows
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    tmp = tmp_path_factory.mktemp("ddp")
    cfg = tpc.ddp_train_cfg()
    jm, variables = jax_model(cfg)
    params = variables["params"]
    schedule = jax_schedule(cfg.optimizer.lr, 100, [], 24, warmup=None)
    tx = jax_optimizer(dict(cfg.optimizer), schedule,
                       dict(cfg.optimizer_config.grad_clip),
                       frozen_mask_from_model(params, -1))
    state = jax_engine.create_train_state(params, variables["batch_stats"],
                                          tx)
    step = jax_engine.make_train_step(jm, tx, mesh=make_mesh(RANKS),
                                      donate=False, lr_schedule=schedule)
    key = jax.random.PRNGKey(3)
    batches = [_no_gt_on_rank1(train_batch()), train_batch()]
    inputs = {f"sd/{k}": v.numpy() for k, v in state_dict_from_jax(
        params, variables["batch_stats"]).items()}
    recorder = port_model(cfg, variables)
    ref, after = [], []
    for s, batch in enumerate(batches):
        inputs.update({f"batch/{s}/{k}": v for k, v in batch.items()})
        for r in range(RANKS):
            sampling = jax.random.fold_in(jax.random.fold_in(key, r), 0)
            jax_draw = jax_forward_train_draws(jm, variables, sampling, 1)
            pairs = []

            def draw(shape, device, jax_draw=jax_draw, pairs=pairs):
                pairs.append(jax_draw(shape, device))
                return pairs[-1]
            with torch.no_grad():
                recorder.forward_train({k: t(v) for k, v in rank_rows(
                    batch, r, RANKS).items()}, draw)
            for i, (u_pos, u_neg) in enumerate(pairs):
                inputs[f"draw/{r}/{s}/{i}/pos"] = u_pos.numpy()
                inputs[f"draw/{r}/{s}/{i}/neg"] = u_neg.numpy()
        new, metrics = step(state, batch, key)
        ref.append({k: float(v) for k, v in jax.device_get(metrics).items()})
        after.append(state_dict_from_jax(jax.device_get(new.params),
                                         variables["batch_stats"]))
    np.savez(tmp / "inputs.npz", **inputs)
    rc = parallel.launch(tpc.ddp_step_rank, RANKS, "cpu",
                         str(tmp / "inputs.npz"), str(tmp),
                         work_dir=str(tmp), timeout=300)
    assert rc == 0
    got = [np.load(tmp / f"rank{r}.npz") for r in range(RANKS)]
    before = {k[3:]: inputs[k] for k in inputs if k.startswith("sd/")}
    return ref, got, before, after


@pytest.mark.parametrize("s", [0, 1], ids=["rank1_without_gt", "both_gt"])
def test_ddp_step_metrics_match_the_mesh_step(mesh_steps, s):
    """The losses averaged over the ranks (JAX ``pmean``s them), the
    global gradient norm after the gradient mean, and the LR."""
    ref, got, _, _ = mesh_steps
    keys = [k for k in ref[s] if k.startswith("loss")]
    assert len(keys) == 7
    for k in keys + ["grad_norm", "lr"]:
        np.testing.assert_allclose(float(got[0][f"metrics/{s}/{k}"]),
                                   ref[s][k], rtol=1e-4, err_msg=k)
    assert ref[s]["grad_norm"] > 0


@pytest.mark.parametrize("s", [0, 1], ids=["rank1_without_gt", "both_gt"])
def test_ddp_weights_match_the_mesh_step(mesh_steps, s):
    """Every parameter after the step, on both ranks (the ranks hold the
    same weights to the bit)."""
    _, got, before, after = mesh_steps
    names = [k.split("/", 2)[2] for k in got[0].files
             if k.startswith(f"sd/{s}/")]
    assert len(names) == len(after[s])
    moved = 0
    for name in names:
        w0, w1 = got[0][f"sd/{s}/{name}"], got[1][f"sd/{s}/{name}"]
        np.testing.assert_array_equal(w0, w1, err_msg=name)
        want = after[s][name].numpy()
        update = np.abs(want - before[name]).max()
        moved += update > 0
        np.testing.assert_allclose(w0, want, rtol=0,
                                   atol=1e-4 * max(update, 1e-6),
                                   err_msg=name)
    assert moved > 100


class _IndexDataset:
    """``prepare(idx, rng)`` -> a 4x4 image of value ``idx`` and one GT box
    whose corner holds a draw of ``rng``, so a batch shows its indices and
    its augmentation stream."""

    CLASSES = ("building",)

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def prepare(self, idx, rng):
        return dict(img=np.full((4, 4, 3), idx, np.uint8),
                    img_shape=(4, 4, 3),
                    gt_bboxes=np.array([[0, 0, 2, 2 + rng.rand()]],
                                       np.float32),
                    gt_labels=np.zeros(1, np.int64))


@pytest.mark.parametrize("world_size", [1, 2])
def test_rank_loaders_hold_the_jax_global_batch_rows(world_size):
    """Three epochs: rank ``r``'s batches hold the dataset indices of rows
    ``r*spg:(r+1)*spg`` of the JAX loader's global batch, step for step,
    and as many batches; rank 0's batches equal those rows to the bit (the
    augmentation draws included); ranks above 0 draw from their own
    stream."""
    from bonai_tpu.datasets.builder import build_dataloader as jax_loader
    from bonai_tpu_torch.datasets import build_dataloader
    ds, spg = _IndexDataset(23), 2
    ref = jax_loader(ds, samples_per_gpu=spg, num_devices=world_size,
                     seed=4, max_gt=4, inst_mask_size=8,
                     loader_mode="process")
    ranks = [build_dataloader(ds, samples_per_gpu=spg, seed=4, max_gt=4,
                              inst_mask_size=8, rank=r,
                              world_size=world_size)
             for r in range(world_size)]
    try:
        for epoch in range(3):
            for loader in [ref] + ranks:
                loader.set_epoch(epoch)
            want = [b for b, _ in ref]
            assert len(want) == 23 // (spg * world_size) == len(ranks[0])
            for r, loader in enumerate(ranks):
                got = [b for b, _ in loader]
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    rows = slice(r * spg, (r + 1) * spg)
                    np.testing.assert_array_equal(g["image"],
                                                  w["image"][rows])
                    if r == 0:
                        for k in w:
                            np.testing.assert_array_equal(g[k], w[k][rows],
                                                          err_msg=k)
                    else:
                        assert not np.array_equal(g["gt_bboxes"],
                                                  w["gt_bboxes"][rows])
    finally:
        ref._pool.shutdown()
        for loader in ranks:
            loader.close()


@pytest.mark.parametrize("lens", [(3, 3), (3, 2), (5, 5, 4, 4), (1,)])
def test_collect_results_shards_matches_jax(lens):
    from bonai_tpu.parallel import \
        collect_results_shards as jax_collect  # noqa: E501
    from bonai_tpu_torch.parallel import merge_shards
    shards = [[(s, j) for j in range(n)] for s, n in enumerate(lens)]
    for total in (sum(lens) - 1, sum(lens)):
        assert merge_shards(shards, total) == jax_collect(
            shards, total, num_shards=len(lens))


def test_collect_results_shards_at_one_rank_keeps_list_results():
    """At one rank the results come back as they are, cut to ``total``,
    also when each is a list (``results_to_host``'s bare ``bbox_results``
    without masks or offsets), which are not shards."""
    from bonai_tpu_torch.parallel import collect_results_shards
    results = [[np.full((1, 5), i, np.float32)] for i in range(4)]
    got = collect_results_shards(results, 3)
    assert len(got) == 3
    for i, r in enumerate(got):
        assert r is results[i]


def test_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    """The rehearsal that chip_smoke runs on the card, with two gloo ranks
    on the CPU at tiny width: both ranks' weights equal the mean-of-halves
    step within 1e-4 of each tensor's largest update, and weights move."""
    from bonai_tpu_torch.parallel.rehearsal import rehearse
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the spawned processes
    cfg = tpc.ddp_train_cfg()
    cfg.compute_dtype = "float32"
    report = rehearse(cfg, train_batch(), str(tmp_path), device="cpu",
                      timeout=300)
    assert report["worst"] <= 1e-4 and report["moved"] > 0
    assert len(report["ranks"]) == RANKS
    assert all(np.isfinite(r["metrics"]["loss"]) for r in report["ranks"])


def test_rank_seed_keeps_the_run_seed_on_rank_0():
    from bonai_tpu_torch.parallel import rank_seed
    assert rank_seed(7, 0) == 7
    seeds = {rank_seed(7, r) for r in range(1, 8)} | {rank_seed(8, 1)}
    assert len(seeds) == 8 and 7 not in seeds


@pytest.mark.parametrize("world_size", [1, 2, 4])
def test_auto_scale_lr_uses_the_global_batch(world_size):
    """The JAX ``train_detector``'s opt-in rule: lr times
    ``samples_per_gpu * W / base_batch_size``."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.apis.train import optimizer_cfg
    cfg = Config.fromfile(SYNTH_CONFIG)
    assert optimizer_cfg(cfg, world_size)["lr"] == cfg.optimizer.lr
    cfg.auto_scale_lr = dict(enable=True, base_batch_size=16)
    lr = cfg.optimizer.lr * (cfg.data.samples_per_gpu * world_size / 16)
    assert optimizer_cfg(cfg, world_size)["lr"] == lr


def test_run_inference_over_two_ranks_returns_the_one_rank_list(tmp_path):
    """Five tiles, two images a batch: each rank runs its wrap-padded
    shard and ``collect_results_shards`` gives every result in dataset
    order, as one rank does: boxes and offsets within 1e-3 px, scores
    within 1e-4 (the ranks batch other images together, which moves the
    float sums by an ulp), masks exactly."""
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis import run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    from bonai_tpu_torch.engine import save_checkpoint
    from bonai_tpu_torch.models import build_detector
    d = synth_data(tmp_path / "data", n=5, size=128)
    cfg = tiny_cfg(config=SYNTH_CONFIG)
    cfg.data.test.update(ann_file=d + "/train/train.json",
                         img_prefix=d + "/train/images/")
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(tmp_path / "wd"), 0, model, torch.optim.SGD(
        model.parameters(), lr=0.1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the ranks' float sums
    try:
        loader = build_dataloader(build_dataset(dict(cfg.data.test,
                                                     test_mode=True)),
                                  samples_per_gpu=2, shuffle=False,
                                  train=False)
        want = run_inference(model.eval(), loader, progress=False)
    finally:
        torch.set_num_threads(threads)
    rc = parallel.launch(tpc.infer_rank, RANKS, "cpu", cfg, ckpt,
                         str(tmp_path / "r.pkl"), work_dir=str(tmp_path),
                         timeout=300)
    assert rc == 0
    with open(tmp_path / "r.pkl", "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[0][0].shape == w[0][0].shape
        np.testing.assert_allclose(g[0][0][:, :4], w[0][0][:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g[0][0][:, 4], w[0][0][:, 4], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-3)
        assert g[1] == w[1]
    assert sum(len(w[0][0]) for w in want) > 0


@pytest.mark.parametrize("codes,rc", [((0, 0), 0), ((0, 75), 75),
                                      ((75, 75), 75), ((75, 3), 3)])
def test_launch_passes_the_ranks_exit_code_on(tmp_path, codes, rc):
    from bonai_tpu_torch import parallel
    assert parallel.launch(tpc.exit_rank, RANKS, "cpu", codes,
                           work_dir=str(tmp_path), timeout=60) == rc
    assert not [f for f in os.listdir(tmp_path) if "rendezvous" in f]


def test_train_detector_spawns_a_rank_per_device(tmp_path):
    """``train_detector(n_devices=2)`` outside a process group spawns two
    gloo ranks, each training on its row of the caller's global batches,
    and returns the final checkpoint's weights and the logged rows."""
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.engine import latest_checkpoint
    model, hist = train_detector(tpc.ddp_train_cfg(), [train_batch()],
                                 str(tmp_path), max_steps=2, device="cpu",
                                 log_interval=1, n_devices=RANKS)
    assert [h["iter"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    ckpt = torch.load(latest_checkpoint(str(tmp_path)), map_location="cpu",
                      weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["generators"]) == RANKS
    for k, v in model.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"][k]), k


@pytest.mark.parametrize("device,n_devices,cards,spawned", [
    ("cuda", None, 4, 4), ("cuda", None, 1, None), ("cuda", 1, 4, None),
    ("cuda", 2, 4, 2), ("cpu", None, 4, None), ("cpu", 2, 0, 2)])
def test_train_detector_spawns_only_above_one_rank(monkeypatch, tmp_path,
                                                   device, n_devices, cards,
                                                   spawned):
    """Outside a process group ``train_detector`` spawns its ranks when it
    has more than one: by default one per visible card (1 on the CPU);
    ``n_devices=1`` trains in this process on a host of several cards."""
    import bonai_tpu_torch.apis.train as api
    calls = []
    monkeypatch.setattr(api, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    monkeypatch.setattr(api.parallel, "rank_device", lambda d: d)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(api, "_spawn_train",
                        lambda *a: calls.append(("spawn", a[3])))
    monkeypatch.setattr(api, "_train",
                        lambda *a: calls.append(("here", None)))
    api.train_detector(tpc.ddp_train_cfg(), [], str(tmp_path),
                       device=device, n_devices=n_devices)
    assert calls == [("here", None) if spawned is None
                     else ("spawn", spawned)]


CARD_CODE = [Path(ROOT) / "chip_smoke.py",
             Path(ROOT) / "tests" / "test_torch_port_cuda.py"]


@pytest.mark.parametrize("path", CARD_CODE, ids=lambda p: p.name)
def test_in_process_train_detector_calls_on_the_card_pass_n_devices(path):
    """Every ``train_detector`` call on the card in the card tests and
    ``chip_smoke.py`` names its ``n_devices``: by default it would spawn a
    rank per card on a host of several, and the caller's kernel counters
    would stay 0."""
    import ast
    calls = [node for node in ast.walk(ast.parse(path.read_text()))
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "train_detector"]
    assert calls
    for call in calls:
        kw = {k.arg: k.value for k in call.keywords}
        on_cpu = getattr(kw.get("device"), "value", None) == "cpu"
        assert on_cpu or "n_devices" in kw, (path.name, call.lineno)


def test_rank_launches_reads_every_rank_s_log_line():
    """The launch counts that ``_log_run_end`` logs, one line per rank in
    either of the train CLI's log formats, back by rank."""
    from bonai_tpu_torch.ops import launch_counts
    from bonai_tpu_torch.apis.train import rank_launches
    counts = [dict(launch_counts(), roi_align_block=3 * r) for r in range(3)]
    lines = [f"2026-01-01 00:00:00 - bonai_tpu_torch - rank 0 - INFO - "
             f"rank {r} of 3: peak device memory 7.77 GiB "
             f"(max_memory_allocated); kernel launches {json.dumps(c)}"
             for r, c in reversed(list(enumerate(counts)))]
    assert rank_launches("\n".join(["noise"] + lines)) == counts
    assert set(counts[0]) == {"roi_align_block", "roi_align_block_backward",
                              "roi_align_fused", "roi_align_fused_backward",
                              "roi_align_strip"}


def _train_cfg(tmp_path, n=8):
    cfg = synth_train_cfg(synth_data(tmp_path / "data", n=n, size=128))
    cfg.log_config.interval = 2
    cfg.checkpoint_config.interval = 1
    return cfg


def test_watchdog_stops_every_rank_when_one_is_over(tmp_path, monkeypatch):
    """Rank 1 holds 1 GB more than rank 0 and the limit lies between them:
    both ranks checkpoint and exit 75 at the first log row, which logs the
    larger RSS."""
    from bonai_tpu_torch import parallel
    cfg = _train_cfg(tmp_path)
    monkeypatch.setenv("BONAI_MAX_RSS_GB", "1.0")
    work = tmp_path / "wd"
    rc = parallel.launch(tpc.ballast_train_rank, RANKS, "cpu", cfg,
                         str(work), 1.2, work_dir=str(work), timeout=300)
    assert rc == 75
    with open(work / "train_log.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows] == [2] and rows[0]["host_rss_gb"] > 1.0
    ckpt = torch.load(work / "checkpoints" / "step_2.pth",
                      map_location="cpu", weights_only=True)
    assert ckpt["meta"]["preempt_rss"] > 1.0
    assert len(ckpt["generators"]) == RANKS
    assert not torch.equal(ckpt["generators"][0], ckpt["generators"][1])


def _cli(module, *args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", f"bonai_tpu_torch.tools.{module}",
         *map(str, args)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))


@pytest.fixture(scope="module", autouse=True)
def cli_runs(tmp_path_factory):
    """Two two-rank runs of the train CLI to step 5, started before the
    other tests of this file so that they run alongside: ``train_chunked``
    under ``BONAI_MAX_RSS_GB=0.001``, and an unbroken run."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _train_cfg(tmp)
    cfg.dump(str(tmp / "tiny.py"))
    args = ["--device", "cpu", "--n-devices", RANKS, "--deterministic",
            "--max-steps", 5]
    procs = dict(
        unbroken=_cli("train", tmp / "tiny.py", "--work-dir",
                      tmp / "unbroken", *args),
        chunked=_cli("train_chunked", tmp / "tiny.py", tmp / "chunked",
                     *args, env={"BONAI_MAX_RSS_GB": "0.001"}))
    yield tmp, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_chunked_two_rank_run_equals_an_unbroken_one(cli_runs):
    """``train_chunked`` passes ``--n-devices 2`` on; the ranks exit 75 at
    step 2 (the first epoch's end, its first log row) and at step 4, the
    wrapper resumes both ranks each time (each with its own sampler
    state), and at step 5 the weights and every rank's generator equal an
    unbroken two-rank run's, to the bit (``--deterministic``)."""
    tmp, procs = cli_runs
    out, err = procs["chunked"].communicate(timeout=600)
    assert procs["chunked"].returncode == 0, err[-3000:]
    lines = out.splitlines()
    assert sum("RSS-limit restart (rc=75)" in x for x in lines) == 2
    assert lines[-1] == "[train_chunked] complete"
    _, err = procs["unbroken"].communicate(timeout=600)
    assert procs["unbroken"].returncode == 0, err[-3000:]
    a, b = (torch.load(tmp / d / "checkpoints" / "step_5.pth",
                       map_location="cpu", weights_only=True)
            for d in ("chunked", "unbroken"))
    assert a["step"] == b["step"] == 5
    for k, v in b["state_dict"].items():
        assert torch.equal(a["state_dict"][k], v), k
    assert len(a["generators"]) == len(b["generators"]) == RANKS
    for ga, gb in zip(a["generators"], b["generators"]):
        assert torch.equal(ga, gb)
