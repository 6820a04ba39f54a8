"""The R-CNN baselines on BONAI in bonai_tpu_torch against the JAX package,
at the tiny widths of ``torch_port_common`` in float32 on the CPU: Mask
R-CNN (``configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py``), Faster R-CNN
(the Dynamic R-CNN config as a plain ``FasterRCNN``: no mask head) and
Dynamic R-CNN (``configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py``);
the builder's types; Dynamic R-CNN's statistics, host schedule and
data-parallel step; weights; the test and evaluation CLIs on a 2-tuple
pkl; and the mask-head gradient gap of a LOFT batch.

Tolerances: detections as in ``test_torch_port_detector.py`` (boxes
1e-3 px, scores and mask probabilities 1e-4); each loss 1e-4 relative;
each gradient 1e-4 of its tensor's largest magnitude, as in
``test_torch_port_train.py``; Dynamic R-CNN's ``stat_dyn_iou`` and
``stat_dyn_beta`` 1e-6; the schedule's thresholds exact; weights and CSVs
exact.

The Mask R-CNN's seeded weights are those of seed 1: at seed 0 its tiny
head scores only 3 boxes above ``score_thr``, too few to compare.
"""

import importlib.util
import logging
import os.path as osp
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (DYNAMIC_CONFIG, MASK_RCNN_CONFIG, ROOT,
                               SYNTH_CONFIG, jax_forward_train_draws,
                               jax_model, port_model, synth_data, t,
                               tiny_train_cfg, train_batch)

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)
# given Dynamic R-CNN thresholds of a batch (the host schedule's inputs)
DYN_BATCH = dict(dyn_iou_thr=np.float32(0.45), dyn_beta=np.float32(0.5))
FAMILIES = ("mask_rcnn", "faster_rcnn", "dynamic_rcnn")
WEIGHT_SEED = {"mask_rcnn": 1, "faster_rcnn": 0, "dynamic_rcnn": 0}
CONFIGS = {"mask_rcnn": MASK_RCNN_CONFIG,
           "cascade": tpc.CASCADE_CONFIG, "dynamic_rcnn": DYNAMIC_CONFIG}


def family_cfg(family):
    """The tiny training config of ``family``: Faster R-CNN is the Dynamic
    R-CNN config without ``dynamic_rcnn``; Dynamic R-CNN takes its
    statistics at ``iou_topk`` 8 and ``beta_topk`` 8 (of 32 proposals, and
    past the 10 GTs that the sampler adds as zero-target positives)."""
    cfg = tiny_train_cfg(MASK_RCNN_CONFIG if family == "mask_rcnn"
                         else DYNAMIC_CONFIG)
    if family == "faster_rcnn":
        cfg.model.type = "FasterRCNN"
        cfg.train_cfg.rcnn.pop("dynamic_rcnn")
    elif family == "dynamic_rcnn":
        cfg.train_cfg.rcnn.dynamic_rcnn.update(iou_topk=8, beta_topk=8)
    return cfg


_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables)`` of ``family``, built once."""
    if family not in _MODELS:
        cfg = family_cfg(family)
        _MODELS[family] = (cfg, *jax_model(cfg, seed=WEIGHT_SEED[family]))
    return _MODELS[family]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_build_at_full_width(name):
    """``build_detector`` builds the shipped config: the box head (a
    cascade's three class-agnostic stages with their coders), the mask head
    where the config has one, no offset head."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    cfg = Config.fromfile(CONFIGS[name])
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert type(model).__name__ == cfg.model.type
    heads = model.roi_head["bbox_head"]
    if name == "cascade":
        assert [h.fc_reg.out_features for h in heads] == [4, 4, 4]
        assert [c["target_stds"] for c in model.bbox_coders] == [
            [0.1, 0.1, 0.2, 0.2], [0.05, 0.05, 0.1, 0.1],
            [0.033, 0.033, 0.067, 0.067]]
        assert model.stage_loss_weights == [1, 0.5, 0.25]
    else:
        assert heads.shared_fcs[0].weight.shape == (1024, 256 * 49)
        assert heads.fc_cls.out_features == 2
    assert model.with_mask == (name != "dynamic_rcnn")
    assert "offset_head" not in model.roi_head
    assert model.roi_align_impl == (
        "block" if name == "mask_rcnn" else None)


@pytest.mark.parametrize("change,item", [
    (dict(type="HybridTaskCascade"), "A7"), (dict(type="HTC"), "A7"),
    (dict(type="GridRCNN"), "A7"), (dict(type="PointRend"), "A7"),
    (dict(type="RPN"), "A7"), (dict(type="FastRCNN"), "A7"),
    (dict(type="RetinaNet"), "A6"), (dict(type="FCOS"), "A6"),
    (dict(type="MaskScoringRCNN", mask_iou_head=dict(num_convs=4)), "A7"),
    (dict(loss_bbox=dict(type="BalancedL1Loss")), "A7"),
    (dict(loss_bbox=dict(type="GIoULoss")), "A7"),
    (dict(config="libra_rcnn/libra_faster_rcnn_r50_fpn_1x_bonai.py"), "A7")],
    ids=lambda x: x if isinstance(x, str) else "-".join(
        str(v.get("type", v)) if isinstance(v, dict) else str(v)
        for v in x.values()))
def test_unported_types_name_their_item(change, item):
    """A detector, head or loss type the port does not build, or a whole
    config (Libra R-CNN's chained ``[FPN, BFP]`` neck)."""
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    change = dict(change)
    if "config" in change:
        cfg = Config.fromfile(osp.join(ROOT, "configs", change.pop("config")))
    else:
        cfg = family_cfg("mask_rcnn")
    if "type" in change:
        cfg.model.type = change.pop("type")
    if "mask_iou_head" in change:
        cfg.model.roi_head.mask_iou_head = change.pop("mask_iou_head")
    cfg.model.roi_head.bbox_head.update(change)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md item {item}"):
        build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)


def test_smooth_l1_config_trains_with_the_l1_loss():
    """A ``SmoothL1Loss`` box loss builds, and trains with L1 as the JAX
    package's inline path does (ROADMAP.md queue C)."""
    from bonai_tpu_torch.models import build_detector
    cfg = family_cfg("faster_rcnn")
    l1 = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    cfg.model.roi_head.bbox_head.loss_bbox = dict(type="SmoothL1Loss",
                                                  beta=1.0 / 9.0)
    smooth = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    smooth.load_state_dict(l1.state_dict())
    batch = {k: t(v) for k, v in train_batch().items()}
    draws = [tpc.replay_draws(_recorded_draws(l1, batch)) for _ in range(2)]
    with torch.no_grad():
        a = l1.forward_train(batch, draws[0])
        b = smooth.forward_train(batch, draws[1])
    assert float(a["loss_bbox"]) > 0
    assert float(a["loss_bbox"]) == float(b["loss_bbox"])


def _recorded_draws(model, batch):
    pairs = []
    gen = torch.Generator().manual_seed(0)
    from bonai_tpu_torch.core.samplers import generator_draws
    draw = generator_draws(gen)

    def recording(shape, device):
        pairs.append(tuple(u.numpy() for u in draw(shape, device)))
        return tuple(torch.from_numpy(u) for u in pairs[-1])
    with torch.no_grad():
        model.forward_train(batch, recording)
    return pairs


@pytest.mark.parametrize("family", ["mask_rcnn", "faster_rcnn"])
def test_simple_test_matches_jax(family):
    """Dynamic R-CNN serves as the Faster R-CNN it is."""
    cfg, jm, variables = models(family)
    pm = port_model(cfg, variables)
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = jax.device_get(jax.jit(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"))(variables, image, IMG_SHAPE,
                                           SCALE))
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {"det_bboxes", "det_scores",
                                    "det_labels", "det_valid"} | (
        {"mask_probs"} if family == "mask_rcnn" else set())
    compare_detections(got, ref)


def compare_detections(got, ref):
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    for key, tol in (("det_bboxes", 1e-3), ("det_scores", 1e-4),
                     ("mask_probs", 1e-4)):
        if key in ref:
            np.testing.assert_allclose(got[key].numpy()[valid],
                                       np.asarray(ref[key])[valid],
                                       rtol=1e-4, atol=tol, err_msg=key)


def jax_losses_and_grads(jm, variables, batch, key):
    """JAX's loss dict of ``batch`` under ``key`` and the gradient of the
    sum of its losses (not its ``stat_*``), as the port's state dict."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method="forward_train",
                          rngs={"sampling": key})
        return sum(v for k, v in losses.items()
                   if not k.startswith("stat_")), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"], batch)
    return ({k: float(v) for k, v in jax.device_get(ref).items()},
            state_dict_from_jax(jax.device_get(grads),
                                variables["batch_stats"]))


def port_losses(pm, batch, draw):
    """The port's loss dict (floats) after the backward of its losses."""
    got = pm.forward_train({k: t(v) for k, v in batch.items()}, draw)
    sum(v for k, v in got.items() if not k.startswith("stat_")).backward()
    return {k: float(v.detach()) for k, v in got.items()}


def check_gradients(pm, ref_grads):
    trainable = 0
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        trainable += 1
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    return trainable


_TRAINED = {}


def trained(family):
    """JAX's and the port's losses and gradients of one batch (Dynamic
    R-CNN's with the given thresholds ``DYN_BATCH``), once."""
    if family not in _TRAINED:
        cfg, jm, variables = models(family)
        batch = train_batch()
        if family == "dynamic_rcnn":
            batch.update(DYN_BATCH)
        key = jax.random.PRNGKey(3)
        ref, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
        pm = port_model(cfg, variables)
        got = port_losses(pm, batch, jax_forward_train_draws(
            jm, variables, key, 2))
        _TRAINED[family] = (ref, got, ref_grads, pm)
    return _TRAINED[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_train_losses_match_jax(family):
    ref, got, _, _ = trained(family)
    losses = {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"}
    stats = {"stat_dyn_iou", "stat_dyn_beta"}
    assert set(got) == set(ref) == losses | (
        {"loss_mask"} if family == "mask_rcnn" else set()) | (
        stats if family == "dynamic_rcnn" else set())
    for k in ref:
        if k.startswith("stat_"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            assert got[k] > 0, k
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                       err_msg=k)


def test_dynamic_stats_are_not_trivial():
    """The given thresholds reach the step: the statistics are inside their
    ranges and the box loss is SmoothL1 at beta 0.5, not L1."""
    ref, got, _, _ = trained("dynamic_rcnn")
    assert 0.0 < got["stat_dyn_iou"] < 1.0
    assert 0.0 < got["stat_dyn_beta"]
    plain, _, _, _ = trained("faster_rcnn")
    assert got["loss_cls"] != plain["loss_cls"]     # other thresholds
    assert got["loss_bbox"] < plain["loss_bbox"]


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    _, _, ref_grads, pm = trained(family)
    assert check_gradients(pm, ref_grads) > 40
    if family == "mask_rcnn":
        assert float(pm.roi_head["mask_head"].conv_logits.weight.grad
                     .abs().max()) > 0


# ---------------------------------------------------------------------------
# Dynamic R-CNN's host schedule
# ---------------------------------------------------------------------------

IOUS = [0.31, 0.52, 0.47, 0.66, 0.2, 0.1]
BETAS = [0.8, -1.0, 0.3, 0.55, 2.5, -1.0]


class _IndexDataset:
    CLASSES = ("building",)

    def __len__(self):
        return 16

    def prepare(self, idx, rng):
        return dict(img=np.full((64, 64, 3), idx, np.uint8),
                    img_shape=(64, 64, 3),
                    gt_bboxes=np.array([[4, 4, 30, 30]], np.float32),
                    gt_labels=np.zeros(1, np.int64))


def test_dynamic_schedule_matches_jax(tmp_path, monkeypatch):
    """The JAX ``train_detector``'s own loop, its step replaced by one that
    returns the statistics ``IOUS``/``BETAS`` (its compiled step cannot take
    the schedule's scalars: ROADMAP.md queue C), records the thresholds it
    feeds each step at ``update_iter_interval`` 2; the port's schedule fed
    the same statistics feeds the same thresholds, exactly, and logs the
    same update lines."""
    import bonai_tpu.apis.train as jax_train
    cfg = family_cfg("dynamic_rcnn")
    cfg.train_cfg.rcnn.dynamic_rcnn.update_iter_interval = 2
    cfg.model.pretrained = None
    cfg.log_config = dict(interval=1)
    fed = []

    def fake_make_train_step(*args, **kwargs):
        def step(state, batch, rng):
            i = len(fed)
            fed.append((float(batch["dyn_iou_thr"]),
                        float(batch["dyn_beta"])))
            return state, {"stat_dyn_iou": IOUS[i], "stat_dyn_beta": BETAS[i],
                           "loss": 0.0}
        return step

    monkeypatch.setattr(jax_train, "make_train_step", fake_make_train_step)
    jax_train.train_detector(cfg, str(tmp_path), max_steps=len(IOUS),
                             n_devices=1, dataset=_IndexDataset())
    assert len(fed) == len(IOUS)
    from bonai_tpu_torch.apis.train import DynamicRCNNSchedule
    sched = DynamicRCNNSchedule.of(cfg)
    got = []
    for iou, beta in zip(IOUS, BETAS):
        batch = sched.feed({})
        got.append((float(batch["dyn_iou_thr"]), float(batch["dyn_beta"])))
        assert batch["dyn_iou_thr"].dtype == np.float32
        metrics = dict(stat_dyn_iou=torch.tensor(iou),
                       stat_dyn_beta=torch.tensor(beta), loss=0.0)
        sched.update(metrics)
        assert set(metrics) == {"loss"}
    assert got == fed
    assert len(set(got)) == 3                   # two updates moved them


def test_dynamic_schedule_keeps_beta_at_a_zero_median():
    """Where the median of the beta statistics is 0 (the GTs among the
    positives have zero targets), beta stays, as mmdetection keeps it; the
    JAX loop would set beta 0 and the SmoothL1 gradient would be NaN
    (ROADMAP.md queue C).  The IoU threshold still moves."""
    from bonai_tpu_torch.apis.train import DynamicRCNNSchedule
    sched = DynamicRCNNSchedule(dict(update_iter_interval=2,
                                     initial_beta=1.0, initial_iou=0.4))
    for iou, beta in ((0.5, 0.0), (0.7, 0.0), (0.5, 0.0), (0.5, 0.8)):
        sched.update(dict(stat_dyn_iou=iou, stat_dyn_beta=beta))
    assert sched.iou_thr == 0.5 and sched.beta == 0.4


def test_train_detector_runs_the_dynamic_schedule(tmp_path, caplog):
    """Four steps of the tiny Dynamic R-CNN at ``update_iter_interval`` 2:
    two update lines, finite losses, no statistic in the log rows."""
    from bonai_tpu_torch.apis import train_detector
    cfg = family_cfg("dynamic_rcnn")
    cfg.train_cfg.rcnn.dynamic_rcnn.update_iter_interval = 2
    with caplog.at_level(logging.INFO, logger="bonai_tpu_torch"):
        _, hist = train_detector(cfg, [train_batch()], str(tmp_path),
                                 max_steps=4, device="cpu", log_interval=1)
    updates = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("dynamic-rcnn update")]
    assert len(updates) == 2, updates
    assert len(hist) == 4 and not any(k.startswith("stat_")
                                      for h in hist for k in h)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)


def test_two_rank_dynamic_step_matches_the_mesh_step(tmp_path):
    """Two gloo ranks of the Dynamic R-CNN step (DDP, each rank its image
    and its shard's JAX draws) against the JAX 2-device mesh step from the
    same weights: the losses (``pmean``ed) and ``grad_norm`` to 1e-4, and
    ``stat_dyn_iou`` to 1e-6 (a mean over images, which the ``pmean`` of
    two one-image means is).  ``stat_dyn_beta`` is the order statistic of
    the union of the ranks' positives: it equals, to 1e-6, the port's
    one-process step on the global batch with the same draws, whose
    statistic is held to the JAX single-device step above.  (The mesh step
    averages the ranks' own order statistics instead: ROADMAP.md queue
    C.)"""
    from bonai_tpu import engine as jax_engine
    from bonai_tpu.engine.optim import build_lr_schedule as jax_schedule
    from bonai_tpu.engine.optim import build_optimizer as jax_optimizer
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu.engine.train_step import make_mesh
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis.train import rank_rows
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    _, jm, variables = models("dynamic_rcnn")
    cfg = family_cfg("dynamic_rcnn")
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.optimizer.lr = 0.2
    params = variables["params"]
    schedule = jax_schedule(cfg.optimizer.lr, 100, [], 24, warmup=None)
    tx = jax_optimizer(dict(cfg.optimizer), schedule,
                       dict(cfg.optimizer_config.grad_clip),
                       frozen_mask_from_model(
                           params, cfg.model.backbone.frozen_stages))
    state = jax_engine.create_train_state(params, variables["batch_stats"],
                                          tx)
    step = jax_engine.make_train_step(jm, tx, mesh=make_mesh(2),
                                      donate=False, lr_schedule=schedule)
    key = jax.random.PRNGKey(3)
    batch = train_batch()
    _, metrics = step(state, batch, key)
    ref = {k: float(v) for k, v in jax.device_get(metrics).items()}
    inputs = {f"sd/{k}": v.numpy() for k, v in state_dict_from_jax(
        params, variables["batch_stats"]).items()}
    inputs.update({f"batch/0/{k}": v for k, v in batch.items()})
    draws = [[], []]
    for r in range(2):
        sampling = jax.random.fold_in(jax.random.fold_in(key, r), 0)
        jax_draw = jax_forward_train_draws(jm, variables, sampling, 1)
        pm = port_model(cfg, variables)

        def draw(shape, device, jax_draw=jax_draw, r=r):
            draws[r].append(jax_draw(shape, device))
            return draws[r][-1]
        with torch.no_grad():
            pm.forward_train({k: t(v) for k, v in rank_rows(
                batch, r, 2).items()}, draw)
        for i, (u_pos, u_neg) in enumerate(draws[r]):
            inputs[f"draw/{r}/0/{i}/pos"] = u_pos.numpy()
            inputs[f"draw/{r}/0/{i}/neg"] = u_neg.numpy()
    np.savez(tmp_path / "inputs.npz", **inputs)
    rc = parallel.launch(tpc.ddp_step_rank, 2, "cpu",
                         str(tmp_path / "inputs.npz"), str(tmp_path), cfg,
                         work_dir=str(tmp_path), timeout=300)
    assert rc == 0
    got = np.load(tmp_path / "rank0.npz")
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
              "loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"metrics/0/{k}"]), ref[k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got["metrics/0/stat_dyn_iou"]),
                               ref["stat_dyn_iou"], rtol=0, atol=1e-6)
    # the union: one process, the global batch, the ranks' draws per image
    union = [tuple(torch.cat([draws[0][i][j], draws[1][i][j]])
                   for j in range(2)) for i in range(2)]
    pm = port_model(cfg, variables)
    with torch.no_grad():
        one = pm.forward_train({k: t(v) for k, v in batch.items()},
                               tpc.replay_draws([tuple(u.numpy() for u in p)
                                                 for p in union]))
    assert float(one["stat_dyn_beta"]) > 0
    np.testing.assert_allclose(float(got["metrics/0/stat_dyn_beta"]),
                               float(one["stat_dyn_beta"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(got["metrics/0/stat_dyn_iou"]),
                               float(one["stat_dyn_iou"]), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# weights, the test path, and the mask-head gradient gap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["mask_rcnn", "faster_rcnn"])
def test_weight_round_trip(family, tmp_path):
    """``state_dict_from_jax`` gives mmdet's keys, with no offset head and,
    for Faster R-CNN, no mask head; the port loads them strictly and gives
    them back unchanged; the JAX importer reads every one back exactly;
    and ``init_detector`` loads them from an mmdet-style ``.pth``
    (``{"state_dict": ..., "meta": ...}``) through
    ``load_mmdet_checkpoint``.  256-channel heads: the importer's first-FC
    reorder assumes C=256."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = family_cfg(family)
    m = cfg.model
    m.neck.out_channels = 256
    m.rpn_head.update(in_channels=256, feat_channels=32)
    m.roi_head.bbox_head.in_channels = 256
    if family == "mask_rcnn":
        m.roi_head.mask_head.in_channels = 256
    _, variables = jax_model(cfg)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    heads = {k.split(".")[1] for k in sd if k.startswith("roi_head.")}
    assert heads == {"bbox_head"} | (
        {"mask_head"} if family == "mask_rcnn" else set())
    pm = port_model(cfg, variables)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats = mmdet_checkpoint_to_params(
        {k: v.numpy() for k, v in sd.items()}, zeros["params"],
        zeros["batch_stats"])
    got = jax.tree_util.tree_leaves_with_path({"params": params,
                                               "batch_stats": stats})
    ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(got) == len(ref)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), ref[path],
                                      err_msg=jax.tree_util.keystr(path))
    pth = tmp_path / "mmdet.pth"
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, pth)
    loaded = init_detector(cfg, str(pth), device="cpu", dtype=torch.float32)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_boxes_only_results_match_the_jax_layout():
    """A mask-free detector's padded outputs become, per image, the
    per-class list of ``(n, 5)`` arrays alone, as the JAX test path writes
    them."""
    from bonai_tpu.apis.test import results_to_host as jax_results_to_host
    from bonai_tpu_torch.apis.test import results_to_host
    r = np.random.RandomState(0)
    out = {"det_bboxes": r.uniform(0, 100, (2, 6, 4)).astype(np.float32),
           "det_scores": r.uniform(0, 1, (2, 6)).astype(np.float32),
           "det_labels": np.zeros((2, 6), np.int32),
           "det_valid": r.uniform(size=(2, 6)) > 0.3}
    metas = [dict(ori_shape=(100, 100))] * 2
    got = results_to_host({k: t(v) for k, v in out.items()}, metas)
    ref = jax_results_to_host(out, metas)
    assert len(got) == len(ref) == 2
    for g, w in zip(got, ref):
        assert isinstance(g, list) and isinstance(w, list) and len(g) == 1
        np.testing.assert_array_equal(g[0], w[0])


def _jax_eval_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_bonai_evaluation",
        osp.join(ROOT, "tools", "bonai", "bonai_evaluation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mask_rcnn_pkl_through_both_clis(tmp_path, monkeypatch):
    """The tiny Mask R-CNN on four 128^2 synthetic tiles through the
    port's test CLI (``--device cpu``): ``(bbox, segm)`` 2-tuples with as
    many boxes as the JAX ``run_inference`` finds, boxes within 1e-4; then
    the port's and the JAX evaluation CLIs score the pkl to the same CSVs
    (no offsets: each footprint is its roof).  The mask logits' bias is
    raised by 2 so that the random masks cover their boxes."""
    from bonai_tpu.apis import run_inference as jax_run_inference
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.engine import save_checkpoint
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    data = synth_data(tmp_path / "synth", n=4, size=128)
    _, jm, variables = models("mask_rcnn")
    # the mask logits' bias raised by 2: the random head's masks then cover
    # their boxes and give the CLIs roofs to score
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["params"]["mask_head"]["conv_logits"]["bias"] += 2.0
    cfg = family_cfg("mask_rcnn")
    test = cfg.data.test
    test.ann_file = osp.join(data, "train", "train.json")
    test.img_prefix = osp.join(data, "train", "images") + "/"
    test.pipeline[1].img_scale = (128, 128)
    cfg.compute_dtype = "float32"
    cfg_path = str(tmp_path / "tiny_mask_rcnn.py")
    cfg.dump(cfg_path)
    pm = port_model(cfg, variables)
    ckpt = save_checkpoint(str(tmp_path / "wd"), 1, pm,
                           torch.optim.SGD(pm.parameters(), lr=0.1))
    pkl = str(tmp_path / "port.pkl")
    payload = bonai_test.main([cfg_path, ckpt, "--out", pkl, "--city",
                               "config", "--device", "cpu"])
    ref = jax_run_inference(jm, variables, jax_build_dataloader(
        jax_build_dataset(dict(test, test_mode=True)), 2, shuffle=False,
        train=False), progress=False)
    assert len(payload["results"]) == len(ref) == 4
    for got, want in zip(payload["results"], ref):
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        assert len(got[1][0]) == len(got[0][0])
        np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-4,
                                   atol=1e-4)
    ann = test.ann_file
    args = ["--gt-json", ann, "--score-thr", "0.05", "--min-area", "20"]
    outs = []
    for name in ("port", "jax"):
        prefix = str(tmp_path / name)
        argv = [pkl, *args, "--csv-prefix", prefix,
                "--out-csv", prefix + "_summary.csv"]
        if name == "port":
            summary = bonai_evaluation.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["bonai_evaluation.py", *argv])
            _jax_eval_cli().main()
        outs.append([open(prefix + s, "rb").read() for s in (
            "_summary.csv", "_roof.csv", "_footprint.csv")])
    assert outs[0] == outs[1]
    assert len(outs[0][1].splitlines()) > 3            # roof rows scored
    assert outs[0][1] == outs[0][2]         # each footprint is its roof
    assert summary["roof_tp"] > 0


def test_mask_head_gap_is_one_relu_within_float_noise():
    """The mask-head gradient gap that ROADMAP.md queue C records.
    The first image of ``train_batch(seed=5)`` through the tiny 2x
    synthetic LOFT recipe with the JAX draws of ``fold_in(fold_in(
    PRNGKey(3), 0), 0)``: the port's ``mask_head.convs.0`` and
    ``upsample`` gradients differ from JAX's by about 4e-4 and 8e-4 of
    their largest element.  The two packages' pre-activations of the mask
    head's ReLUs differ in sign at one element only, the deconvolution's,
    whose input is within 1e-6 of 0 in both (float noise: the two compute
    the RoI features in other orders).  Run with JAX's activation pattern
    in the mask head's two ReLUs, the port's every gradient agrees with
    JAX's to 1e-5 of its largest element."""
    import torch.nn.functional as F
    cfg = tpc.ddp_train_cfg()
    jm, variables = jax_model(cfg)
    batch = {k: v[:1] for k, v in train_batch(seed=5).items()}
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 0), 0)
    _, ref_grads = jax_losses_and_grads(jm, variables, batch, key)
    _, inter = jax.jit(lambda v, b: jm.apply(
        v, b, method="forward_train", rngs={"sampling": key},
        capture_intermediates=True, mutable=["intermediates"]))(
        variables, batch)
    mh = inter["intermediates"]["mask_head"]
    ref_pre = [np.asarray(mh[m]["__call__"][0]).transpose(0, 3, 1, 2)
               for m in ("conv0", "upsample")]

    def run(pattern=None):
        pm = port_model(cfg, variables)
        head = pm.roi_head["mask_head"]
        pre = []

        def forward(x):
            x = x.permute(0, 3, 1, 2)
            for i, layer in enumerate((head.convs[0], head.upsample)):
                z = layer(x)
                pre.append(z.detach().numpy())
                x = F.relu(z) if pattern is None else z * pattern[i]
            return head.conv_logits(x).float()
        head.forward = forward
        port_losses(pm, batch, jax_forward_train_draws(jm, variables, key, 1))
        return pm, pre

    pm, pre = run()
    worst = {}
    for name, p in pm.named_parameters():
        if p.grad is not None:
            ref = ref_grads[name].numpy()
            worst[name] = (np.abs(p.grad.numpy() - ref).max()
                           / np.abs(ref).max())
    assert worst["roi_head.mask_head.upsample.weight"] > 4e-4
    assert worst["roi_head.mask_head.convs.0.conv.weight"] > 2e-4
    flips = [(a > 0) != (b > 0) for a, b in zip(pre, ref_pre)]
    assert [int(f.sum()) for f in flips] == [0, 1]
    for a, b in ((pre[1], ref_pre[1]),):
        assert np.abs(a[flips[1]]).max() < 1e-6 * np.abs(b).max()
        assert np.abs(b[flips[1]]).max() < 1e-6 * np.abs(b).max()
    pm, _ = run([torch.from_numpy(r > 0).float() for r in ref_pre])
    for name, p in pm.named_parameters():
        if p.grad is not None:
            ref = ref_grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)
