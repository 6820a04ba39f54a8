"""Proposals from files and Mask Scoring's results in bonai_tpu_torch
against the JAX package, on the CPU at tiny size: ``LoadProposals`` with
``Resize``/``RandomFlip`` and the loader's padding; the RPN -> proposal
file -> Fast R-CNN chain through the test CLI and ``train_detector``; the
Mask Scoring pkl layout and its COCO scoring.

Tolerances: the pipeline, the packing and the proposal file exact; the RPN
CLI's proposals within 1e-4 px of the JAX test loop's (scores 1e-5).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import a7_cfg, jax_model, port_model, synth_data, t

TILES = 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return synth_data(tmp_path_factory.mktemp("synth"), n=TILES, size=128)


def _tiles(split, data, size=128):
    """A data split (a config's train or test dict) reading the synthetic
    tiles, resized to ``size``^2."""
    split.ann_file = f"{data}/train/train.json"
    split.img_prefix = f"{data}/train/images/"
    for step in split.pipeline:
        if step.type == "Resize":
            step.img_scale = (size, size)
        if step.type == "MultiScaleFlipAug":
            step.img_scale = (size, size)


def _random_proposals(path, r, counts):
    props = []
    for n in counts:
        xy = r.uniform(-10, 120, (n, 2))
        wh = r.uniform(4, 60, (n, 2))
        props.append(np.concatenate([xy, xy + wh, r.rand(n, 1)], 1)
                     .astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump(props, f)
    return props


@pytest.mark.parametrize("seed", [0, 1])
def test_load_proposals_pipeline_matches_jax(data, tmp_path, seed):
    """``LoadProposals`` (cut to 40) -> ``Resize`` to 64^2 (scale 0.5,
    clipped) -> ``RandomFlip`` -> ``Collect`` -> the loader's padding (to
    2000), as the JAX pipeline gives them; both flips and no flip over the
    seeds.
    The port packs the proposals in test mode too, the JAX package for
    training only."""
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu.datasets.builder import pack_sample as jax_pack_sample
    from bonai_tpu_torch.datasets import build_dataset, pack_sample
    from bonai_tpu_torch.datasets.proposals import fast_rcnn_config
    props = _random_proposals(tmp_path / "p.pkl", np.random.RandomState(0),
                              [50, 12, 0, 41])
    cfg = a7_cfg("fast_rcnn", train=True)
    _tiles(cfg.data.train, data, size=64)
    fast_rcnn_config(cfg, str(tmp_path / "p.pkl"), num_max_proposals=40)
    port = build_dataset(copy.deepcopy(cfg.data.train))
    ref = jax_build_dataset(copy.deepcopy(dict(cfg.data.train)))
    assert len(port) == len(ref) == TILES
    flips = []
    for i in range(TILES):
        got = port.prepare(i, np.random.RandomState(5 * seed + i))
        want = ref.prepare(i, np.random.RandomState(5 * seed + i))
        flips.append(got["flip_direction"])
        assert got["flip_direction"] == want["flip_direction"]
        for k in ("proposals", "gt_bboxes", "scale_factor"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(got["proposals"]) == min(len(props[i]), 40)
        packed, _ = pack_sample(got, 64, 112)
        packed_ref, _ = jax_pack_sample(want, 64, 112)
        for k in ("proposals", "proposals_valid"):
            np.testing.assert_array_equal(packed[k], packed_ref[k])
        # Collect drops LoadProposals' cap in both: the loader pads to 2000
        assert packed["proposals"].shape == (2000, 4)
        assert int(packed["proposals_valid"].sum()) == len(got["proposals"])
        test_packed, _ = pack_sample(got, 64, 112, train=False)
        np.testing.assert_array_equal(test_packed["proposals"],
                                      packed["proposals"])
        assert "proposals" not in jax_pack_sample(want, 64, 112,
                                                  train=False)[0]
    assert len(set(flips)) > 1


def test_rpn_to_fast_rcnn_chain(data, tmp_path):
    """The RPN's checkpoint through the test CLI on the four tiles (the
    proposals within 1e-4 px of the JAX test loop's), ``AR@N`` through
    ``CocoDataset.evaluate``, the pkl made a proposal file, a Fast R-CNN
    trained 2 steps from the files by ``train_detector`` and tested by the
    test CLI with ``--eval bbox`` on the file's proposals (another file
    gives other detections).  The JAX test loop calls ``simple_test``
    without proposals, so it cannot test a Fast R-CNN (ROADMAP.md queue
    C)."""
    from bonai_tpu.apis import run_inference as jax_run_inference
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.datasets.proposals import (fast_rcnn_config,
                                                    write_proposal_file)
    from bonai_tpu_torch.engine import latest_checkpoint, save_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    rpn = a7_cfg("rpn")
    _tiles(rpn.data.test, data)
    rpn.compute_dtype = "float32"
    rpn.dump(str(tmp_path / "rpn.py"))
    jm, variables = jax_model(rpn, seed=1)
    pm = port_model(rpn, variables)
    ckpt = save_checkpoint(str(tmp_path / "wd_rpn"), 1, pm,
                           torch.optim.SGD(pm.parameters(), lr=0.1))
    rpn_pkl = str(tmp_path / "rpn.pkl")
    results, _ = test_cli.main([str(tmp_path / "rpn.py"), ckpt, "--out",
                                rpn_pkl, "--device", "cpu"])
    test_split = dict(rpn.data.test, test_mode=True)
    ref = jax_run_inference(jm, variables, jax_build_dataloader(
        jax_build_dataset(copy.deepcopy(test_split)), 2, shuffle=False,
        train=False), progress=False)
    assert len(results) == len(ref) == TILES
    for got, want in zip(results, ref):
        assert len(got) == len(want) == 1 and len(got[0]) > 20
        np.testing.assert_allclose(got[0][:, :4], want[0][:, :4], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got[0][:, 4], want[0][:, 4], rtol=0,
                                   atol=1e-5)
    recall = build_dataset(test_split).evaluate(
        results, metric="recall", proposal_nums=(10, 30, 64))
    assert list(recall) == ["AR@10", "AR@30", "AR@64"]
    assert 0.0 <= recall["AR@10"] <= recall["AR@64"] <= 1.0

    props_pkl = str(tmp_path / "proposals.pkl")
    props = write_proposal_file(rpn_pkl, props_pkl)
    assert [p.shape for p in props] == [r[0].shape for r in results]
    fast = a7_cfg("fast_rcnn", train=True)
    for split in (fast.data.train, fast.data.test):
        _tiles(split, data)
    fast_rcnn_config(fast, props_pkl, props_pkl, num_max_proposals=64)
    fast.compute_dtype = "float32"
    fast.data.samples_per_gpu = 2
    fast_path = str(tmp_path / "fast.py")
    fast.dump(fast_path)
    _, hist = train_detector(fast, None, str(tmp_path / "wd_fast"),
                             max_steps=2, device="cpu", log_interval=1)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    fast_ckpt = latest_checkpoint(str(tmp_path / "wd_fast"))
    results, metrics = test_cli.main([fast_path, fast_ckpt, "--eval", "bbox",
                                      "--device", "cpu"])
    assert len(results) == TILES and list(metrics) == [
        "bbox_mAP", "bbox_mAP_50", "bbox_mAP_75"]
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    assert sum(len(r[0]) for r in results) > 0
    shifted = str(tmp_path / "shifted.pkl")
    with open(shifted, "wb") as f:
        pickle.dump([p + np.float32([7, 5, 7, 5, 0]) for p in props], f)
    other, _ = test_cli.main([fast_path, fast_ckpt, "--device", "cpu",
                              "--options",
                              f"data.test.proposal_file={shifted}"])
    assert any(len(a[0]) != len(b[0]) or not np.array_equal(a[0], b[0])
               for a, b in zip(results, other))

    jfast, jvars = jax_model(fast)
    with pytest.raises(TypeError, match="proposals"):
        jax_run_inference(jfast, jvars, jax_build_dataloader(
            jax_build_dataset(dict(fast.data.test, test_mode=True)), 2,
            shuffle=False, train=False), progress=False)


def test_mask_scoring_results_match_the_jax_layout():
    """``mask_scores`` make the segm entry the pair ``(segm_results,
    per-class scores)``, as in the JAX package."""
    from bonai_tpu.apis.test import results_to_host as jax_results_to_host
    from bonai_tpu_torch.apis import results_to_host
    r = np.random.RandomState(1)
    b, p = 2, 8
    xy = r.uniform(0, 100, (b, p, 2))
    boxes = np.concatenate([xy, xy + r.uniform(10, 40, (b, p, 2))], -1)
    out = {"det_bboxes": boxes.astype(np.float32),
           "det_scores": r.uniform(0.1, 1, (b, p)).astype(np.float32),
           "det_labels": np.zeros((b, p), np.int32),
           "det_valid": r.uniform(size=(b, p)) > 0.2,
           "mask_probs": r.uniform(0, 1, (b, p, 28, 28)).astype(np.float32),
           "mask_scores": r.uniform(0, 1, (b, p)).astype(np.float32)}
    metas = [{"ori_shape": (160, 180)}] * 2
    ref = jax_results_to_host(out, metas)
    got = results_to_host({k: t(v) for k, v in out.items()}, metas)
    for (gb, (gs, gm)), (rb, (rs, rm)) in zip(got, ref):
        np.testing.assert_allclose(gb[0], rb[0], rtol=1e-6)
        assert len(gs[0]) == len(rs[0]) == len(gb[0]) > 0
        np.testing.assert_array_equal(gm[0], rm[0])
        assert gm[0].dtype == rm[0].dtype == np.float32


def test_mask_scoring_pkl_scores_segm_by_mask_scores(data):
    """A Mask Scoring pkl through ``evaluate_coco``: the tiles' GTs as
    results (box score 0.5, mask score 0.5) and a false positive a tile
    (box score 0.9, mask score 0.1).  The port ranks segm by the mask
    scores (segm AP 1.0; bbox AP below 1 by the box scores); the same
    masks without the scores rank by the box scores.  The JAX function
    reads the pair as the per-class list and raises ``TypeError``
    (ROADMAP.md queue C)."""
    from bonai_tpu.evaluation.coco_eval import evaluate_coco as jax_evaluate
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.datasets import build_dataset, mask_utils
    from bonai_tpu_torch.evaluation import evaluate_coco
    cfg = Config.fromfile(tpc.A7_CONFIGS["mask_scoring"])
    _tiles(cfg.data.test, data)
    ds = build_dataset(dict(cfg.data.test, test_mode=True))
    scored, plain = [], []
    for i, info in enumerate(ds.data_infos):
        ann = ds.get_ann_info(i)
        n = len(ann["bboxes"])
        h, w = info["height"], info["width"]
        dets = np.concatenate([ann["bboxes"], np.full((n, 1), 0.5)], 1)
        dets = np.concatenate([dets, [[0, 0, 2, 2, 0.9]]]).astype(np.float32)
        fp = np.zeros((h, w), np.uint8)
        fp[:2, :2] = 1
        segm = [mask_utils.encode_mask(mask_utils.poly_to_mask(m, h, w))
                for m in ann["masks"]] + [mask_utils.encode_mask(fp)]
        scores = np.float32([0.5] * n + [0.1])
        scored.append(([dets], ([segm], [scores])))
        plain.append(([dets], [segm]))
    kinds = ("bbox", "segm")
    got = evaluate_coco(ds, scored, metric_types=kinds)
    assert got["segm_mAP"] == 1.0 > got["bbox_mAP"]
    without = evaluate_coco(ds, plain, metric_types=kinds)
    assert without["segm_mAP"] == without["bbox_mAP"] == got["bbox_mAP"]
    assert ds.evaluate(scored, metric=["segm"])["segm_mAP"] == 1.0
    with pytest.raises(TypeError):
        jax_evaluate(ds, scored, metric_types=kinds)
