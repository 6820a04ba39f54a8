"""COCO-style evaluation in bonai_tpu_torch against the JAX package: the
run-length ``mask_iou``, ``_match_image``, ``coco_ap``, ``coco_pr_curve``,
``evaluate_coco``, ``eval_map`` (with ``scale_ranges``), ``eval_recalls``,
``CocoDataset.evaluate`` and the test CLI's ``--eval``.

Inputs: the json of four 128^2 tiles from the port's generator (one
class; a copy whose annotations alternate between two classes), and
seeded numpy results over it: per image and class, GT boxes jittered and
random boxes, in random score order, each with an RLE mask pasted from a
random polygon in its box (the jittered GT's own polygon for the
jittered boxes).  Every number is held exactly (``==``) to the JAX
package's on the same inputs: both compute in float64 in the same order.
"""

import copy
import json
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from bonai_tpu.datasets.coco import CocoDataset as JaxCocoDataset
from bonai_tpu.datasets import build_dataset as jax_build_dataset
from bonai_tpu.datasets import mask_utils as jax_mask_utils
from bonai_tpu.evaluation import coco_eval as jax_coco_eval
from bonai_tpu.evaluation import mean_ap as jax_mean_ap
from bonai_tpu_torch.datasets import build_dataset, mask_utils
from bonai_tpu_torch.datasets.coco import CocoDataset
from bonai_tpu_torch.evaluation import coco_eval, mean_ap
from torch_port_common import SYNTH_CONFIG, synth_data, tiny_cfg

SIZE = 128


def _poly_in(box, r, k=6):
    """A random star-shaped polygon inside ``box`` (flat COCO list)."""
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    ang = np.sort(r.uniform(0, 2 * np.pi, k))
    rad = r.uniform(0.3, 1.0, k)
    xs = cx + np.cos(ang) * rad * (x2 - x1) / 2
    ys = cy + np.sin(ang) * rad * (y2 - y1) / 2
    return [np.stack([xs, ys], 1).ravel().tolist()]


def _rle(polys):
    return mask_utils.encode_mask(mask_utils.poly_to_mask(polys, SIZE, SIZE))


def _results(ds, seed, n_random=6):
    """Seeded results over ``ds``'s GTs, per image a tuple ``(bbox,
    segm)``."""
    r = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        bbox, segm = [], []
        for c in range(len(ds.CLASSES)):
            sel = np.nonzero(ann["labels"] == c)[0]
            rows, rles = [], []
            for j in sel:
                if r.rand() < 0.25:         # a missed GT
                    continue
                box = ann["bboxes"][j] + r.normal(0, 2.0, 4)
                rows.append(box)
                shift = box[:2] - ann["bboxes"][j][:2]
                rles.append(_rle([
                    (np.asarray(p, np.float64).reshape(-1, 2) + shift)
                    .ravel().tolist() for p in ann["masks"][j]]))
            for _ in range(n_random):
                xy = r.uniform(0, SIZE - 20, 2)
                box = np.concatenate([xy, xy + r.uniform(6, 40, 2)])
                rows.append(box)
                rles.append(_rle(_poly_in(box, r)))
            order = r.permutation(len(rows))
            scores = r.uniform(0.05, 1.0, len(rows))
            scores[order[:2]] = 0.5             # a tie
            dets = np.concatenate([np.asarray(rows, np.float32)[order],
                                   scores[:, None].astype(np.float32)], 1)
            bbox.append(dets.reshape(-1, 5))
            segm.append([rles[k] for k in order])
        out.append((bbox, segm))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The one-class BONAI test set of both packages, its two-class COCO
    copy, and seeded results over each."""
    out = synth_data(tmp_path_factory.mktemp("synth"), n=4, size=SIZE)
    ann_file = osp.join(out, "train", "train.json")
    test = tiny_cfg(config=SYNTH_CONFIG).data.test
    test.update(ann_file=ann_file, img_prefix=osp.join(out, "train",
                                                       "images") + "/")
    bonai = (build_dataset(dict(copy.deepcopy(test), test_mode=True)),
             jax_build_dataset(dict(copy.deepcopy(test), test_mode=True)))
    with open(ann_file) as f:
        js = json.load(f)
    js["categories"] = [dict(id=1, name="flat"), dict(id=2, name="gable")]
    for k, a in enumerate(js["annotations"]):
        a["category_id"] = 1 + k % 2
    two = osp.join(out, "two_classes.json")
    with open(two, "w") as f:
        json.dump(js, f)
    coco2 = (CocoDataset(two, [], test_mode=True),
             JaxCocoDataset(two, [], test_mode=True))
    return dict(ann_file=ann_file, bonai=bonai, coco2=coco2,
                res1=_results(bonai[0], 0), res2=_results(coco2[0], 1))


def _flat_rles(results):
    return [m for res in results for per_cls in res[1] for m in per_cls]


def test_mask_iou_matches_jax_native_and_dense(data, monkeypatch):
    """The run-length IoU against the JAX native run merge and its dense
    fallback (forced by an all-false ``iscrowd``), and with crowd columns
    against the dense path; it decodes no mask."""
    import bonai_tpu.native as native
    rles = _flat_rles(data["res1"])
    a, b = rles[:40], rles[20:60] + [_rle([]), _rle([[0, 0, 127, 0,
                                                      127, 127, 0, 127]])]
    crowd = np.arange(len(b)) % 3 == 0
    ref_native = jax_mask_utils.mask_iou(a, b)
    ref_dense = jax_mask_utils.mask_iou(a, b, iscrowd=np.zeros(len(b), bool))
    ref_crowd = jax_mask_utils.mask_iou(a, b, iscrowd=crowd)
    monkeypatch.setattr(native, "rle_iou_native", lambda *a: None)
    assert np.array_equal(jax_mask_utils.mask_iou(a, b), ref_dense)

    def no_decode(*args):
        raise AssertionError("mask_iou decoded a mask")
    monkeypatch.setattr(mask_utils, "rle_counts_to_mask", no_decode)
    monkeypatch.setattr(mask_utils, "decode_mask", no_decode)
    got = mask_utils.mask_iou(a, b)
    assert got.dtype == np.float64 and got.shape == (40, len(b))
    assert (got > 0).sum() > 20 and (got == 0).sum() > 200
    assert np.array_equal(got, ref_native)
    assert np.array_equal(got, ref_dense)
    assert np.array_equal(mask_utils.mask_iou(a, b, iscrowd=crowd),
                          ref_crowd)
    assert mask_utils.mask_iou([], b).shape == (0, len(b))


def test_match_image_matches_jax():
    r = np.random.RandomState(2)
    for d, g in ((0, 3), (5, 0), (12, 7), (30, 9)):
        scores = np.round(r.uniform(size=d), 1)         # ties
        ious = r.uniform(size=(d, g)) * (r.uniform(size=(d, g)) > 0.3)
        gt_ignore = r.uniform(size=g) < 0.3
        for thr in (0.5, 0.75, 0.95):
            got = coco_eval._match_image(scores, ious, gt_ignore, thr)
            ref = jax_coco_eval._match_image(scores, ious, gt_ignore, thr)
            for x, y in zip(got, ref):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("classes", [1, 2])
@pytest.mark.parametrize("metric", ["bbox", "segm"])
def test_coco_ap_and_pr_curve_match_jax(data, classes, metric):
    ds, jds = data["bonai"] if classes == 1 else data["coco2"]
    results = data["res1"] if classes == 1 else data["res2"]
    for c in range(classes):
        recs = coco_eval.per_image_records(ds, results, c, metric)
        ref = jax_coco_eval.per_image_records(jds, results, c, metric)
        ign = coco_eval.per_image_records(ds, results, c, metric,
                                          ignore_other_classes=True)
        ref_ign = jax_coco_eval.per_image_records(
            jds, results, c, metric, ignore_other_classes=True)
        for got_r, ref_r in zip(recs + ign, ref + ref_ign):
            for k in ("scores", "ious", "gt_ignore"):
                assert np.array_equal(got_r[k], ref_r[k]), k
        for max_dets in (100, 4):
            got = coco_eval.coco_ap(recs, max_dets=max_dets)
            assert got == jax_coco_eval.coco_ap(ref, max_dets=max_dets)
            assert 0 < got["ap"] < 1
            for thr in (0.5, 0.75):
                g = coco_eval.coco_pr_curve(ign, thr, max_dets)
                e = jax_coco_eval.coco_pr_curve(ref_ign, thr, max_dets)
                assert np.array_equal(g[1], e[1])


@pytest.mark.parametrize("case", ["bbox_segm_1", "bbox_segm_2",
                                  "boxes_only", "past_max_dets"])
def test_evaluate_coco_matches_jax(data, case):
    """Same keys and numbers: bbox and segm at one and two classes (the
    per-class suffix), boxes-only results, and more detections an image
    than ``max_dets`` (cut by position, not by score)."""
    ds, jds = data["coco2"] if case == "bbox_segm_2" else data["bonai"]
    results = data["res2"] if case == "bbox_segm_2" else data["res1"]
    kw = dict(metric_types=("bbox", "segm"))
    if case == "boxes_only":
        results, kw = [r[0] for r in results], dict(metric_types=("bbox",))
    elif case == "past_max_dets":
        kw["max_dets"] = 5
        assert min(len(r[0][0]) for r in results) > 5
    got = coco_eval.evaluate_coco(ds, results, **kw)
    ref = jax_coco_eval.evaluate_coco(jds, results, **kw)
    assert got == ref
    assert len(got) == 3 * len(kw["metric_types"]) * len(ds.CLASSES)
    if case == "bbox_segm_2":
        assert "segm_mAP_75_gable" in got
    assert all(0 < v < 1 for v in got.values()), got


def _boxes_and_anns(seed, n_img=5):
    r = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(n_img):
        g = r.randint(0, 8)
        xy = r.uniform(0, 200, (g, 2))
        gt = np.concatenate([xy, xy + r.uniform(4, 90, (g, 2))], 1)
        labels = r.randint(0, 2, g)
        ig = np.concatenate([xy[:1], xy[:1] + 30], 1) if g and r.rand() < .5 \
            else np.zeros((0, 4))
        per_cls = []
        for c in range(2):
            own = gt[labels == c] + r.normal(0, 4, ((labels == c).sum(), 4))
            rnd = r.uniform(0, 200, (r.randint(0, 6), 2))
            rnd = np.concatenate([rnd, rnd + r.uniform(4, 90, rnd.shape)], 1)
            boxes = np.concatenate([own, rnd])
            per_cls.append(np.concatenate(
                [boxes, r.uniform(size=(len(boxes), 1))], 1)
                .astype(np.float32))
        dets.append(per_cls)
        anns.append(dict(bboxes=gt.astype(np.float32), labels=labels,
                         bboxes_ignore=ig.astype(np.float32)))
    return dets, anns


@pytest.mark.parametrize("scale_ranges", [None, [(0, 32), (32, 64),
                                                 (64, 1e5)]])
def test_eval_map_matches_jax(scale_ranges, capsys):
    dets, anns = _boxes_and_anns(3)
    got = mean_ap.eval_map(dets, anns, iou_thr=0.5,
                           scale_ranges=scale_ranges, logger="print")
    table = capsys.readouterr().out
    ref = jax_mean_ap.eval_map(dets, anns, iou_thr=0.5,
                               scale_ranges=scale_ranges, logger="print")
    assert capsys.readouterr().out == table and "mAP" in table
    assert got[0] == ref[0]
    for g, e in zip(got[1], ref[1]):
        assert g.keys() == e.keys()
        for k in g:
            assert np.array_equal(g[k], e[k]), k
    for mode in ("area", "11points"):
        rec = np.sort(np.random.RandomState(4).uniform(size=9))
        prec = np.random.RandomState(5).uniform(size=9)
        assert mean_ap.average_precision(rec, prec, mode) == \
            jax_mean_ap.average_precision(rec, prec, mode)


def test_eval_recalls_matches_jax():
    dets, anns = _boxes_and_anns(6)
    gts = [a["bboxes"] for a in anns]
    for props in ([np.concatenate(d) for d in dets],
                  [np.concatenate(d)[:, :4] for d in dets]):
        kw = dict(proposal_nums=(1, 3, 100), iou_thrs=(0.3, 0.5, 0.7))
        got = mean_ap.eval_recalls(gts, props, **kw)
        assert np.array_equal(got, jax_mean_ap.eval_recalls(gts, props, **kw))
        assert got.shape == (3, 3) and got.max() > 0


@pytest.mark.parametrize("which", ["bonai", "coco2"])
def test_dataset_evaluate_matches_jax(data, which):
    """``CocoDataset.evaluate`` (``BONAI`` inherits it) with all four
    metrics."""
    ds, jds = data[which]
    results = data["res1" if which == "bonai" else "res2"]
    kw = dict(metric=["bbox", "segm", "mAP", "recall"], iou_thr=0.5,
              proposal_nums=(5, 20))
    got = ds.evaluate(results, **kw)
    assert got == jds.evaluate(results, **kw)
    assert {"mAP", "AR@5", "AR@20"} <= set(got)


def test_planted_results_score_one(data):
    """The json's own GTs as results (score 1, full-size RLE masks) score
    AP 1 in both kinds and VOC mAP 1."""
    ds = data["bonai"][0]
    results = []
    for i in range(len(ds)):
        ann = ds.get_ann_info(i)
        dets = np.concatenate([ann["bboxes"], np.ones((len(ann["bboxes"]),
                                                       1), np.float32)], 1)
        results.append(([dets], [[_rle(m) for m in ann["masks"]]]))
    m = ds.evaluate(results, metric=["bbox", "segm", "mAP"])
    assert m["bbox_mAP"] == m["segm_mAP"] == m["mAP"] == 1.0


def test_test_cli_prints_the_jax_metrics(data, tmp_path, capsys):
    """``python -m bonai_tpu_torch.tools.test --eval bbox segm`` on the
    tiny LOFT-FOA with random weights: its pkl holds plain types, and the
    metrics it prints equal the JAX ``evaluate_coco`` on that pkl."""
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.engine import save_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    cfg = tiny_cfg(config=SYNTH_CONFIG)
    cfg.data.test.update(ann_file=data["ann_file"], img_prefix=osp.join(
        osp.dirname(data["ann_file"]), "images") + "/")
    cfg.data.test.pipeline[1].img_scale = (SIZE, SIZE)
    cfg.compute_dtype = "float32"
    cfg.test_cfg.rcnn.score_thr = 0.3
    cfg_path = str(tmp_path / "tiny.py")
    cfg.dump(cfg_path)
    model = init_detector(cfg, device="cpu", dtype=torch.float32, seed=1)
    ckpt = save_checkpoint(str(tmp_path / "wd"), 0, model,
                           torch.optim.SGD(model.parameters(), lr=0.1))
    pkl = str(tmp_path / "r.pkl")
    capsys.readouterr()
    results, metrics = test_cli.main([cfg_path, ckpt, "--out", pkl,
                                      "--eval", "bbox", "segm",
                                      "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    with open(pkl, "rb") as f:
        loaded = pickle.load(f)
    assert len(loaded) == 4 and isinstance(loaded[0], tuple)
    ref = jax_coco_eval.evaluate_coco(data["bonai"][1], loaded,
                                      metric_types=("bbox", "segm"))
    assert metrics == ref
    assert printed[-6:] == [f"{k}: {v:.4f}" for k, v in ref.items()]
    # test-time augmentation (ported since this case raised A5): the
    # synthetic test pipeline declares no views, so both merge levels run
    # horizontal and vertical flips at scale 1; each pkl holds the merged
    # views' results of run_inference(tta=...) on the same model
    from bonai_tpu_torch.apis.test import run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    loader = build_dataloader(build_dataset(dict(cfg.data.test,
                                                 test_mode=True)),
                              cfg.data.get("samples_per_gpu", 2),
                              shuffle=False, train=False)
    for mode in ("det", "proposal"):
        out = str(tmp_path / f"tta_{mode}.pkl")
        test_cli.main([cfg_path, ckpt, "--out", out, "--aug-test",
                       "--aug-test-mode", mode, "--device", "cpu"])
        with open(out, "rb") as f:
            merged = pickle.load(f)
        want = run_inference(model, loader, progress=False, tta=dict(
            scales=[1.0], flip=True, flip_directions=["horizontal",
                                                      "vertical"],
            mode=mode))
        assert len(merged) == len(want) == 4
        assert sum(len(r[0][0]) for r in want) > 0
        for got, ref in zip(merged, want):
            assert len(got) == 3 and len(got[0][0]) == len(ref[0][0])
            np.testing.assert_allclose(got[0][0], ref[0][0], rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)
            assert got[1] == ref[1]
