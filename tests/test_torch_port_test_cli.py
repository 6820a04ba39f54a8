"""The port's test path against the JAX package at tiny width on the CPU:
the dataset in test mode through the synthetic config's test pipeline
(``MultiScaleFlipAug``), the test loader (wrap-padded last batch),
``run_inference`` and the two CLIs.

Four 128^2 tiles from the port's generator, batches of 3, the tiny
LOFT-FOA with the same seeded weights in float32.  Tolerances: the same
detections per image; boxes, scores and offsets within 1e-4 (relative and
absolute); RLE masks whose pixels differ only where the port's pasted
probability is within 1e-4 of ``mask_thr``; the file names, the pkl's
types and the evaluation CLIs' CSVs exact.
"""

import importlib.util
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch

from bonai_tpu.apis import run_inference as jax_run_inference
from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
from bonai_tpu.datasets import build_dataset as jax_build_dataset
from bonai_tpu_torch.apis import run_inference
from bonai_tpu_torch.core.masks import resize_bilinear
from bonai_tpu_torch.datasets import (build_dataloader, build_dataset,
                                      mask_utils)
from bonai_tpu_torch.engine import save_checkpoint
from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
from torch_port_common import (ROOT, SYNTH_CONFIG, jax_model, port_model,
                               synth_data, tiny_cfg)

N_TILES, BATCH, SIZE = 4, 3, 128
EVAL_ARGS = ["--score-thr", "0.25", "--min-area", "20"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = synth_data(tmp_path_factory.mktemp("synth"), n=N_TILES, size=SIZE)
    cfg = tiny_cfg(config=SYNTH_CONFIG)
    test = cfg.data.test
    test.ann_file = osp.join(out, "train", "train.json")
    test.img_prefix = osp.join(out, "train", "images") + "/"
    test.pipeline[1].img_scale = (SIZE, SIZE)
    cfg.data.samples_per_gpu = BATCH
    cfg.compute_dtype = "float32"
    jm, variables = jax_model(cfg)
    pm = port_model(cfg, variables)
    test_cfg = dict(test, test_mode=True)
    jds = jax_build_dataset(dict(test_cfg))
    ref = jax_run_inference(jm, variables, jax_build_dataloader(
        jds, BATCH, shuffle=False, train=False), progress=False)
    ds = build_dataset(dict(test_cfg))
    loader = build_dataloader(ds, BATCH, shuffle=False, train=False)
    got = run_inference(pm, loader, progress=False)
    return dict(cfg=cfg, pm=pm, ds=ds, jds=jds, loader=loader, got=got,
                ref=ref, out=out)


def _pasted(prob, box, h, w):
    """``core/masks.py::paste_mask_rle``'s probability map before its
    threshold, on the whole ``(h, w)`` image."""
    x1, y1, x2, y2 = (float(v) for v in box)
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    full = np.zeros((h, w), np.float32)
    xs, ys = max(x1i, 0), max(y1i, 0)
    xe, ye = min(x2i, w), min(y2i, h)
    if xe > xs and ye > ys:
        resized = resize_bilinear(prob, max(y2i - y1i, 1), max(x2i - x1i, 1))
        full[ys:ye, xs:xe] = resized[ys - y1i:ye - y1i, xs - x1i:xe - x1i]
    return full


def test_run_inference_matches_jax(setup):
    got, ref, pm, loader = (setup[k] for k in ("got", "ref", "pm", "loader"))
    assert len(got) == len(ref) == N_TILES       # the wrap-pad is dropped
    assert len(loader) * BATCH > N_TILES
    # the port's mask probabilities, per image, to place pixel differences
    probs = []
    with torch.inference_mode():
        for batch, metas in loader:
            out = pm.simple_test(*(torch.as_tensor(batch[k]) for k in (
                "image", "img_shape", "scale_factor")))
            for i, m in enumerate(metas):
                v = out["det_valid"][i].numpy()
                probs.append((out["mask_probs"][i].numpy()[v],
                              out["det_bboxes"][i].numpy()[v],
                              m["ori_shape"]))
    n_det = 0
    for i, ((gb, gs, go), (rb, rs, ro)) in enumerate(zip(got, ref)):
        assert gb[0].shape == rb[0].shape and len(gb[0]) > 0, i
        np.testing.assert_allclose(gb[0], rb[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(go, ro, rtol=1e-4, atol=1e-4)
        mp, boxes, (h, w) = probs[i]
        assert (h, w) == (SIZE, SIZE)
        for j, (gm, rm) in enumerate(zip(gs[0], rs[0])):
            assert gm["size"] == rm["size"] == [SIZE, SIZE]
            a, b = mask_utils.decode_mask(gm), mask_utils.decode_mask(rm)
            diff = a != b
            if diff.any():
                p = _pasted(mp[j], boxes[j], h, w)
                assert np.abs(p[diff] - 0.5).max() <= 1e-4, (i, j)
            n_det += 1
    assert n_det > 20


def test_test_loader_metas_and_filenames_match_jax(setup):
    ds, jds = setup["ds"], setup["jds"]
    names = [d["filename"] for d in ds.data_infos]
    assert names == [d["filename"] for d in jds.data_infos]
    metas = [m for _, ms in setup["loader"] for m in ms]
    assert [osp.basename(m["filename"]) for m in metas] == \
        names + names[:len(metas) - N_TILES]
    for i in range(N_TILES):
        got, want = ds.prepare(i), jds.prepare(i)
        np.testing.assert_array_equal(got["img"], want["img"])
        for k in ("filename", "ori_shape", "img_shape", "pad_shape", "flip",
                  "flip_direction"):
            assert got["img_metas"][k] == want["img_metas"][k], k
        np.testing.assert_array_equal(got["img_metas"]["scale_factor"],
                                      want["img_metas"]["scale_factor"])


@pytest.mark.parametrize("kw", [
    dict(img_scale=(1024, 1024)),
    dict(img_scale=[(1333, 800), (1000, 600)], flip=True,
         flip_direction=["horizontal", "vertical"]),
    dict(img_scale=(512, 512), flip=True, scale_factors=[1.0, 0.5])])
def test_multiscale_flip_aug_declares_the_jax_views(kw):
    from bonai_tpu.datasets.pipelines.transforms import \
        MultiScaleFlipAug as JaxMultiScaleFlipAug
    from bonai_tpu_torch.datasets.pipelines import MultiScaleFlipAug
    steps = [dict(type="Resize", keep_ratio=True)]
    got = MultiScaleFlipAug(steps, **kw)
    want = JaxMultiScaleFlipAug(steps, **kw)
    assert got.tta_cfg() == want.tta_cfg()
    assert got.img_scale == want.img_scale


def test_results2json_and_summary_csv_match_jax(setup, tmp_path):
    ds, jds, got = setup["ds"], setup["jds"], setup["got"]
    files = ds.results2json(got, str(tmp_path / "port"))
    want = jds.results2json(got, str(tmp_path / "jax"))
    assert files.keys() == want.keys() == {"bbox", "segm", "offset"}
    for k in files:
        with open(files[k], "rb") as a, open(want[k], "rb") as b:
            assert a.read() == b.read(), k
    summary = ({"roof": dict(F1_score=0.5, Precision=0.4, Recall=0.6, TP=3,
                             FP=4, FN=2),
                "footprint": dict(F1_score=0.25, TP=1)},)
    for d, name in ((ds, "port"), (jds, "jax")):
        d.write_results2csv(summary, dict(
            summary_file=str(tmp_path / f"{name}.csv"), model="m"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def _plain(x):
    """Only numpy arrays, lists, tuples, dicts and Python scalars."""
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(_plain(v) for v in x.values())
    return isinstance(x, (np.ndarray, str, int, float, np.floating))


def _jax_eval_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_bonai_evaluation",
        osp.join(ROOT, "tools", "bonai", "bonai_evaluation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_pkl_scores_the_same_through_both_evaluation_clis(
        setup, tmp_path, monkeypatch):
    """``bonai_test`` on a ``save_checkpoint`` checkpoint, then both
    evaluation CLIs on its pkl and on the JAX run's.  The threshold keeps
    the random weights' stronger detections (``merge_crop_records`` is
    held to JAX in ``test_torch_port_eval.py``)."""
    cfg, pm = setup["cfg"], setup["pm"]
    cfg_path = str(tmp_path / "tiny_synth.py")
    cfg.dump(cfg_path)
    ckpt = save_checkpoint(str(tmp_path / "wd"), 3, pm,
                           torch.optim.SGD(pm.parameters(), lr=0.1))
    pkl = str(tmp_path / "port.pkl")
    payload = bonai_test.main([cfg_path, ckpt, "--out", pkl, "--city",
                               "config", "--device", "cpu"])
    with open(pkl, "rb") as f:
        assert pickle.load(f).keys() == payload.keys()
    assert _plain(payload)
    assert payload["filenames"] == [d["filename"]
                                    for d in setup["ds"].data_infos]
    assert [len(r[0][0]) for r in payload["results"]] == \
        [len(r[0][0]) for r in setup["got"]]
    jax_pkl = str(tmp_path / "jax.pkl")
    with open(jax_pkl, "wb") as f:
        pickle.dump(dict(results=setup["ref"],
                         filenames=payload["filenames"]), f)
    jax_cli = _jax_eval_cli()
    ann = cfg.data.test.ann_file
    summaries = []
    for p in (pkl, jax_pkl):
        outs = []
        for name in ("port", "jax"):
            prefix = str(tmp_path / name)
            argv = [p, "--gt-json", ann, *EVAL_ARGS, "--csv-prefix", prefix,
                    "--out-csv", prefix + "_summary.csv"]
            if name == "port":
                bonai_evaluation.main(argv)
            else:
                monkeypatch.setattr(sys, "argv",
                                    ["bonai_evaluation.py", *argv])
                jax_cli.main()
            outs.append([open(prefix + s, "rb").read() for s in (
                "_summary.csv", "_roof.csv", "_footprint.csv")])
        assert outs[0] == outs[1], p
        summaries.append(outs[0][0].decode().splitlines())
        assert len(outs[0][1].splitlines()) > 3       # roof rows scored
    fn = summaries[0][0].split(",").index("roof_fn")
    assert int(summaries[0][1].split(",")[fn]) > 0
