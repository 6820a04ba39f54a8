"""The non-BONAI datasets, ``ClassBalancedDataset`` and the two dataset
converters of bonai_tpu_torch against the JAX package on the same temp
files (written by ``bonai_tpu_torch/tools/make_synthetic_datasets.py``,
JPEGs by the port's encoder), and the sweep of the 16 configs of those
datasets through the port's builders, on the CPU:

- ``VOCDataset``/``WIDERFaceDataset``: the image list (empty images
  filtered in training), every annotation (``xmin``/``ymin`` less 1,
  difficult and unknown objects dropped) and ``evaluate``'s ``mAP``
  equal; the port's ``prepare`` (which the JAX class lacks) reads the
  JPEG as ``cv2.imread`` does;
- ``LVISDataset`` (``coco_url`` only), ``CityscapesDataset`` and
  ``DeepFashionDataset``: file names, annotations and ``prepare`` equal;
- ``ClassBalancedDataset``: ``repeat_indices`` equal and the length of
  the closed form; the loader's batches over it equal to the JAX process
  loader's, row for row, in both loader modes; ``Corrupt`` in a test
  pipeline through the test loader equal to the JAX process loader's;
- the Pascal VOC and Cityscapes converters (16-bit ``instanceIds``
  written by ``write_png``): the same json as the JAX scripts';
- the sweep: all 16 configs build their detector (the 4 ResNeXt LVIS
  configs too) and their train and test datasets, whose ``prepare``
  runs.
"""

import glob
import importlib.util
import json
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch

from bonai_tpu.datasets.builder import build_dataloader as jax_dataloader
from bonai_tpu.datasets.builder import build_dataset as jax_build_dataset
from bonai_tpu_torch.config import Config
from bonai_tpu_torch.datasets import (ClassBalancedDataset, build_dataloader,
                                      build_dataset)
from bonai_tpu_torch.models import build_detector
from bonai_tpu_torch.tools import make_synthetic_datasets as synth
from bonai_tpu_torch.tools.convert_datasets import cityscapes, pascal_voc
from torch_port_common import ROOT, meta_device

LOAD = [dict(type="LoadImageFromFile"),
        dict(type="LoadAnnotations", with_bbox=True)]
LOAD_MASK = [dict(type="LoadImageFromFile"),
             dict(type="LoadAnnotations", with_bbox=True, with_mask=True)]


def _jax_tool(name):
    path = osp.join(ROOT, "tools", *name.split("/")) + ".py"
    spec = importlib.util.spec_from_file_location(
        "jax_" + name.replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(cfg):
    return build_dataset(dict(cfg)), jax_build_dataset(dict(cfg))


def _equal_ann(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    voc_dir, split = synth.make_voc(root, n=7, size=(60, 80), seed=1)
    wider_root = osp.join(root, "WIDER")
    wider_split = synth.make_wider(wider_root, n=5, size=(48, 64), seed=2)
    return dict(VOCDataset=(voc_dir + "/", split),
                WIDERFaceDataset=(wider_root + "/", wider_split))


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("kind", ["VOCDataset", "WIDERFaceDataset"])
def test_xml_datasets_match_jax(voc, kind, test_mode):
    prefix, split = voc[kind]
    port, ref = _both(dict(type=kind, ann_file=split, img_prefix=prefix,
                           pipeline=LOAD, test_mode=test_mode))
    assert len(port) == len(ref) > 0
    assert port.data_infos == ref.data_infos
    assert port.CLASSES == ref.CLASSES
    if kind == "VOCDataset":
        assert port.year == ref.year == 2007
    dets = []
    rs = np.random.RandomState(0)
    for i in range(len(port)):
        ann = port.get_ann_info(i)
        _equal_ann(ann, ref.get_ann_info(i))
        assert port.get_cat_ids(i) == ann["labels"].tolist()
        res = port.prepare(i, np.random.RandomState(i))
        path = osp.join(prefix, port.data_infos[i]["filename"])
        np.testing.assert_array_equal(res["img"], cv2.imread(path))
        per_class = [np.zeros((0, 5), np.float32) for _ in port.CLASSES]
        for box, lab in zip(ann["bboxes"], ann["labels"]):
            jit = box + rs.uniform(-3, 3, 4)
            det = np.append(jit, rs.rand()).astype(np.float32)
            per_class[lab] = np.vstack([per_class[lab], det[None]])
        per_class[0] = np.vstack([per_class[0], [[1, 1, 9, 9, 0.95]]]
                                 ).astype(np.float32)
        dets.append(per_class)
    got, want = port.evaluate(dets), ref.evaluate(dets)
    assert set(got) == set(want) == {"mAP"}
    assert got["mAP"] == pytest.approx(want["mAP"], abs=1e-7)
    assert 0 < got["mAP"] < 1


@pytest.fixture(scope="module")
def coco_sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    lvis = synth.make_lvis(osp.join(root, "lvis"), n_images=9, n_files=3,
                           n_rare=3, size=(64, 80))
    fashion = synth.make_deepfashion(osp.join(root, "fashion"), n=3,
                                     size=(64, 80))
    cs_root = synth.make_cityscapes_tree(osp.join(root, "cs"), n=2,
                                         size=(64, 128))
    cityscapes.main([cs_root, osp.join(cs_root, "annotations")])
    cs = osp.join(cs_root, "annotations",
                  "instancesonly_filtered_gtFine_train.json")
    return dict(
        LVISDataset=(lvis, osp.dirname(lvis) + "/"),
        DeepFashionDataset=(fashion, osp.dirname(fashion) + "/"),
        CityscapesDataset=(cs, osp.join(cs_root, "leftImg8bit", "train")
                           + "/"))


@pytest.mark.parametrize("kind", ["LVISDataset", "CityscapesDataset",
                                  "DeepFashionDataset"])
def test_coco_style_datasets_match_jax(coco_sets, kind):
    ann_file, prefix = coco_sets[kind]
    port, ref = _both(dict(type=kind, ann_file=ann_file, img_prefix=prefix,
                           pipeline=LOAD_MASK))
    assert len(port) == len(ref) > 0
    assert list(port.CLASSES) == list(ref.CLASSES)
    assert [d["filename"] for d in port.data_infos] == \
        [d["filename"] for d in ref.data_infos]
    if kind == "LVISDataset":
        assert port.data_infos[0]["filename"].startswith("train2017/")
    for i in range(len(port)):
        a, b = port.get_ann_info(i), ref.get_ann_info(i)
        for k in ("bboxes", "labels", "bboxes_ignore"):
            np.testing.assert_array_equal(a[k], b[k])
        assert sorted(port.get_cat_ids(i)) == sorted(ref.get_cat_ids(i))
        got = port.prepare(i, np.random.RandomState(0))
        want = ref.prepare(i, np.random.RandomState(0))
        np.testing.assert_array_equal(got["img"], want["img"])
        np.testing.assert_array_equal(got["gt_bboxes"], want["gt_bboxes"])


def _train_pipeline(scale):
    return [*LOAD_MASK,
            dict(type="Resize", img_scale=scale, keep_ratio=True),
            dict(type="RandomFlip", flip_ratio=0.5),
            dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                 std=[58.395, 57.12, 57.375], to_rgb=True),
            dict(type="Pad", size_divisor=32),
            dict(type="DefaultFormatBundle"),
            dict(type="Collect",
                 keys=["img", "gt_bboxes", "gt_labels", "gt_masks"])]


def _batches_equal(a, b):
    assert len(a) == len(b)
    for (ba, _), (bb, _) in zip(a, b):
        assert set(ba) == set(bb)
        for k in ba:
            np.testing.assert_allclose(ba[k], bb[k], rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_class_balanced_dataset_matches_jax(coco_sets, mode):
    ann_file, prefix = coco_sets["LVISDataset"]
    cfg = dict(type="ClassBalancedDataset", oversample_thr=0.3,
               dataset=dict(type="LVISDataset", ann_file=ann_file,
                            img_prefix=prefix,
                            pipeline=_train_pipeline((96, 64))))
    port, ref = _both(cfg)
    assert isinstance(port, ClassBalancedDataset)
    assert port.repeat_indices == ref.repeat_indices
    # the closed form: image i repeats ceil(max_c sqrt(thr / f(c)))
    base = port.dataset
    n = len(base)
    cats = [set(base.get_cat_ids(i)) for i in range(n)]
    freq = {c: sum(c in s for s in cats) / n for s in cats for c in s}
    expect = sum(int(np.ceil(max(max(1.0, np.sqrt(0.3 / freq[c]))
                                 for c in s))) for s in cats)
    assert len(port) == expect > n
    got = build_dataloader(port, 2, seed=5, max_gt=8, inst_mask_size=28,
                           loader_mode=mode)
    want = jax_dataloader(ref, 2, seed=5, max_gt=8, inst_mask_size=28,
                          loader_mode="process")
    try:
        _batches_equal([b for b in got], [b for b in want])
    finally:
        got.close()
        want._pool.shutdown()


def test_corrupt_through_the_test_loader_matches_jax(coco_sets):
    """``Corrupt`` draws from the batch's ``RandomState``: the port's test
    loader gives the JAX process loader's corrupted batches."""
    ann_file, prefix = coco_sets["DeepFashionDataset"]
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="Corrupt", corruption="shot_noise", severity=2),
                dict(type="Normalize", mean=[0, 0, 0], std=[1, 1, 1],
                     to_rgb=False),
                dict(type="ImageToTensor", keys=["img"]),
                dict(type="Collect", keys=["img"])]
    cfg = dict(type="DeepFashionDataset", ann_file=ann_file,
               img_prefix=prefix, pipeline=pipeline, test_mode=True)
    port, ref = _both(cfg)
    got = build_dataloader(port, 1, shuffle=False, train=False)
    want = jax_dataloader(ref, 1, shuffle=False, train=False,
                          loader_mode="process")
    try:
        a, b = list(got), list(want)
        _batches_equal(a, b)
        clean = cv2.imread(osp.join(prefix, port.data_infos[0]["filename"]))
        assert not np.array_equal(a[0][0]["image"][0], clean)
    finally:
        got.close()
        want._pool.shutdown()


def test_pascal_voc_converter_matches_jax(voc, tmp_path, monkeypatch):
    prefix = voc["VOCDataset"][0]
    voc_dir = prefix.rstrip("/")
    out = str(tmp_path / "port.json")
    assert pascal_voc.main([voc_dir, "trainval", out]) == 0
    ref = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["pascal_voc.py", voc_dir, "trainval",
                                      ref])
    _jax_tool("convert_datasets/pascal_voc").main()
    with open(out) as f, open(ref) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert any(a["iscrowd"] for a in got["annotations"])
    ds = build_dataset(dict(type="CocoDataset", ann_file=out,
                            img_prefix=prefix, pipeline=LOAD))
    assert len(ds) == len(got["images"])


def test_cityscapes_converter_matches_jax(tmp_path):
    root = synth.make_cityscapes_tree(str(tmp_path / "cs"), n=2,
                                      size=(48, 96), seed=4)
    synth.make_cityscapes_tree(root, n=1, size=(32, 64), seed=5,
                               split="val", city="bonn")
    cityscapes.main([root, str(tmp_path / "port")])
    jax_cs = _jax_tool("convert_datasets/cityscapes")
    for split in ("train", "val"):
        name = f"instancesonly_filtered_gtFine_{split}.json"
        jax_cs.convert_split(root, split, str(tmp_path / f"jax_{name}"))
        with open(tmp_path / "port" / name) as f, \
                open(tmp_path / f"jax_{name}") as g:
            got, want = json.load(f), json.load(g)
        assert got == want
        # car and person instances, the crowd of riders; no caravan, road
        cats = sorted({a["category_id"] for a in got["annotations"]})
        assert cats == [24, 25, 26]
        assert any(a["iscrowd"] for a in got["annotations"])


CONFIG_FILES = sorted(
    osp.relpath(p, ROOT) for d in ("pascal_voc", "wider_face", "cityscapes",
                                   "lvis", "deepfashion")
    for p in glob.glob(osp.join(ROOT, "configs", d, "*.py")))


@pytest.fixture(scope="module")
def sweep_data(voc, coco_sets):
    return dict(**{k: voc[k][::-1] for k in ("VOCDataset",
                                             "WIDERFaceDataset")},
                **{k: coco_sets[k] for k in ("LVISDataset",
                                             "CityscapesDataset",
                                             "DeepFashionDataset")})


def _point_at_files(split, data):
    """The split config with its files replaced by the test's."""
    split = dict(split)
    if "dataset" in split:
        split["dataset"] = _point_at_files(split["dataset"], data)
        return split
    ann_file, prefix = data[split["type"]]
    if isinstance(split["ann_file"], (list, tuple)):
        n = len(split["ann_file"])
        split["ann_file"], split["img_prefix"] = [ann_file] * n, [prefix] * n
    else:
        split["ann_file"], split["img_prefix"] = ann_file, prefix
    return split


def test_config_sweep_covers_the_16_configs():
    assert len(CONFIG_FILES) == 16


@pytest.mark.parametrize("config", CONFIG_FILES)
def test_config_builds_its_detector_and_datasets(config, sweep_data):
    cfg = Config.fromfile(osp.join(ROOT, config))
    with meta_device():
        model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    if "x101" in config:                        # ResNeXt's grouped conv2
        assert model.backbone.layer1[0].conv2.groups == (
            32 if "32x4d" in config else 64)
    for name in ("train", "test"):
        split = _point_at_files(cfg.data[name], sweep_data)
        ds = build_dataset(dict(split, test_mode=name == "test")
                           if name == "test" else split)
        assert len(ds) > 0
        res = ds.prepare(0, np.random.RandomState(0))
        assert res is not None and "img" in res
