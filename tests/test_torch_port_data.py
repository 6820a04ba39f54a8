"""The port's BONAI dataset, train pipeline, packing and loader against the
JAX package, on one json and its PNG tiles written by the port's generator
(128^2 tiles, the synthetic recipe's train pipeline at the identity size).

All exact: ``get_ann_info``; ``prepare(idx, RandomState(s))`` (the image,
boxes, offsets, polygons, labels and the flip draws); ``pack_sample``, whose
``gt_masks`` are the JAX package's cv2 rasterization; and two epochs of the
port's loader, in both its modes, against JAX
``build_dataloader(loader_mode='process')``.
"""

import copy

import numpy as np
import pytest

from bonai_tpu.datasets import build_dataset as jax_build_dataset
from bonai_tpu.datasets.builder import build_dataloader as jax_dataloader
from bonai_tpu.datasets.builder import pack_sample as jax_pack_sample
from bonai_tpu_torch.datasets import (build_dataloader, build_dataset,
                                      pack_sample)
from torch_port_common import synth_data, synth_train_cfg

MAX_GT = 24          # below the two densest tiles' counts: truncation runs


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    out = synth_data(tmp_path_factory.mktemp("synth"), n=5, size=128)
    train = synth_train_cfg(out).data.train
    return (build_dataset(copy.deepcopy(train)),
            jax_build_dataset(copy.deepcopy(dict(train))))


def _equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
    else:
        assert a == b, what


def test_annotations_match_jax(datasets):
    port, ref = datasets
    assert len(port) == len(ref) == 5
    assert port.CLASSES == tuple(ref.CLASSES)
    for i in range(len(port)):
        _equal(port.get_ann_info(i), ref.get_ann_info(i), f"ann {i}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prepare_and_pack_match_jax(datasets, seed):
    """Every image under three seeds, flipped and not."""
    port, ref = datasets
    flips = set()
    for i in range(len(port)):
        got = port.prepare(i, np.random.RandomState(7 * seed + i))
        want = ref.prepare(i, np.random.RandomState(7 * seed + i))
        got.pop("_rng", None)
        want.pop("_rng", None)
        _equal(got, want, f"prepare {i}")
        flips.add(got["flip_direction"])
        packed, metas = pack_sample(got, MAX_GT, 112)
        packed_ref, metas_ref = jax_pack_sample(want, MAX_GT, 112)
        _equal(packed, packed_ref, f"pack {i}")
        _equal(metas, metas_ref, f"metas {i}")
        assert packed["gt_masks"][packed["gt_valid"]].any(axis=(1, 2)).all()
    assert len(flips) > 1


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_matches_jax_process_loader(datasets, mode):
    port, ref = datasets
    got = build_dataloader(port, 2, workers_per_gpu=2, seed=3,
                           max_gt=MAX_GT, loader_mode=mode)
    want = jax_dataloader(ref, 2, workers_per_gpu=2, seed=3, max_gt=MAX_GT,
                          loader_mode="process")
    try:
        for epoch in range(2):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a, b = list(got), list(want)
            assert len(a) == len(b) == len(got) == 2
            _equal(a, b, f"epoch {epoch}")
        assert got.truncated_samples == want.truncated_samples > 0
        assert got.truncated_instances == want.truncated_instances
    finally:
        got.close()
        want._pool.shutdown()


def test_not_ported_parts_raise():
    from bonai_tpu_torch.datasets.pipelines import (Corrupt, LoadAnnotations,
                                                    build_pipeline)
    # LOFT's dense maps and RandomRotate are ported
    # (test_torch_port_attributes.py, test_torch_port_rotate.py); the
    # random crop is still A6
    LoadAnnotations(with_edge=True, with_side_face=True,
                    with_offset_field=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6"):
        build_pipeline([dict(type="LoadImageFromFile"),
                        dict(type="RandomCrop", crop_size=(64, 64))])
    # COCO evaluation, ClassBalancedDataset and the robustness benchmark's
    # Corrupt transform are ported (test_torch_port_coco_eval.py,
    # test_torch_port_datasets_extra.py, test_torch_port_corrupt.py)
    pipe = build_pipeline([dict(type="Corrupt", corruption="gaussian_noise")])
    assert isinstance(pipe.transforms[0], Corrupt)


UNPORTED_TRANSFORMS = {
    "Expand": "A6", "MinIoURandomCrop": "A6", "RandomCrop": "A6",
    "AutoAugment": "A6", "SegRescale": "A7",
    "InstaBoost": "not queued", "Albu": "not queued"}
# ported since their A6 cases here: CornerNet's train transforms, as its
# BONAI config sets them
CORNERNET_TRANSFORMS = {
    "PhotoMetricDistortion": dict(brightness_delta=32,
                                  contrast_range=(0.5, 1.5),
                                  saturation_range=(0.5, 1.5), hue_delta=18),
    "RandomCenterCropPad": dict(
        crop_size=(511, 511), ratios=(0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2,
                                      1.3), border=128,
        mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
        to_rgb=True, test_mode=False, test_pad_mode=None)}


@pytest.mark.parametrize("name", sorted(CORNERNET_TRANSFORMS))
def test_cornernet_transforms_run(name):
    """Each of CornerNet's train transforms, built through the pipeline
    builder, runs a 96x128 BGR image with three boxes and gives the JAX
    transform's result from the same ``RandomState`` (image exact, boxes,
    labels and border exact); ``test_torch_port_cornernet.py`` holds them
    further."""
    from bonai_tpu.datasets.pipelines.transforms import PIPELINES as JAX_REG
    from bonai_tpu_torch.datasets.pipelines import build_pipeline
    r = np.random.RandomState(3)
    sample = dict(img=r.randint(0, 256, (96, 128, 3)).astype(np.uint8),
                  gt_bboxes=np.array([[10, 12, 40, 50], [60, 20, 120, 90],
                                      [5, 70, 30, 94]], np.float32),
                  gt_labels=np.zeros(3, np.int64))
    cfg = dict(type=name, **CORNERNET_TRANSFORMS[name])
    for seed in range(3):
        want = JAX_REG.get(name)(**CORNERNET_TRANSFORMS[name])(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        got = build_pipeline([cfg])(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        for key in ("img", "gt_bboxes", "gt_labels", "border"):
            if key in want:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{name} {key}")


@pytest.mark.parametrize("flag", ["xy2la", "la2xy"])
def test_offset_transform_matches_jax(flag):
    """``OffsetTransform`` (ported since its A5 case here), built through
    the pipeline builder, against the JAX transform: exact, and a sample
    without offsets passes through."""
    from bonai_tpu.datasets.pipelines.transforms import PIPELINES as JAX_REG
    from bonai_tpu_torch.datasets.pipelines import build_pipeline
    r = np.random.RandomState(4)
    offsets = r.uniform(-30, 30, (17, 2)).astype(np.float32)
    if flag == "la2xy":
        offsets[:, 1] = r.uniform(-np.pi, np.pi, 17)
    got = build_pipeline([dict(type="OffsetTransform",
                               transform_flag=flag)])(
        dict(gt_offsets=offsets.copy()))
    want = JAX_REG.get("OffsetTransform")(flag)(
        dict(gt_offsets=offsets.copy()))
    np.testing.assert_array_equal(got["gt_offsets"], want["gt_offsets"])
    assert got["gt_offsets"].dtype == np.float32
    empty = dict(gt_offsets=np.zeros((0, 2), np.float32))
    assert build_pipeline([dict(type="OffsetTransform",
                                transform_flag=flag)])(empty) is empty


# ported since their A5 cases here: the rotation and the oriented-box
# encoding (test_torch_port_rotate.py holds them further)
ROTATED_TRANSFORMS = {
    "RandomRotate": dict(rotate_ratio=1.0, angles=[37, 90]),
    "Pointobb2RBBox": dict(encoding_method="thetaobb")}


@pytest.mark.parametrize("name", sorted(ROTATED_TRANSFORMS))
def test_rotated_transforms_match_jax(name):
    """``RandomRotate`` and ``Pointobb2RBBox``, built through the pipeline
    builder, against the JAX transforms under three seeds: the image and
    the edge map exact, boxes, polygons, offsets and the encoded oriented
    boxes within 1e-5."""
    from bonai_tpu.datasets.pipelines.transforms import PIPELINES as JAX_REG
    from bonai_tpu_torch.datasets.pipelines import build_pipeline
    r = np.random.RandomState(5)
    quads = r.randint(0, 90, (12, 4, 2)).reshape(12, 8).astype(np.float32)
    sample = dict(img=r.randint(0, 256, (80, 96, 3)).astype(np.uint8),
                  img_shape=(80, 96),
                  gt_bboxes=np.array([[10, 12, 40, 50], [60, 20, 90, 70]],
                                     np.float32),
                  gt_masks=[[r.uniform(10, 70, (5, 2)).astype(np.float32)],
                            [r.uniform(10, 70, (4, 2)).astype(np.float32)]],
                  gt_offsets=r.uniform(-9, 9, (2, 2)).astype(np.float32),
                  gt_edge_maps=r.randint(0, 2, (80, 96)).astype(np.uint8),
                  edge_fields=["gt_edge_maps"], gt_rbboxes=quads,
                  rbbox_fields=["gt_rbboxes"])
    for seed in range(3):
        want = JAX_REG.get(name)(**ROTATED_TRANSFORMS[name])(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        got = build_pipeline([dict(type=name, **ROTATED_TRANSFORMS[name])])(
            dict(copy.deepcopy(sample), _rng=np.random.RandomState(seed)))
        for key in ("img", "gt_edge_maps", "img_shape"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in ("gt_bboxes", "gt_offsets", "gt_rbboxes"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5, err_msg=key)
        for a, b in zip(got["gt_masks"], want["gt_masks"]):
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(UNPORTED_TRANSFORMS))
def test_unported_transforms_name_their_item(name):
    """Each transform of the JAX registry that the port does not register
    raises ``NotImplementedError`` naming the ROADMAP.md item that ports it
    (``InstaBoost`` and ``Albu``: not queued); a name no registry knows
    keeps the registry's ``KeyError``."""
    from bonai_tpu.datasets.pipelines.transforms import PIPELINES as JAX_REG
    from bonai_tpu_torch.datasets.pipelines import build_pipeline
    from bonai_tpu_torch.datasets.pipelines.transforms import PIPELINES
    assert name in JAX_REG and name not in PIPELINES
    assert set(UNPORTED_TRANSFORMS) == set(JAX_REG.module_dict) - set(
        PIPELINES.module_dict)
    item = UNPORTED_TRANSFORMS[name]
    match = "not queued" if item == "not queued" else f"ROADMAP.md item {item}"
    with pytest.raises(NotImplementedError, match=match):
        build_pipeline([dict(type="LoadImageFromFile"), dict(type=name)])
    with pytest.raises(NotImplementedError, match=match):
        build_pipeline([dict(type="MultiScaleFlipAug", img_scale=(64, 64),
                             transforms=[dict(type=name)])])
    with pytest.raises(KeyError, match="NoSuchTransform"):
        build_pipeline([dict(type="NoSuchTransform")])
