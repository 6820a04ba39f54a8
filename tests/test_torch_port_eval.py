"""The port's BONAI evaluator, RLE helpers and RLE annotations against the
JAX package (which traces with cv2), on seeded inputs.

All exact, no tolerance: every output must be equal.

- (a) ``masks_to_polygons`` on 120 seeded masks (several parts, holes,
  noise, parts cut by the border); ``results_to_csv_records`` with the
  score and area filters on a synthetic result list (masks drawn with
  ``fill_poly``, RLE from ``encode_mask``, random offsets);
  ``merge_crop_records``; ``polygon_f1`` per crop and merged, on pairs
  around IoU 0.5 and on degenerate polygons that take the raster
  fallback; ``offset_error_vector``; ``dump_csv``/``load_csv`` (byte-equal
  files).
- (b) The JAX 2x run's merged predictions of ``scene0000``
  (``data/synth_run2x``) against the port's generated val scene: both
  evaluators give the same counts and aEPE.  The planted check: the crop
  json's own roofs as results must score the counts that ``chip_smoke.py``
  asserts on the card machine.
- (c) RLE: ``encode_mask`` equals the JAX encoder, decodes back, and an
  RLE segmentation traces to the JAX ``LoadAnnotations``' polygons.
"""

import importlib.util
import json
import os.path as osp

import numpy as np
import pytest

from bonai_tpu.datasets import mask_utils as jax_mask_utils
from bonai_tpu.datasets.pipelines.transforms import \
    LoadAnnotations as JaxLoadAnnotations
from bonai_tpu.evaluation import bonai_eval as jax_eval
from bonai_tpu_torch.datasets import mask_utils
from bonai_tpu_torch.datasets.pipelines import LoadAnnotations
from bonai_tpu_torch.evaluation import bonai_eval
from bonai_tpu_torch.tools.bonai_evaluation import gt_records_from_json
from bonai_tpu_torch.tools.make_synthetic_bonai import write_scene_split
from bonai_tpu_torch.utils.raster import fill_poly
from torch_port_common import ROOT, run2x_records, stem_keys

# the crop json's own roofs, scored per crop (chip_smoke.py PLANTED)
PLANTED = {"roof": (24, 1, 1), "footprint": (25, 0, 0)}


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_bonai_evaluation",
        osp.join(ROOT, "tools", "bonai", "bonai_evaluation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal(a, b, what=""):
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


def _star(r, cx, cy, rmin, rmax):
    n = r.randint(3, 9)
    ang = np.sort(r.uniform(0, 2 * np.pi, n))
    rad = r.uniform(rmin, rmax, n)
    return np.round(np.stack([cx + rad * np.cos(ang),
                              cy + rad * np.sin(ang)], 1)).astype(np.int32)


def _mask(r, size=96):
    m = np.zeros((size, size), np.uint8)
    for _ in range(r.randint(1, 4)):
        cx, cy = r.uniform(-10, size + 10, 2)
        fill_poly(m, [_star(r, cx, cy, 2, size / 3)], 1)
    if r.rand() < 0.3:                     # speckle: many tiny parts
        y, x = r.randint(0, size - 16, 2)
        m[y:y + 16, x:x + 16] |= (r.rand(16, 16) > 0.5).astype(np.uint8)
    if r.rand() < 0.3:                     # a hole
        cy, cx = r.randint(20, size - 20, 2)
        m[cy - 3:cy + 3, cx - 3:cx + 3] = 0
    return m


@pytest.mark.parametrize("min_area", [0, 30])
def test_masks_to_polygons_match_jax(min_area):
    r = np.random.RandomState(min_area)
    for i in range(60):
        m = _mask(r)
        _equal(bonai_eval.masks_to_polygons(m, min_area),
               jax_eval.masks_to_polygons(m, min_area), f"mask {i}")


def _results(seed, names, size=256, n_det=6):
    """A synthetic result list: boxes, masks drawn with ``fill_poly`` (some
    off the image), RLE from ``encode_mask``, scores and offsets."""
    r = np.random.RandomState(seed)
    results = []
    for _ in names:
        dets, rles = [], []
        for _ in range(n_det):
            cx, cy = r.uniform(-30, size + 30, 2)
            poly = _star(r, cx, cy, 8, 28)
            m = np.zeros((size, size), np.uint8)
            fill_poly(m, [poly], 1)
            x0, y0 = poly.min(0)
            x1, y1 = poly.max(0)
            dets.append([x0, y0, x1, y1, r.uniform(0.1, 1.0)])
            rles.append(mask_utils.encode_mask(m))
        results.append(([np.asarray(dets, np.float32)], [rles],
                        r.normal(0, 6, (n_det, 2)).astype(np.float32)))
    return results


CROPS = ["sceneA__0_0.png", "sceneA__256_0.png", "sceneA__0_256.png",
         "sceneB__0_0.png", "plain.png"]


def _gt_like(records, seed):
    """GT records near the predictions: each polygon moved by a random
    shift (some stay matched, some not), one image without GT and one
    GT-only image."""
    r = np.random.RandomState(seed)
    gt = {}
    for k, recs in list(records.items())[1:]:
        gt[k] = [dict(polygon=p["polygon"] + r.uniform(-12, 12, 2).astype(
                          np.float32),
                      footprint_polygon=p["footprint_polygon"] + r.uniform(
                          -12, 12, 2).astype(np.float32),
                      offset=r.normal(0, 6, 2).astype(np.float32))
                 for p in recs]
    gt["gt_only"] = [dict(polygon=np.array([[0, 0], [30, 0], [30, 30]],
                                           np.float32),
                          footprint_polygon=np.array(
                              [[0, 0], [30, 0], [30, 30]], np.float32),
                          offset=np.zeros(2, np.float32))]
    return gt


@pytest.mark.parametrize("score_thr, min_area", [(0.4, 500), (0.0, 0)])
def test_records_f1_offsets_and_csv_match_jax(score_thr, min_area, tmp_path):
    results = _results(1, CROPS)
    got = bonai_eval.results_to_csv_records(results, CROPS, score_thr,
                                            min_area)
    want = jax_eval.results_to_csv_records(results, CROPS, score_thr,
                                           min_area)
    _equal(got, want, "records")
    n = sum(map(len, got.values()))
    assert 0 < n < len(CROPS) * 6
    for merge in (False, True):
        if merge:
            got = bonai_eval.merge_crop_records(got)
            want = jax_eval.merge_crop_records(want)
            _equal(got, want, "merged")
            assert sorted(got) == ["plain", "sceneA", "sceneB"]
        gt = _gt_like(got, 2)
        for key in ("polygon", "footprint_polygon"):
            for skip_empty in (True, False)[:1 + merge]:
                m, pairs = bonai_eval.polygon_f1(got, gt, key=key,
                                                 skip_empty=skip_empty)
                m_ref, pairs_ref = jax_eval.polygon_f1(
                    want, gt, key=key, skip_empty=skip_empty)
                _equal(m, m_ref, f"f1 {key} {merge} {skip_empty}")
                _equal(pairs, pairs_ref, "matches")
                _equal(bonai_eval.offset_error_vector(got, gt, pairs),
                       jax_eval.offset_error_vector(want, gt, pairs_ref),
                       "offsets")
        assert m["tp"] and m["fp"] and m["fn"]
    for key in ("polygon", "footprint_polygon"):
        a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
        bonai_eval.dump_csv(got, a, key=key)
        jax_eval.dump_csv(want, b, key=key)
        assert a.read_bytes() == b.read_bytes()
        _equal(bonai_eval.load_csv(a), jax_eval.load_csv(b), "load_csv")


def _square(x, y, s=40.0):
    return np.array([[x, y], [x + s, y], [x + s, y + s], [x, y + s]],
                    np.float32)


def test_polygon_f1_at_the_threshold_and_degenerate_polygons():
    """Squares shifted so that the regularised IoU lands just above, at
    and just below 0.5 (``inter / (3201 - inter)``: 0.5 at a shift of
    13.325), and polygons the overlay cannot triangulate (collinear, two
    points, repeated vertices), which take the raster fallback."""
    shifts = [13.3, 13.32, 13.324, 13.325, 13.326, 13.33, 13.35]
    degenerate = [np.array([[0, 0], [10, 10], [20, 20]], np.float32),
                  np.array([[5, 5], [45, 30]], np.float32),
                  np.array([[5, 5], [5, 5], [5, 5], [40, 9]], np.float32),
                  np.array([[0, 0], [40, 40], [40, 0], [0, 40]], np.float32)]
    pred, gt = {}, {}
    for i, d in enumerate(shifts):
        gt[f"t{i}"] = [dict(polygon=_square(100, 100),
                            offset=np.array([3, 4], np.float32))]
        pred[f"t{i}"] = [dict(polygon=_square(100 + d, 100),
                              offset=np.array([3, 5], np.float32))]
    for i, p in enumerate(degenerate):
        gt[f"d{i}"] = [dict(polygon=_square(0, 0)), dict(polygon=p)]
        pred[f"d{i}"] = [dict(polygon=p), dict(polygon=p + 1),
                         dict(polygon=_square(2, 1))]
    for key_fn in (lambda k: k.startswith("t"), lambda k: True):
        sub_p = {k: v for k, v in pred.items() if key_fn(k)}
        sub_g = {k: v for k, v in gt.items() if key_fn(k)}
        m, pairs = bonai_eval.polygon_f1(sub_p, sub_g)
        m_ref, pairs_ref = jax_eval.polygon_f1(sub_p, sub_g)
        _equal(m, m_ref)
        _equal(pairs, pairs_ref)
        _equal(bonai_eval.offset_error_vector(sub_p, sub_g, pairs),
               jax_eval.offset_error_vector(sub_p, sub_g, pairs_ref))
    assert 0 < sum(len(pairs[f"t{i}"]) for i in range(len(shifts))) \
        < len(shifts)


@pytest.fixture(scope="module")
def val_scene(tmp_path_factory):
    """Scene 0 of the acceptance val split (seed 77, 2048^2, four 1024^2
    crops), from the port's generator."""
    out = str(tmp_path_factory.mktemp("val"))
    write_scene_split(out, "val", 1, 77, scene_size=2048, crop=1024)
    return out


def test_run2x_scene0_scores_as_jax(val_scene):
    """The JAX 2x run's merged predictions for ``scene0000``, scored by
    both evaluators against the generated originals json."""
    jax_cli = _jax_cli()
    ann = osp.join(val_scene, "val_originals", "val_originals.json")
    gt = stem_keys(gt_records_from_json(ann))
    _equal(gt, stem_keys(jax_cli.gt_records_from_json(ann)), "gt")
    pred = {"scene0000": run2x_records()["scene0000"]}
    for ev in (bonai_eval, jax_eval):
        got = {}
        for key, name in (("polygon", "roof"),
                          ("footprint_polygon", "footprint")):
            m, pairs = ev.polygon_f1(pred, gt, key=key)
            got[name] = (m["tp"], m["fp"], m["fn"])
        got["aEPE"] = ev.offset_error_vector(pred, gt, pairs)["aEPE"]
        if ev is bonai_eval:
            port = got
    assert port == got
    assert port["roof"] == (22, 1, 5) and port["footprint"] == (22, 1, 4)


def planted_results(ann_file):
    """A result list built from a crop json itself: per image its roofs
    filled into full-size masks (RLE), its roof boxes with score 1 and
    its GT offsets."""
    with open(ann_file) as f:
        ds = json.load(f)
    results, names = [], []
    for im in ds["images"]:
        anns = [a for a in ds["annotations"] if a["image_id"] == im["id"]]
        dets = np.array([[a["bbox"][0], a["bbox"][1],
                          a["bbox"][0] + a["bbox"][2],
                          a["bbox"][1] + a["bbox"][3], 1.0] for a in anns],
                        np.float32).reshape(-1, 5)
        rles = [mask_utils.encode_mask(mask_utils.poly_to_mask(
            a["segmentation"], im["height"], im["width"])) for a in anns]
        offsets = np.array([a["offset"] for a in anns],
                           np.float32).reshape(-1, 2)
        results.append(([dets], [rles], offsets))
        names.append(im["file_name"])
    return results, names


def test_planted_results_score_the_chip_smoke_counts(val_scene):
    ann = osp.join(val_scene, "val", "val.json")
    pred = bonai_eval.results_to_csv_records(*planted_results(ann))
    gt = gt_records_from_json(ann)
    got = {}
    for key, name in (("polygon", "roof"), ("footprint_polygon", "footprint")):
        m, pairs = bonai_eval.polygon_f1(pred, gt, key=key)
        got[name] = (m["tp"], m["fp"], m["fn"])
    assert got == PLANTED
    assert bonai_eval.offset_error_vector(pred, gt, pairs)["aEPE"] == 0.0


def test_rle_matches_jax_and_round_trips():
    r = np.random.RandomState(5)
    masks = [_mask(r, 64) for _ in range(20)]
    masks += [np.zeros((7, 5), np.uint8), np.ones((7, 5), np.uint8),
              np.zeros((0, 4), np.uint8), np.eye(6, dtype=np.uint8),
              (r.rand(33, 17) > 0.5).astype(np.uint8)]
    for i, m in enumerate(masks):
        rle = mask_utils.encode_mask(m)
        assert rle == jax_mask_utils.encode_mask(m), i
        assert isinstance(rle["counts"], str)
        np.testing.assert_array_equal(mask_utils.decode_mask(rle), m)
        for counts in (rle["counts"], rle["counts"].encode()):
            raw = dict(rle, counts=counts)
            np.testing.assert_array_equal(mask_utils.decode_mask(raw),
                                          jax_mask_utils.decode_mask(raw))
            assert mask_utils.rle_area(raw) == jax_mask_utils.rle_area(raw) \
                == int(m.sum())
        assert mask_utils.string_to_counts(rle["counts"]) == \
            jax_mask_utils.string_to_counts(rle["counts"])
    polys = [[1, 1, 20, 2, 18, 25, 3, 19], [30, 30, 40, 30, 35, 41]]
    np.testing.assert_array_equal(mask_utils.poly_to_mask(polys, 48, 50),
                                  jax_mask_utils.poly_to_mask(polys, 48, 50))


def test_rle_segmentations_trace_as_jax():
    r = np.random.RandomState(6)
    rles = [mask_utils.encode_mask(_mask(r, 64)) for _ in range(6)]
    poly = [4.0, 4.0, 30.0, 5.0, 20.0, 28.0]
    masks = [rles[0], [rles[1]], [poly, rles[2]], [rles[3], rles[4]],
             [poly], rles[5]]
    ann = dict(ann_info=dict(masks=masks))
    got = LoadAnnotations(with_bbox=False, with_label=False,
                          with_mask=True)(dict(ann))["gt_masks"]
    want = JaxLoadAnnotations(with_bbox=False, with_label=False,
                              with_mask=True)(dict(ann))["gt_masks"]
    _equal(got, want, "gt_masks")
    assert sum(map(len, got)) > len(masks)
