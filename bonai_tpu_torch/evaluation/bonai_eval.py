"""BONAI evaluation: polygon F1 (roof and footprint) and offset error
(counterpart of ``bonai_tpu/evaluation/bonai_eval.py``, without cv2).

reference: ``tools/bonai/bonai_evaluation.py:20-898`` with the external
``bstool`` library (pkl -> CSV parsing, polygon IoU via geopandas overlay,
TP/FP/FN at IoU >= 0.5, offset EPE / angle error).  The overlay is exact
(``evaluation/polygon.py``); contours are traced by
``utils/raster.py::find_external_contours`` and the raster fallback fills
with ``utils/raster.py::fill_poly``, both equal to cv2 pixel for pixel.

Pipeline:
  pkl results -> (mask contour -> roof polygon, roof - offset -> footprint
  polygon, score / min-area filters) -> per-image records -> optional crop
  -> original-image merge (``__x_y`` filename convention) -> full IoU
  overlay matrix with the reference's regularised IoU
  ``inter / (union - inter + 1)`` -> TP = pairs >= thr (reference
  ``get_confusion_matrix_indexes``, ``bonai_evaluation.py:403-501``) ->
  P/R/F1 and offset EPE / angle error.
"""

from __future__ import annotations

import csv
import math
import re
from collections import defaultdict

import numpy as np

from ..datasets.mask_utils import decode_mask
from ..utils.raster import contour_area, fill_poly, find_external_contours
from .coco_eval import split_segm
from .polygon import PreparedPolygon, intersection_area


def masks_to_polygons(mask, min_area=0):
    """Binary mask -> list of ``(K, 2)`` float32 polygons, the outer
    contours of ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``
    with fewer than 3 points or an area under ``min_area`` dropped.

    Only the mask's nonzero bounding box is traced: the tracer pads it
    with zeros, and the scan keeps raster order inside it, so the contours
    are the full mask's, shifted, with the same start points and
    directions."""
    mask = np.asarray(mask)
    rows = np.flatnonzero(mask.any(axis=1))
    if not len(rows):
        return []
    cols = np.flatnonzero(mask.any(axis=0))
    y0, x0 = int(rows[0]), int(cols[0])
    crop = mask[y0:int(rows[-1]) + 1, x0:int(cols[-1]) + 1]
    polys = []
    for c in find_external_contours(crop):
        if len(c) < 3:
            continue
        if contour_area(c) < min_area:
            continue
        polys.append((c + np.array([x0, y0], np.int32)).astype(np.float32))
    return polys


def poly_area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def poly_iou(pa, pb, supersample=1):
    """Raster IoU of two polygons over their joint bbox (the fallback for
    polygons the exact overlay cannot triangulate)."""
    allpts = np.concatenate([pa, pb], axis=0)
    x0, y0 = np.floor(allpts.min(0)).astype(int)
    x1, y1 = np.ceil(allpts.max(0)).astype(int) + 1
    w, h = (x1 - x0) * supersample, (y1 - y0) * supersample
    if w <= 0 or h <= 0 or w * h > 64_000_000:
        return 0.0
    ma = np.zeros((h, w), np.uint8)
    mb = np.zeros((h, w), np.uint8)
    off = np.array([x0, y0], np.float32)
    fill_poly(ma, [np.round((pa - off) * supersample).astype(np.int32)], 1)
    fill_poly(mb, [np.round((pb - off) * supersample).astype(np.int32)], 1)
    inter = int(np.logical_and(ma, mb).sum())
    union = int(np.logical_or(ma, mb).sum())
    return inter / union if union else 0.0


def results_to_csv_records(results, filenames, score_thr=0.4, min_area=500,
                           with_offset=True):
    """Result tuples -> per-image roof/footprint polygon records.

    reference: ``bstool.BSPklParser`` behaviour
    (``bonai_evaluation.py:79-112``): threshold by score, extract the roof
    polygon from the mask, translate by -offset for the footprint, drop
    tiny polygons.

    Returns dict fname -> list of dicts(polygon, footprint_polygon, score,
    offset).
    """
    records = {}
    for fname, res in zip(filenames, results):
        if isinstance(res, tuple):
            bbox_r = res[0]
            segm_r = res[1] if len(res) > 1 else None
            offsets = res[2] if len(res) > 2 else None
        else:
            bbox_r, segm_r, offsets = res, None, None
        segm_r, _ = split_segm(segm_r)        # Mask Scoring's pair
        recs = []
        dets = np.asarray(bbox_r[0], np.float32).reshape(-1, 5)
        for j in range(len(dets)):
            score = dets[j, 4]
            rle = segm_r[0][j] if segm_r else None
            if score < score_thr:
                continue
            if rle is None:
                continue
            polys = masks_to_polygons(decode_mask(rle), min_area=min_area)
            if not polys:
                continue
            roof = max(polys, key=poly_area)
            off = (np.asarray(offsets[j], np.float32)
                   if (with_offset and offsets is not None)
                   else np.zeros(2, np.float32))
            recs.append(dict(polygon=roof,
                             footprint_polygon=roof - off[None, :],
                             score=float(score),
                             offset=off))
        records[fname] = recs
    return records


_CROP_RE = re.compile(r"^(?P<base>.*)__(?P<x>\d+)_(?P<y>\d+)$")


def merge_crop_records(records):
    """Merge 1024² crop records back to original-image coordinates using
    the ``base__x_y`` filename convention (reference:
    ``bonai_evaluation.py:104-112`` merged CSVs)."""
    merged = defaultdict(list)
    for fname, recs in records.items():
        stem = fname.rsplit(".", 1)[0]
        m = _CROP_RE.match(stem)
        if not m:
            merged[stem].extend(recs)
            continue
        shift = np.array([float(m.group("x")), float(m.group("y"))],
                         np.float32)
        for r in recs:
            merged[m.group("base")].append(dict(
                polygon=r["polygon"] + shift,
                footprint_polygon=r["footprint_polygon"] + shift,
                score=r["score"], offset=r["offset"]))
    return dict(merged)


def _pair_iou(prep_a, prep_b, raw_a, raw_b, regularize):
    """Reference-regularised IoU ``inter / (area_a + area_b - inter + 1)``
    (``bonai_evaluation.py:467``), exact overlay with raster fallback."""
    inter = intersection_area(prep_a, prep_b)
    if inter is None:  # degenerate polygon: raster fallback
        iou = poly_iou(raw_a, raw_b)
        denom_reg = regularize / max(poly_area(raw_a) + poly_area(raw_b), 1.0)
        return iou / (1.0 + denom_reg * (1.0 + iou))
    denom = prep_a.area + prep_b.area - inter + regularize
    return inter / denom if denom > 0 else 0.0


def polygon_f1(pred_records, gt_records, iou_thr=0.5, key="polygon",
               skip_empty=True, regularize=1.0):
    """Overlay-matrix IoU >= thr matching -> Precision/Recall/F1 over all
    images, with the reference's semantics (``get_confusion_matrix_indexes``
    + ``segmentation``, ``bonai_evaluation.py:347-501``):

    - full (pred x gt) IoU matrix from geometric overlay, with the
      regularised IoU ``inter / (union - inter + 1.0)``;
    - TP = number of (pred, gt) pairs with IoU >= thr (``argwhere``), FN =
      gts in no pair, FP = preds in no pair — no greedy assignment;
    - images where either side is empty are skipped entirely, and only
      images present in the GT set are visited (``skip_empty=True``; pass
      False for the more conventional every-image accounting).

    Returns (metrics dict, matches) where matches maps fname -> list of
    (pred_idx, gt_idx) TP pairs for the offset-error stage.
    """
    tp = fp = fn = 0
    matches = {}
    fnames = sorted(gt_records) if skip_empty \
        else sorted(set(pred_records) | set(gt_records))
    for fname in fnames:
        preds = pred_records.get(fname, [])
        gts = gt_records.get(fname, [])
        if skip_empty and (not preds or not gts):
            continue
        prep_p = [PreparedPolygon(p[key]) for p in preds]
        prep_g = [PreparedPolygon(g[key]) for g in gts]
        pairs = []
        pred_hit = np.zeros(len(preds), bool)
        gt_hit = np.zeros(len(gts), bool)
        for pi in range(len(preds)):
            for gi in range(len(gts)):
                iou = _pair_iou(prep_p[pi], prep_g[gi],
                                preds[pi][key], gts[gi][key], regularize)
                if iou >= iou_thr:
                    pairs.append((pi, gi))
                    pred_hit[pi] = True
                    gt_hit[gi] = True
        tp += len(pairs)
        fp += int((~pred_hit).sum())
        fn += int((~gt_hit).sum())
        matches[fname] = pairs
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return (dict(precision=precision, recall=recall, f1=f1, tp=tp, fp=fp,
                 fn=fn), matches)


def offset_error_vector(pred_records, gt_records, matches):
    """EPE / angle error / cosine distance over matched instances
    (reference: ``bonai_evaluation.py:260-345``)."""
    epes, angles, coss = [], [], []
    for fname, pairs in matches.items():
        preds = pred_records.get(fname, [])
        gts = gt_records.get(fname, [])
        for pi, gi in pairs:
            po = np.asarray(preds[pi].get("offset", (0, 0)), np.float64)
            go = np.asarray(gts[gi].get("offset", (0, 0)), np.float64)
            epes.append(float(np.linalg.norm(po - go)))
            na, nb = np.linalg.norm(po), np.linalg.norm(go)
            if na > 1e-6 and nb > 1e-6:
                cosv = float(np.dot(po, go) / (na * nb))
                cosv = max(-1.0, min(1.0, cosv))
                angles.append(abs(math.acos(cosv)))
                coss.append(1.0 - cosv)
    return dict(
        aEPE=float(np.mean(epes)) if epes else -1.0,
        aAE=float(np.mean(angles)) if angles else -1.0,
        cos_distance=float(np.mean(coss)) if coss else -1.0,
        matched=len(epes))


# ---------------------------------------------------------------------------
# CSV io (the reference's merged-CSV artifacts)
# ---------------------------------------------------------------------------

def poly_to_wkt(poly):
    pts = ",".join(f"{x:.2f} {y:.2f}" for x, y in poly)
    first = f"{poly[0][0]:.2f} {poly[0][1]:.2f}"
    return f"POLYGON (({pts},{first}))"


def wkt_to_poly(wkt):
    inner = wkt[wkt.index("((") + 2:wkt.rindex("))")]
    pts = [tuple(map(float, p.strip().split())) for p in inner.split(",")]
    arr = np.asarray(pts, np.float32)
    if len(arr) > 1 and np.allclose(arr[0], arr[-1]):
        arr = arr[:-1]
    return arr


def dump_csv(records, path, key="polygon"):
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["ImageId", "PolygonWKT", "Confidence"])
        for fname in sorted(records):
            for r in records[fname]:
                wr.writerow([fname, poly_to_wkt(r[key]),
                             f"{r.get('score', 1.0):.4f}"])


def load_csv(path):
    records = defaultdict(list)
    with open(path, newline="") as f:
        rd = csv.reader(f)
        next(rd)                                    # header
        for row in rd:
            records[row[0]].append(dict(
                polygon=wkt_to_poly(row[1]),
                footprint_polygon=wkt_to_poly(row[1]),
                score=float(row[2]) if len(row) > 2 else 1.0,
                offset=np.zeros(2, np.float32)))
    return dict(records)
