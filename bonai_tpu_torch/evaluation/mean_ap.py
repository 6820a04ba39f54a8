"""VOC-style mAP and proposal recall in numpy (counterpart of
``bonai_tpu/evaluation/mean_ap.py``: ``eval_map`` with ``scale_ranges``,
``average_precision``, ``eval_recalls``, ``print_map_summary``)."""

from __future__ import annotations

import numpy as np

from .coco_eval import _bbox_iou_np


def _tpfp_default(dets, gts, gts_ignore=None, iou_thr=0.5,
                  area_ranges=None):
    """Greedy score-ordered TP/FP marking for one image+class
    (reference ``mean_ap.py`` ``tpfp_default``).

    Args:
      dets: (n, 5) [x1 y1 x2 y2 score].
      gts: (m, 4); gts_ignore: (k, 4) crowd/ignore regions.
      area_ranges: list of (min_area, max_area) or None (= one
        unbounded range).

    Returns (tp, fp), each (num_ranges, n).  A det matched to an ignored
    or out-of-range gt — or an unmatched det outside the range — counts
    as neither tp nor fp.
    """
    if gts_ignore is None:
        gts_ignore = np.zeros((0, 4), np.float32)
    if area_ranges is None:
        area_ranges = [(None, None)]
    n = dets.shape[0]
    num_ranges = len(area_ranges)
    tp = np.zeros((num_ranges, n))
    fp = np.zeros((num_ranges, n))
    det_areas = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])

    all_gts = np.vstack([gts, gts_ignore]).astype(np.float32)
    gt_ignored = np.concatenate([np.zeros(len(gts), bool),
                                 np.ones(len(gts_ignore), bool)])
    if all_gts.shape[0] == 0:
        for k, (amin, amax) in enumerate(area_ranges):
            if amin is None:
                fp[k, :] = 1
            else:
                fp[k, (det_areas >= amin) & (det_areas < amax)] = 1
        return tp, fp

    ious = _bbox_iou_np(dets[:, :4], all_gts) if n else \
        np.zeros((0, all_gts.shape[0]))
    gt_areas = (all_gts[:, 2] - all_gts[:, 0]) \
        * (all_gts[:, 3] - all_gts[:, 1])
    order = np.argsort(-dets[:, 4], kind="stable")
    for k, (amin, amax) in enumerate(area_ranges):
        gt_out = np.zeros(all_gts.shape[0], bool) if amin is None else \
            ((gt_areas < amin) | (gt_areas >= amax))
        covered = np.zeros(all_gts.shape[0], bool)
        for i in order:
            if n and ious.shape[1]:
                m = int(np.argmax(ious[i]))
                iou_m = ious[i, m]
            else:
                m, iou_m = -1, -1.0
            if iou_m >= iou_thr:
                if gt_ignored[m] or gt_out[m]:
                    continue                      # neither tp nor fp
                if not covered[m]:
                    covered[m] = True
                    tp[k, i] = 1
                else:
                    fp[k, i] = 1
            elif amin is None or (det_areas[i] >= amin
                                  and det_areas[i] < amax):
                fp[k, i] = 1
    return tp, fp


def average_precision(recalls, precisions, mode="area"):
    """reference: ``mean_ap.py`` average_precision."""
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(precisions) - 1, 0, -1):
        precisions[i - 1] = max(precisions[i - 1], precisions[i])
    if mode == "area":
        idx = np.where(recalls[1:] != recalls[:-1])[0]
        return float(np.sum(
            (recalls[idx + 1] - recalls[idx]) * precisions[idx + 1]))
    # 11-point
    ap = 0.0
    for t in np.arange(0, 1.1, 0.1):
        mask = recalls >= t
        ap += (precisions[mask].max() if mask.any() else 0.0) / 11
    return float(ap)


def eval_map(det_results, annotations, iou_thr=0.5, scale_ranges=None,
             dataset=None, logger=None):
    """VOC-style mAP (reference ``mean_ap.py:267-392``).

    Args:
      det_results: per-image list of per-class (n, 5) arrays.
      annotations: per-image dicts with 'bboxes' (m, 4), 'labels' (m,)
        and optionally 'bboxes_ignore' (k, 4).
      scale_ranges: list of (min_scale, max_scale) — converted to area
        ranges (scale²) like the reference; None = one unbounded range.
      dataset: class-name list for the summary table.
      logger: 'print' or a logging.Logger to emit the per-class table.

    Returns (mAP, per-class list of dicts).  With ``scale_ranges``, mAP
    is a list (one per range) and per-class 'ap'/'recall'/'num_gts' are
    arrays over ranges.
    """
    area_ranges = None if scale_ranges is None else \
        [(s[0] ** 2, s[1] ** 2) for s in scale_ranges]
    num_ranges = 1 if area_ranges is None else len(area_ranges)
    num_classes = len(det_results[0])
    eval_results = []
    for c in range(num_classes):
        tps, fps, scores = [], [], []
        num_gts = np.zeros(num_ranges, int)
        for dets, ann in zip(det_results, annotations):
            cls_dets = np.asarray(dets[c], np.float32).reshape(-1, 5)
            gt = ann["bboxes"][ann["labels"] == c]
            gt_ig = np.asarray(ann.get("bboxes_ignore",
                                       np.zeros((0, 4))),
                               np.float32).reshape(-1, 4)
            if area_ranges is None:
                num_gts[0] += len(gt)
            else:
                areas = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) \
                    if len(gt) else np.zeros(0)
                for k, (amin, amax) in enumerate(area_ranges):
                    num_gts[k] += int(((areas >= amin)
                                       & (areas < amax)).sum())
            tp, fp = _tpfp_default(cls_dets, gt, gt_ig, iou_thr,
                                   area_ranges)
            tps.append(tp)
            fps.append(fp)
            scores.append(cls_dets[:, 4])
        scores = np.concatenate(scores) if scores else np.zeros(0)
        order = np.argsort(-scores, kind="stable")
        tp = np.concatenate(tps, axis=1)[:, order] if len(scores) \
            else np.zeros((num_ranges, 0))
        fp = np.concatenate(fps, axis=1)[:, order] if len(scores) \
            else np.zeros((num_ranges, 0))
        tp_cum = np.cumsum(tp, axis=1)
        fp_cum = np.cumsum(fp, axis=1)
        recalls = tp_cum / np.maximum(num_gts[:, None], 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        ap = np.array([
            average_precision(recalls[k], precisions[k])
            if num_gts[k] else 0.0 for k in range(num_ranges)])
        last_rec = np.array(
            [float(recalls[k, -1]) if recalls.shape[1] else 0.0
             for k in range(num_ranges)])
        if area_ranges is None:
            eval_results.append(dict(
                num_gts=int(num_gts[0]), num_dets=len(scores),
                ap=float(ap[0]), recall=float(last_rec[0])))
        else:
            eval_results.append(dict(
                num_gts=num_gts, num_dets=len(scores), ap=ap,
                recall=last_rec))

    if area_ranges is None:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    else:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_gts = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap = [
            float(all_ap[all_gts[:, k] > 0, k].mean())
            if (all_gts[:, k] > 0).any() else 0.0
            for k in range(num_ranges)]
    if logger is not None:
        print_map_summary(mean_ap, eval_results, dataset=dataset,
                          logger=logger)
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, dataset=None, logger="print"):
    """Per-class AP table (reference ``mean_ap.py:395-458``)."""
    num_classes = len(results)
    first_ap = results[0]["ap"]
    num_ranges = len(first_ap) if isinstance(first_ap, np.ndarray) else 1
    names = dataset if dataset is not None else \
        [str(i) for i in range(num_classes)]
    emit = print if logger == "print" else logger.info
    if not isinstance(mean_ap, list):
        mean_ap = [mean_ap]
    for k in range(num_ranges):
        header = f"{'class':<20}{'gts':>8}{'dets':>8}" \
                 f"{'recall':>8}{'ap':>8}"
        emit(header)
        for c, r in enumerate(results):
            ap = r["ap"][k] if num_ranges > 1 else r["ap"]
            rec = r["recall"][k] if num_ranges > 1 else r["recall"]
            gts = r["num_gts"][k] if num_ranges > 1 else r["num_gts"]
            emit(f"{str(names[c]):<20}{int(gts):>8}"
                 f"{int(r['num_dets']):>8}{rec:>8.3f}{ap:>8.3f}")
        emit(f"{'mAP':<20}{'':>8}{'':>8}{'':>8}{mean_ap[k]:>8.3f}")


def eval_recalls(gts, proposals, proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,)):
    """Proposal recall matrix (reference ``recall.py``).

    Args:
      gts: per-image (m, 4) arrays.
      proposals: per-image (n, 4) or (n, 5 score-sorted) arrays.
    Returns (len(proposal_nums), len(iou_thrs)) recall matrix.
    """
    out = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gts = sum(len(g) for g in gts)
    if total_gts == 0:
        return out
    for ti, thr in enumerate(iou_thrs):
        for ni, num in enumerate(proposal_nums):
            hit = 0
            for gt, props in zip(gts, proposals):
                if len(gt) == 0:
                    continue
                p = np.asarray(props, np.float32)
                if p.shape[1] == 5:
                    p = p[np.argsort(-p[:, 4])][:, :4]
                p = p[:num]
                if len(p) == 0:
                    continue
                ious = _bbox_iou_np(gt, p)
                hit += int((ious.max(axis=1) >= thr).sum())
            out[ni, ti] = hit / total_gts
    return out
