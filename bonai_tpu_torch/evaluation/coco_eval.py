"""COCO-style AP evaluation in numpy (counterpart of
``bonai_tpu/evaluation/coco_eval.py``, no pycocotools): IoU 0.50:0.95,
101-point interpolated AP, greedy score-ordered matching, ``max_dets``;
bbox and segm (RLE) modes, with the JAX package's metric keys and numbers.

As in the JAX package, ``coco_ap`` keeps each image's first ``max_dets``
records by position, not by score, and ``evaluate_coco`` knows no area
ranges and no ``iscrowd`` or ``bboxes_ignore`` GTs (ROADMAP.md queue C).
``evaluate_coco`` computes the IoUs of those first ``max_dets`` rows only;
the segm IoUs come from the run lengths (``mask_utils.mask_iou``).
"""

from __future__ import annotations

import numpy as np

from ..datasets import mask_utils

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _bbox_iou_np(dets, gts, iscrowd=None):
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:4], gts[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    a2 = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    if iscrowd is not None:
        denom = np.where(iscrowd[None, :], a1[:, None],
                         a1[:, None] + a2[None, :] - inter)
    else:
        denom = a1[:, None] + a2[None, :] - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-9), 0.0)


def _match_image(det_scores, ious, gt_ignore, iou_thr):
    """Greedy COCOeval matching for one (image, category, iou_thr).

    Returns (det_matched_gt (D,), det_ignore (D,)) with -1 for unmatched.
    """
    d = len(det_scores)
    g = ious.shape[1] if ious.size else 0
    gt_taken = np.zeros(g, bool)
    det_match = np.full(d, -1)
    det_ig = np.zeros(d, bool)
    order = np.argsort(-det_scores, kind="stable")
    for di in order:
        best_iou = min(iou_thr, 1 - 1e-10)
        best = -1
        for gi in range(g):
            if gt_taken[gi] and not gt_ignore[gi]:
                continue
            # prefer non-ignored matches: once matched to a real gt, only a
            # better real gt wins; ignored gts only if nothing real found
            if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                break
            if ious[di, gi] < best_iou:
                continue
            best_iou = ious[di, gi]
            best = gi
        if best >= 0:
            det_match[di] = best
            det_ig[di] = gt_ignore[best]
            gt_taken[best] = True
    return det_match, det_ig


def coco_ap(per_image, iou_thrs=IOU_THRS, max_dets=100, area_rng=None):
    """Compute AP/AR from per-image detection/GT records.

    Args:
      per_image: list of dicts with keys
        ``scores (D,)``, ``ious (D, G)``, ``gt_ignore (G,)`` — one entry per
        image for a single category.
    Returns dict with 'ap' (mean over IoU thrs), 'ap50', 'ap75', 'ar'.
    """
    n_thr = len(iou_thrs)
    all_scores = []
    all_tp = [[] for _ in range(n_thr)]
    all_ig = [[] for _ in range(n_thr)]
    npig = 0
    for rec in per_image:
        scores = np.asarray(rec["scores"])[:max_dets]
        ious = np.asarray(rec["ious"])[:max_dets]
        gt_ignore = np.asarray(rec["gt_ignore"], bool)
        npig += int((~gt_ignore).sum())
        all_scores.append(scores)
        for ti, thr in enumerate(iou_thrs):
            match, dig = _match_image(scores, ious, gt_ignore, thr)
            all_tp[ti].append((match >= 0) & ~dig)
            all_ig[ti].append(dig)
    if npig == 0:
        return dict(ap=-1.0, ap50=-1.0, ap75=-1.0, ar=-1.0)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    ap_per_thr = np.zeros(n_thr)
    ar_per_thr = np.zeros(n_thr)
    for ti in range(n_thr):
        tp = np.concatenate(all_tp[ti])[order] if all_tp[ti] else np.zeros(0)
        ig = np.concatenate(all_ig[ti])[order] if all_ig[ti] else np.zeros(0)
        keep = ~ig.astype(bool)
        tp = tp[keep]
        fp = ~tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        rc = tp_cum / npig
        pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # make precision monotonically decreasing
        for i in range(len(pr) - 1, 0, -1):
            pr[i - 1] = max(pr[i - 1], pr[i])
        # 101-point interpolation
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(len(REC_THRS))
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        ap_per_thr[ti] = q.mean()
        ar_per_thr[ti] = rc[-1] if len(rc) else 0.0
    return dict(ap=float(ap_per_thr.mean()),
                ap50=float(ap_per_thr[0]),
                ap75=float(ap_per_thr[5]) if n_thr > 5 else -1.0,
                ar=float(ar_per_thr.mean()))


def coco_pr_curve(per_image, iou_thr, max_dets=100):
    """101-point interpolated precision-over-recall curve for one
    (category, IoU threshold) — the building block of the error-analysis
    tools (the reference reads ``cocoEval.eval['precision']``)."""
    all_scores, all_tp, all_ig = [], [], []
    npig = 0
    for rec in per_image:
        scores = np.asarray(rec["scores"])[:max_dets]
        ious = np.asarray(rec["ious"])[:max_dets]
        gt_ignore = np.asarray(rec["gt_ignore"], bool)
        npig += int((~gt_ignore).sum())
        all_scores.append(scores)
        match, dig = _match_image(scores, ious, gt_ignore, iou_thr)
        all_tp.append((match >= 0) & ~dig)
        all_ig.append(dig)
    if npig == 0:
        return REC_THRS, np.zeros(len(REC_THRS))
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    tp = np.concatenate(all_tp)[order] if all_tp else np.zeros(0, bool)
    ig = np.concatenate(all_ig)[order] if all_ig else np.zeros(0, bool)
    tp = tp[~ig.astype(bool)]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    rc = tp_cum / npig
    pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    for i in range(len(pr) - 1, 0, -1):
        pr[i - 1] = max(pr[i - 1], pr[i])
    inds = np.searchsorted(rc, REC_THRS, side="left")
    q = np.zeros(len(REC_THRS))
    for ri, pi in enumerate(inds):
        if pi < len(pr):
            q[ri] = pr[pi]
    return REC_THRS, q


def per_image_records(dataset, results, cls, metric="bbox",
                      ignore_other_classes=False):
    """Per-image match records for class ``cls`` (input to
    :func:`coco_ap` / :func:`coco_pr_curve`).

    ``ignore_other_classes``: other-class GT boxes join the pool as
    ignore regions (the error-analysis 'Oth'/'Sim' mode — reference
    ``tools/coco_error_analysis_f1.py`` ``analyze_individual_category``).
    """
    out = []
    for i in range(len(results)):
        res = results[i]
        if isinstance(res, tuple):
            bbox_r, segm_r = res[0], (res[1] if len(res) > 1 else None)
        else:
            bbox_r, segm_r = res, None
        ann = dataset.get_ann_info(i)
        sel = ann["labels"] == cls
        if ignore_other_classes:
            order = np.concatenate([np.nonzero(sel)[0],
                                    np.nonzero(~sel)[0]])
            gt_boxes = ann["bboxes"][order]
            gt_ignore = np.concatenate(
                [np.zeros(int(sel.sum()), bool),
                 np.ones(int((~sel).sum()), bool)])
        else:
            gt_boxes = ann["bboxes"][sel]
            gt_ignore = np.zeros(len(gt_boxes), bool)
        dets = np.asarray(bbox_r[cls], np.float32).reshape(-1, 5)
        if metric == "bbox":
            ious = _bbox_iou_np(dets[:, :4], gt_boxes,
                                iscrowd=gt_ignore
                                if ignore_other_classes else None)
        else:
            info = dataset.data_infos[i]
            h, w = info["height"], info["width"]
            if ignore_other_classes:
                keep = list(order)
            else:
                keep = list(np.nonzero(sel)[0])
            gt_rles = [mask_utils.encode_mask(
                mask_utils.poly_to_mask(ann["masks"][j], h, w))
                for j in keep]
            det_rles = segm_r[cls] if segm_r else []
            ious = mask_utils.mask_iou(det_rles, gt_rles) \
                if det_rles and gt_rles else np.zeros(
                    (len(det_rles), len(gt_rles)))
        out.append(dict(scores=dets[:, 4], ious=ious, gt_ignore=gt_ignore))
    return out


def evaluate_coco(dataset, results, metric_types=("bbox",), max_dets=100):
    """Evaluate result tuples against a CocoDataset.

    ``results[i]`` is either bbox_results (per-class list of (n,5)) or a
    tuple ``(bbox_results, segm_results[, offsets])``.
    """
    num_classes = len(dataset.CLASSES)
    metrics = {}
    for metric in metric_types:
        for c in range(num_classes):
            per_image = []
            for i in range(len(results)):
                res = results[i]
                if isinstance(res, tuple):
                    bbox_r = res[0]
                    segm_r = res[1] if len(res) > 1 else None
                else:
                    bbox_r, segm_r = res, None
                ann = dataset.get_ann_info(i)
                sel = ann["labels"] == c
                gt_boxes = ann["bboxes"][sel]
                dets = np.asarray(bbox_r[c], np.float32).reshape(-1, 5)
                scores = dets[:, 4]
                # coco_ap reads the first max_dets rows only
                if metric == "bbox":
                    ious = _bbox_iou_np(dets[:max_dets, :4], gt_boxes)
                elif metric == "segm":
                    info = dataset.data_infos[i]
                    h, w = info["height"], info["width"]
                    gt_rles = [mask_utils.encode_mask(
                        mask_utils.poly_to_mask(m, h, w))
                        for m, s in zip(ann["masks"], sel) if s]
                    det_rles = list(segm_r[c])[:max_dets] if segm_r else []
                    ious = mask_utils.mask_iou(det_rles, gt_rles) \
                        if det_rles and gt_rles else np.zeros(
                            (len(det_rles), len(gt_rles)))
                else:
                    raise KeyError(metric)
                per_image.append(dict(
                    scores=scores, ious=ious,
                    gt_ignore=np.zeros(len(gt_boxes), bool)))
            stats = coco_ap(per_image, max_dets=max_dets)
            suffix = "" if num_classes == 1 else f"_{dataset.CLASSES[c]}"
            metrics[f"{metric}_mAP{suffix}"] = stats["ap"]
            metrics[f"{metric}_mAP_50{suffix}"] = stats["ap50"]
            metrics[f"{metric}_mAP_75{suffix}"] = stats["ap75"]
    return metrics
