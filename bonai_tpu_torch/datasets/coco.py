"""COCO-style dataset (counterpart of ``bonai_tpu/datasets/coco.py``):
annotation loading, image filtering and per-index pipeline execution.
Batching and padding are the loader's (``builder.py``)."""

from __future__ import annotations

import numpy as np

from .coco_api import COCOIndex
from .pipelines import build_pipeline


class CocoDataset:
    CLASSES = None

    def __init__(self, ann_file, pipeline, img_prefix="", classes=None,
                 test_mode=False, filter_empty_gt=True, min_size=32,
                 proposal_file=None, **kwargs):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.min_size = min_size
        # precomputed proposals for Fast R-CNN-style training: a pickled
        # list of per-image (N, 4|5) arrays in the annotation image order
        self.proposal_file = proposal_file
        self.proposals = None
        if proposal_file is not None:
            import pickle
            with open(proposal_file, "rb") as f:
                self.proposals = pickle.load(f)
        if classes is not None:
            self.CLASSES = classes
        self.coco = COCOIndex(ann_file)
        if self.CLASSES:
            self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        else:
            self.cat_ids = self.coco.get_cat_ids()
            self.CLASSES = [self.coco.cats[c].get("name", str(c))
                            for c in self.cat_ids]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        self.data_infos = self.coco.load_imgs(self.img_ids)
        for info in self.data_infos:   # mmdet convention
            info.setdefault("filename", info.get("file_name"))
        if not test_mode:
            valid = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid]
            self.img_ids = [self.img_ids[i] for i in valid]
            if self.proposals is not None:
                self.proposals = [self.proposals[i] for i in valid]
        self.pipeline = build_pipeline(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def _filter_imgs(self):
        """Drop tiny images and (optionally) images without GT."""
        valid = []
        for i, info in enumerate(self.data_infos):
            if min(info["width"], info["height"]) < self.min_size:
                continue
            if self.filter_empty_gt:
                anns = self.coco.load_anns_for_img(info["id"])
                if not any(a.get("category_id") in self.cat2label
                           and not a.get("iscrowd", False) for a in anns):
                    continue
            valid.append(i)
        return valid

    def get_ann_info(self, idx):
        img_info = self.data_infos[idx]
        anns = self.coco.load_anns_for_img(img_info["id"])
        return self._parse_ann_info(img_info, anns)

    def get_cat_ids(self, idx):
        """Category ids present in image ``idx``."""
        anns = self.coco.load_anns_for_img(self.data_infos[idx]["id"])
        return [a["category_id"] for a in anns]

    def _parse_ann_info(self, img_info, ann_info):
        bboxes, labels, masks, bboxes_ignore = [], [], [], []
        for ann in ann_info:
            x1, y1, w, h = ann["bbox"]
            if ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann["category_id"] not in self.cat2label:
                continue
            if ann.get("ignore", False) or ann.get("iscrowd", False):
                bboxes_ignore.append([x1, y1, x1 + w, y1 + h])
                continue
            bboxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(self.cat2label[ann["category_id"]])
            masks.append(ann.get("segmentation", []))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            masks=masks,
            bboxes_ignore=np.asarray(bboxes_ignore,
                                     np.float32).reshape(-1, 4),
            offsets=np.zeros((len(bboxes), 2), np.float32),
        )

    def evaluate(self, results, metric="bbox", iou_thr=0.5,
                 proposal_nums=(100, 300, 1000)):
        """COCO AP for ``'bbox'`` and ``'segm'``, VOC ``'mAP'`` at
        ``iou_thr`` and proposal ``'recall'`` (``AR@N`` for each of
        ``proposal_nums``) of ``results`` (the JAX package's method).
        BONAI F1 and offset error are
        ``bonai_tpu_torch.tools.bonai_evaluation``'s."""
        metrics = [metric] if isinstance(metric, str) else list(metric)
        out = {}
        coco_kinds = [m for m in metrics if m in ("bbox", "segm")]
        if coco_kinds:
            from ..evaluation.coco_eval import evaluate_coco
            out.update(evaluate_coco(self, results,
                                     metric_types=coco_kinds))
        if "mAP" in metrics:
            from ..evaluation.mean_ap import eval_map
            anns = [self.get_ann_info(i) for i in range(len(results))]
            dets = [r[0] if isinstance(r, tuple) else r for r in results]
            mean_ap, _ = eval_map(dets, anns, iou_thr=iou_thr)
            out["mAP"] = mean_ap
        if "recall" in metrics or "proposal_fast" in metrics:
            from ..evaluation.mean_ap import eval_recalls
            gts = [self.get_ann_info(i)["bboxes"]
                   for i in range(len(results))]
            props = []
            for r in results:
                dets = r[0] if isinstance(r, tuple) else r
                props.append(np.concatenate(
                    [np.asarray(d).reshape(-1, 5) for d in dets], axis=0))
            rec = eval_recalls(gts, props, proposal_nums, (iou_thr,))
            for i, n in enumerate(proposal_nums):
                out[f"AR@{n}"] = float(rec[i, 0])
        return out

    def pre_pipeline(self, results):
        """Hook for subclasses to add prefixes and field registries."""
        return results

    def prepare(self, idx, rng=None):
        """Run the pipeline for one index; returns the result dict, or
        ``None`` for a training image without GT (the loader retries)."""
        img_info = self.data_infos[idx]
        results = dict(img_info=img_info, img_prefix=self.img_prefix)
        if self.proposals is not None:
            results["proposals"] = self.proposals[idx]
        self.pre_pipeline(results)
        results["ann_info"] = self.get_ann_info(idx)
        if (not self.test_mode and self.filter_empty_gt
                and len(results["ann_info"]["bboxes"]) == 0):
            return None
        if rng is not None:
            results["_rng"] = rng
        return self.pipeline(results)
