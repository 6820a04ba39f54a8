"""BONAI dataset, buildings in off-nadir aerial imagery (counterpart of
``bonai_tpu/datasets/bonai.py``).  Each annotation carries a roof mask
(``segmentation``), a footprint mask and box, a building box, a
roof-to-footprint ``offset`` and optionally a building height; the config
selects which box (``bbox_type``) and mask (``mask_type``) supervise the
detector (the BONAI recipe: building boxes and roof masks).
``results2json`` and ``write_results2csv`` write results and summaries.
"""

from __future__ import annotations

import csv
import json
import math
import os.path as osp

import numpy as np

from .coco import CocoDataset


class BONAI(CocoDataset):
    CLASSES = ("building",)

    def __init__(self, ann_file, pipeline, bbox_type="building",
                 mask_type="roof", offset_coordinate="rectangle",
                 resolution=0.6, ignore_buildings=True,
                 gt_footprint_csv_file="", data_root=None,
                 edge_prefix=None, side_face_prefix=None,
                 offset_field_prefix=None, **kwargs):
        self.bbox_type = bbox_type
        self.mask_type = mask_type
        self.offset_coordinate = offset_coordinate
        self.resolution = resolution
        self.ignore_buildings = ignore_buildings
        self.gt_footprint_csv_file = gt_footprint_csv_file

        def anchor(prefix):
            """Relative auxiliary prefixes are anchored at ``data_root``."""
            if data_root is not None and prefix is not None \
                    and not osp.isabs(prefix):
                return osp.join(data_root, prefix)
            return prefix
        self.edge_prefix = anchor(edge_prefix)
        self.side_face_prefix = anchor(side_face_prefix)
        self.offset_field_prefix = anchor(offset_field_prefix)
        super().__init__(ann_file, pipeline, **kwargs)

    def pre_pipeline(self, results):
        """The auxiliary prefixes and the field registries that the
        offset-aware transforms read."""
        super().pre_pipeline(results)
        results["edge_prefix"] = self.edge_prefix
        results["side_face_prefix"] = self.side_face_prefix
        results["offset_field_prefix"] = self.offset_field_prefix
        results["edge_fields"] = []
        results["side_face_fields"] = []
        results["offset_field_fields"] = []

    def _parse_ann_info(self, img_info, ann_info):
        bboxes, labels, masks = [], [], []
        roof_masks, footprint_masks = [], []
        offsets, heights, angles = [], [], []
        footprint_bboxes = []
        only_footprint_flag = 0
        for ann in ann_info:
            if ann.get("ignore", False):
                continue
            if self.bbox_type == "roof":
                x1, y1, w, h = ann["bbox"]
            elif self.bbox_type == "building":
                x1, y1, w, h = ann["building_bbox"]
            elif self.bbox_type == "footprint":
                x1, y1, w, h = ann["footprint_bbox"]
            else:
                raise TypeError(f"unsupported bbox_type={self.bbox_type}")
            inter_w = max(0, min(x1 + w, img_info["width"]) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info["height"]) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann["category_id"] not in self.cat2label:
                continue
            if ann.get("iscrowd", False) and self.ignore_buildings:
                continue
            bboxes.append([x1, y1, x1 + w, y1 + h])
            labels.append(self.cat2label[ann["category_id"]])
            if "only_footprint" in ann:
                # last value wins: re-evaluated for every annotation that
                # carries the key, kept when it is absent
                only_footprint_flag = 1 if ann["only_footprint"] == 1 else 0
            if only_footprint_flag:
                # a footprint-only image trains on the footprint whatever
                # mask_type says
                masks.append([ann["footprint_mask"]])
            elif self.mask_type == "roof":
                masks.append(ann["segmentation"])
            elif self.mask_type == "footprint":
                masks.append([ann["footprint_mask"]])
            else:
                raise TypeError(f"unsupported mask_type={self.mask_type}")
            roof_masks.append(ann["segmentation"])
            if "footprint_mask" in ann:
                footprint_masks.append([ann["footprint_mask"]])
            if "footprint_bbox" in ann:
                fx, fy, fw, fh = ann["footprint_bbox"]
                footprint_bboxes.append([fx, fy, fx + fw, fy + fh])
            if "offset" in ann:
                ox, oy = ann["offset"]
                if self.offset_coordinate == "rectangle":
                    offsets.append([ox, oy])
                else:
                    offsets.append([math.hypot(ox, oy),
                                    math.atan2(oy, ox)])
            else:
                offsets.append([0.0, 0.0])
            heights.append(ann.get("building_height", 0.0))
            if "offset" in ann and "building_height" in ann:
                ox, oy = ann["offset"]
                angles.append(math.atan2(
                    math.hypot(ox, oy) * self.resolution,
                    ann["building_height"]))
        mean_angle = float(np.mean(angles)) if angles else 1e-4
        fname = img_info.get("filename", img_info.get("file_name", ""))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            masks=masks,
            roof_masks=roof_masks,
            footprint_masks=footprint_masks,
            footprint_bboxes=np.asarray(
                footprint_bboxes, np.float32).reshape(-1, 4),
            offsets=np.asarray(offsets, np.float32).reshape(-1, 2),
            building_heights=np.asarray(heights, np.float32),
            angle=mean_angle,
            only_footprint_flag=float(only_footprint_flag),
            # auxiliary dense-supervision file names, from the image's
            edge_map=fname.replace("jpg", "png"),
            side_face_map=fname.replace("jpg", "png"),
            offset_field=fname.replace("png", "npy").replace("jpg", "npy"),
        )

    # ---------------- result dumping / summaries ----------------

    @staticmethod
    def _xyxy2xywh(box):
        x1, y1, x2, y2 = [float(v) for v in box[:4]]
        return [x1, y1, x2 - x1, y2 - y1]

    def results2json(self, results, outfile_prefix):
        """Dump per-image result tuples to COCO-style json files.

        Accepts 2/3/4-tuples ``(det, seg[, offset[, height]])`` per image
        (reference ``bonai.py:258-301`` ``_segm2json``).  Returns the dict
        of written files.
        """
        bbox_json, segm_json, offset_json = [], [], []
        for idx, res in enumerate(results):
            img_id = self.img_ids[idx]
            if not isinstance(res, tuple):
                res = (res,)
            det = res[0]
            seg = res[1] if len(res) > 1 else None
            offsets = res[2] if len(res) > 2 else None
            heights = res[3] if len(res) > 3 else None
            for label, bboxes in enumerate(det):
                bboxes = np.asarray(bboxes).reshape(-1, 5)
                if seg is not None:
                    segms, mask_score = (seg if isinstance(seg, tuple)
                                         else (seg, None))
                    segms = segms[label]
                for i in range(bboxes.shape[0]):
                    entry = dict(image_id=img_id,
                                 bbox=self._xyxy2xywh(bboxes[i]),
                                 score=float(bboxes[i][4]),
                                 category_id=self.cat_ids[label])
                    bbox_json.append(entry)
                    if seg is not None and i < len(segms):
                        sd = dict(entry)
                        rle = segms[i]
                        if isinstance(rle, dict) and isinstance(
                                rle.get("counts"), bytes):
                            rle = dict(rle, counts=rle["counts"].decode())
                        sd["segmentation"] = rle
                        if mask_score is not None:
                            sd["score"] = float(mask_score[label][i])
                        segm_json.append(sd)
                    if offsets is not None and i < len(offsets):
                        od = dict(entry)
                        od["offset"] = [float(v) for v in offsets[i][:2]]
                        if heights is not None and i < len(heights):
                            od["building_height"] = float(
                                np.asarray(heights[i]).reshape(-1)[0])
                        offset_json.append(od)
        files = {}
        for name, payload in (("bbox", bbox_json), ("segm", segm_json),
                              ("offset", offset_json)):
            if payload or name == "bbox":
                path = f"{outfile_prefix}.{name}.json"
                with open(path, "w") as f:
                    json.dump(payload, f)
                files[name] = path
        return files

    def write_results2csv(self, results, meta_info=None):
        """Evaluation summary CSV (reference ``bonai.py:305-328``)."""
        seg_results = results[0]
        meta_info = meta_info or {}
        with open(meta_info["summary_file"], "w", newline="") as fh:
            w = csv.writer(fh, delimiter=",")
            w.writerow(["Meta Info"])
            for key in ("model", "anno_file", "gt_roof_csv_file",
                        "gt_footprint_csv_file", "vis_dir"):
                w.writerow([key, meta_info.get(key, "")])
            w.writerow([""])
            for mask_type in ("roof", "footprint"):
                if mask_type not in seg_results:
                    continue
                r = seg_results[mask_type]
                w.writerow([mask_type])
                w.writerow(["F1 Score", r.get("F1_score")])
                w.writerow(["Precision", r.get("Precision")])
                w.writerow(["Recall", r.get("Recall")])
                w.writerow(["True Positive", r.get("TP")])
                w.writerow(["False Positive", r.get("FP")])
                w.writerow(["False Negative", r.get("FN")])
                w.writerow([""])
