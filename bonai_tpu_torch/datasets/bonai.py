"""BONAI dataset, buildings in off-nadir aerial imagery (counterpart of
``bonai_tpu/datasets/bonai.py``).  Each annotation carries a roof mask
(``segmentation``), a footprint mask and box, a building box, a
roof-to-footprint ``offset`` and optionally a building height; the config
selects which box (``bbox_type``) and mask (``mask_type``) supervise the
detector (the BONAI recipe: building boxes and roof masks).  Writing
results (``results2json``, ``write_results2csv``) is ROADMAP.md item A3d.
"""

from __future__ import annotations

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
