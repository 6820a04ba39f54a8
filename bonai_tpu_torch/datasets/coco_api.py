"""Minimal COCO-json index (the port's copy of
``bonai_tpu/datasets/coco_api.py``): image listing, per-image annotation
lookup and category ids, the surface mmdet uses through
``pycocotools.coco.COCO``.  Pure json and dicts."""

from __future__ import annotations

import json
from collections import defaultdict


class COCOIndex:
    def __init__(self, annotation_file=None, dataset=None):
        if dataset is None:
            with open(annotation_file, "r", encoding="utf-8") as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs = {img["id"]: img for img in dataset.get("images", [])}
        self.cats = {c["id"]: c for c in dataset.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        self.anns = {}
        for ann in dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def get_img_ids(self):
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names=None):
        if cat_names is None:
            return list(self.cats.keys())
        return [cid for cid, c in self.cats.items()
                if c.get("name") in cat_names]

    def load_imgs(self, ids):
        return [self.imgs[i] for i in ids]

    def load_anns_for_img(self, img_id):
        return list(self.img_to_anns.get(img_id, []))
