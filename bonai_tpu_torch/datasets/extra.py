"""The non-BONAI datasets (counterpart of ``bonai_tpu/datasets/extra.py``):
Pascal-VOC-style XML annotations (``XMLDataset``, ``VOCDataset``,
``WIDERFaceDataset``) and the COCO-format LVIS, Cityscapes and
DeepFashion sets.

The JAX classes' behaviour is kept as it is (ROADMAP.md queue C records
each point): a box's ``xmin``/``ymin`` lose 1 (the mmdet v1 convention),
an LVIS image without ``file_name`` takes the last two parts of its
``coco_url``, and ``XMLDataset.evaluate`` returns ``mAP`` only.  The JAX
``XMLDataset`` has no ``prepare`` and no ``get_cat_ids``, so its loader
cannot take it; the port adds both (``prepare`` as ``CocoDataset``'s,
``get_cat_ids`` the image's labels) so that an XML set trains and tests
from its files.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from .coco import CocoDataset
from .pipelines import build_pipeline


class XMLDataset:
    """Pascal-VOC-style XML annotations.

    ``ann_file``: a text file of image ids; ``img_prefix``: the
    ``VOC2007/``-style root with ``JPEGImages/`` and ``Annotations/``.
    """
    CLASSES = None

    def __init__(self, ann_file, pipeline, img_prefix="", classes=None,
                 test_mode=False, filter_empty_gt=True, min_size=None,
                 img_subdir="JPEGImages", ann_subdir="Annotations",
                 **kwargs):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.min_size = min_size
        if classes is not None:
            self.CLASSES = classes
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations(ann_file)
        if not test_mode and filter_empty_gt:
            keep = [i for i in range(len(self.data_infos))
                    if len(self.get_ann_info(i)["bboxes"])]
            self.data_infos = [self.data_infos[i] for i in keep]
        self.pipeline = build_pipeline(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def _xml_path(self, img_id):
        return osp.join(self.img_prefix, self.ann_subdir, f"{img_id}.xml")

    def load_annotations(self, ann_file):
        infos = []
        with open(ann_file) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        for img_id in ids:
            filename = osp.join(self.img_subdir, f"{img_id}.jpg")
            xml_path = self._xml_path(img_id)
            width = height = 0
            if osp.exists(xml_path):
                size = ET.parse(xml_path).getroot().find("size")
                if size is not None:
                    width = int(size.find("width").text)
                    height = int(size.find("height").text)
            infos.append(dict(id=img_id, filename=filename,
                              width=width, height=height))
        return infos

    def get_ann_info(self, idx):
        xml_path = self._xml_path(self.data_infos[idx]["id"])
        bboxes, labels = [], []
        if osp.exists(xml_path):
            for obj in ET.parse(xml_path).getroot().findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                difficult = obj.find("difficult")
                if difficult is not None and int(difficult.text):
                    continue
                bb = obj.find("bndbox")
                box = [float(bb.find(t).text) - (1 if t.endswith("min")
                                                 else 0)
                       for t in ("xmin", "ymin", "xmax", "ymax")]
                if self.min_size and (box[2] - box[0] < self.min_size
                                      or box[3] - box[1] < self.min_size):
                    continue
                bboxes.append(box)
                labels.append(self.cat2label[name])
        return dict(bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                    labels=np.asarray(labels, np.int64), masks=[],
                    offsets=np.zeros((len(bboxes), 2), np.float32))

    def get_cat_ids(self, idx):
        """The labels of image ``idx``'s boxes."""
        return [int(v) for v in self.get_ann_info(idx)["labels"]]

    def prepare(self, idx, rng=None):
        """Run the pipeline for one index; ``None`` for a training image
        without boxes (the loader draws another)."""
        results = dict(img_info=self.data_infos[idx],
                       img_prefix=self.img_prefix,
                       ann_info=self.get_ann_info(idx))
        if (not self.test_mode and self.filter_empty_gt
                and len(results["ann_info"]["bboxes"]) == 0):
            return None
        if rng is not None:
            results["_rng"] = rng
        return self.pipeline(results)

    def evaluate(self, results, metric="mAP", iou_thr=0.5, **kwargs):
        """VOC mAP of per-image per-class detection lists."""
        from ..evaluation.mean_ap import eval_map
        anns = [self.get_ann_info(i) for i in range(len(self))]
        mean_ap, _ = eval_map(results, anns, iou_thr=iou_thr)
        return {"mAP": mean_ap}


class VOCDataset(XMLDataset):
    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog",
               "horse", "motorbike", "person", "pottedplant", "sheep",
               "sofa", "train", "tvmonitor")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if "VOC2007" in self.img_prefix:
            self.year = 2007
        elif "VOC2012" in self.img_prefix:
            self.year = 2012
        else:
            self.year = None


class WIDERFaceDataset(XMLDataset):
    """WIDER FACE converted to VOC-style XML; an id may name its event
    folder (``0--Parade/0_Parade_marchingband_1_5``)."""
    CLASSES = ("face",)


class LVISDataset(CocoDataset):
    """LVIS v0.5/v1 jsons: category names from the json; an image without
    ``file_name`` is found by its ``coco_url``'s last two parts
    (``train2017/000000391895.jpg``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for info in self.data_infos:
            if not info.get("filename") and info.get("coco_url"):
                info["filename"] = "/".join(
                    info["coco_url"].split("/")[-2:])


class CityscapesDataset(CocoDataset):
    """Cityscapes instances in the COCO json of
    ``tools/convert_datasets/cityscapes.py``."""
    CLASSES = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")


class DeepFashionDataset(CocoDataset):
    """DeepFashion in-shop segmentation, COCO json."""
    CLASSES = ("top", "skirt", "leggings", "dress", "outer", "pants",
               "bag", "neckwear", "headwear", "eyeglass", "belt",
               "footwear", "hair", "skin", "face")
