"""Convert PASCAL VOC XML annotations to a COCO-style json (counterpart of
the JAX package's ``tools/convert_datasets/pascal_voc.py``; the same
json, so the converted set loads through ``CocoDataset``).

    python -m bonai_tpu_torch.tools.convert_datasets.pascal_voc \\
        VOCDIR SPLIT OUT.json

``VOCDIR``: e.g. ``data/VOCdevkit/VOC2007``; ``SPLIT``: e.g. ``trainval``
(reads ``ImageSets/Main/trainval.txt``), else the path of a bare id list.
A box's ``xmin``/``ymin`` lose 1, as ``VOCDataset`` reads them; a
``difficult`` object becomes ``iscrowd``.
"""

from __future__ import annotations

import json
import os.path as osp
import sys
import xml.etree.ElementTree as ET

from ...datasets.extra import VOCDataset


def convert(voc_dir, split, out_json):
    """Write ``out_json``; returns ``(images, annotations)`` counts."""
    split_file = osp.join(voc_dir, "ImageSets", "Main", f"{split}.txt")
    if not osp.isfile(split_file):
        split_file = split
    with open(split_file) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    categories = [dict(id=i + 1, name=c)
                  for i, c in enumerate(VOCDataset.CLASSES)]
    name2id = {c["name"]: c["id"] for c in categories}
    images, annotations = [], []
    for img_idx, img_id in enumerate(ids, 1):
        xml_path = osp.join(voc_dir, "Annotations", f"{img_id}.xml")
        width = height = 0
        objs = []
        if osp.isfile(xml_path):
            root = ET.parse(xml_path).getroot()
            size = root.find("size")
            if size is not None:
                width = int(size.find("width").text)
                height = int(size.find("height").text)
            objs = root.findall("object")
        images.append(dict(id=img_idx, width=width, height=height,
                           file_name=f"JPEGImages/{img_id}.jpg"))
        for obj in objs:
            name = obj.find("name").text
            if name not in name2id:
                continue
            bb = obj.find("bndbox")
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text)
            y2 = float(bb.find("ymax").text)
            difficult = obj.find("difficult")
            annotations.append(dict(
                id=len(annotations) + 1, image_id=img_idx,
                category_id=name2id[name],
                bbox=[x1, y1, x2 - x1, y2 - y1],
                area=(x2 - x1) * (y2 - y1),
                iscrowd=int(difficult.text) if difficult is not None
                else 0))
    with open(out_json, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    return len(images), len(annotations)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        return 1
    n_img, n_ann = convert(*argv)
    print(f"wrote {argv[2]}: {n_img} images, {n_ann} annotations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
