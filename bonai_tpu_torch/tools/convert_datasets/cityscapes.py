"""Convert Cityscapes gtFine annotations to COCO-style instance jsons
(counterpart of the JAX package's ``tools/convert_datasets/
cityscapes.py``; the same json).

    python -m bonai_tpu_torch.tools.convert_datasets.cityscapes \\
        CITYSCAPES_DIR OUT_DIR

``CITYSCAPES_DIR`` holds ``leftImg8bit/{split}`` and ``gtFine/{split}``;
``OUT_DIR`` receives ``instancesonly_filtered_gtFine_{split}.json``.  The
16-bit ``*_gtFine_instanceIds.png`` maps are read with
``utils/png.py::read_png(unchanged=True)``: a value of at least 24 is an
instance class, one of at least 1000 encodes ``label_id * 1000 +
instance`` (a crowd region keeps the bare label id).  Only the 8
instance-evaluated classes are kept (``CityscapesDataset.CLASSES``); each
mask is encoded by ``datasets/mask_utils.py::encode_mask``.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import sys

import numpy as np

from ...datasets.mask_utils import encode_mask
from ...utils.png import read_png

# cityscapesscripts label ids of the 8 instance classes
INSTANCE_LABELS = {
    24: "person", 25: "rider", 26: "car", 27: "truck", 28: "bus",
    31: "train", 32: "motorcycle", 33: "bicycle",
}


def mask_bbox(mask):
    ys, xs = np.nonzero(mask)
    if not len(xs):
        return None
    x1, x2 = xs.min(), xs.max() + 1
    y1, y2 = ys.min(), ys.max() + 1
    return [float(x1), float(y1), float(x2 - x1), float(y2 - y1)]


def convert_split(cs_dir, split, out_json):
    """Write one split's json; returns ``(images, instances)`` counts."""
    img_dir = osp.join(cs_dir, "leftImg8bit", split)
    gt_dir = osp.join(cs_dir, "gtFine", split)
    suffix = "leftImg8bit.png"
    img_files = sorted(glob.glob(osp.join(img_dir, "**", "*.png"),
                                 recursive=True))
    categories = [dict(id=lid, name=name)
                  for lid, name in sorted(INSTANCE_LABELS.items())]
    images, annotations = [], []
    for img_idx, img_file in enumerate(img_files, 1):
        rel = osp.relpath(img_file, img_dir)
        inst_file = osp.join(gt_dir, rel[:-len(suffix)]
                             + "gtFine_instanceIds.png")
        if not osp.isfile(inst_file):
            print(f"skipping {rel}: no instance map at {inst_file}")
            continue
        inst_img = read_png(inst_file, unchanged=True)
        h, w = inst_img.shape[:2]
        images.append(dict(id=img_idx, file_name=rel, width=int(w),
                           height=int(h),
                           segm_file=osp.join(
                               osp.dirname(rel),
                               osp.basename(inst_file).replace(
                                   "instanceIds", "labelIds"))))
        for inst_id in np.unique(inst_img[inst_img >= 24]):
            label_id = int(inst_id) // 1000 if inst_id >= 1000 \
                else int(inst_id)
            if label_id not in INSTANCE_LABELS:
                continue
            mask = (inst_img == inst_id).astype(np.uint8)
            bbox = mask_bbox(mask)
            if bbox is None:
                continue
            annotations.append(dict(
                id=len(annotations) + 1, image_id=img_idx,
                category_id=label_id, bbox=bbox, area=float(mask.sum()),
                iscrowd=int(inst_id < 1000), segmentation=encode_mask(mask)))
    with open(out_json, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    print(f"{split}: {len(images)} images, {len(annotations)} instances "
          f"-> {out_json}")
    return len(images), len(annotations)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    cs_dir, out_dir = argv
    os.makedirs(out_dir, exist_ok=True)
    for split in ("train", "val", "test"):
        if osp.isdir(osp.join(cs_dir, "leftImg8bit", split)):
            convert_split(cs_dir, split, osp.join(
                out_dir, f"instancesonly_filtered_gtFine_{split}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
