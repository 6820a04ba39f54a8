"""Small synthetic trees in the layouts of the non-BONAI datasets, written
without cv2: Pascal VOC (JPEGs and XML), WIDER FACE (the same, ids under
event folders), LVIS v1 (a json with ``coco_url`` and no ``file_name``,
JPEGs, category frequencies with a long tail), COCO-style Cityscapes and
DeepFashion jsons, and a Cityscapes ``leftImg8bit``/``gtFine`` tree with
16-bit ``instanceIds`` maps.  Images are smooth colour fields with
rectangles and ellipses for the objects; every function takes a seed.

    python -m bonai_tpu_torch.tools.make_synthetic_datasets voc OUT \\
        [--n 4] [--size 375 500] [--seed 0]

(likewise ``wider``, ``lvis``, ``cityscapes``).  The CPU tests and
``chip_smoke.py``'s ``datasets`` phase build their data with it.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from ..datasets.extra import DeepFashionDataset, VOCDataset
from ..utils.jpeg import encode_jpeg
from ..utils.png import write_png


def background(h, w, rng):
    """A smooth BGR ``uint8`` colour field with mild noise."""
    gh, gw = max(h // 64, 1) + 2, max(w // 64, 1) + 2
    grid = rng.rand(gh, gw, 3) * 200 + 28
    ys = np.linspace(0, gh - 1.001, h)
    xs = np.linspace(0, gw - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    g = grid
    img = (g[y0][:, x0] * (1 - fy) * (1 - fx) + g[y0 + 1][:, x0] * fy
           * (1 - fx) + g[y0][:, x0 + 1] * (1 - fy) * fx
           + g[y0 + 1][:, x0 + 1] * fy * fx)
    img = img + rng.randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def random_boxes(rng, h, w, n, min_frac=0.1, max_frac=0.5):
    """``n`` integer boxes ``[x1, y1, x2, y2]`` inside ``(h, w)``."""
    out = []
    for _ in range(n):
        bw = int(w * rng.uniform(min_frac, max_frac))
        bh = int(h * rng.uniform(min_frac, max_frac))
        x1 = int(rng.randint(0, max(w - bw, 1)))
        y1 = int(rng.randint(0, max(h - bh, 1)))
        out.append([x1, y1, x1 + max(bw, 2), y1 + max(bh, 2)])
    return out


def paint(img, box, rng):
    x1, y1, x2, y2 = box
    img[y1:y2, x1:x2] = (rng.rand(3) * 255).astype(np.uint8)


def _xml(w, h, objects):
    parts = [f"<annotation><size><width>{w}</width><height>{h}</height>"
             "<depth>3</depth></size>"]
    for name, (x1, y1, x2, y2), difficult in objects:
        parts.append(
            f"<object><name>{name}</name><difficult>{difficult}</difficult>"
            f"<bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
            f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
    return "".join(parts) + "</annotation>"


def make_xml_tree(root, ids, classes, size=(375, 500), seed=0,
                  quality=90, split="trainval"):
    """A VOC-layout tree at ``root`` (``JPEGImages/``, ``Annotations/``,
    ``ImageSets/Main/<split>.txt``) for the image ids ``ids``: each image
    2 to 4 objects of ``classes`` (the first of ``classes[0]``: the test
    loops keep class 0's detections only), every third one also a
    difficult object and one of an unknown class.  Returns the split
    file's path."""
    rng = np.random.RandomState(seed)
    h, w = size
    for i, img_id in enumerate(ids):
        img = background(h, w, rng)
        objects = []
        for k, box in enumerate(random_boxes(rng, h, w,
                                             int(rng.randint(2, 5)))):
            paint(img, box, rng)
            c = 0 if k == 0 else int(rng.randint(len(classes)))
            objects.append((classes[c], box, 0))
        if i % 3 == 0:
            objects.append((classes[0], random_boxes(rng, h, w, 1)[0], 1))
            objects.append(("unicorn", random_boxes(rng, h, w, 1)[0], 0))
        for sub, data in (("JPEGImages", encode_jpeg(img, quality)),
                          ("Annotations", _xml(w, h, objects).encode())):
            ext = ".jpg" if sub == "JPEGImages" else ".xml"
            path = osp.join(root, sub, img_id + ext)
            os.makedirs(osp.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
    split_file = osp.join(root, "ImageSets", "Main", f"{split}.txt")
    os.makedirs(osp.dirname(split_file), exist_ok=True)
    with open(split_file, "w") as f:
        f.write("\n".join(ids) + "\n")
    return split_file


def make_voc(root, n=4, size=(375, 500), seed=0, year=2007):
    """``root/VOC<year>`` with ``n`` images of VOC's 20 classes; returns
    ``(voc_dir, split_file)``."""
    voc_dir = osp.join(root, f"VOC{year}")
    ids = [f"{year}_{i:06d}" for i in range(n)]
    return voc_dir, make_xml_tree(voc_dir, ids, VOCDataset.CLASSES, size,
                                  seed)


def make_wider(root, n=4, size=(240, 320), seed=0):
    """A WIDER FACE tree (ids under event folders) of ``face`` boxes."""
    ids = [f"{i % 2}--Event/{i % 2}_Event_img_{i}" for i in range(n)]
    return make_xml_tree(root, ids, ("face",), size, seed, split="train")


def _polygon(box):
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    xs = cx + (x2 - x1) / 2 * np.cos(t)
    ys = cy + (y2 - y1) / 2 * np.sin(t)
    return [np.round(np.stack([xs, ys], 1).reshape(-1), 2).tolist()]


def make_coco_style(root, categories, n_images, n_files=None, size=(96, 128),
                    seed=0, coco_url=False, cat_images=None, prefix=""):
    """A COCO-format json (``root/annotations.json``) with ``n_images``
    entries over ``n_files`` JPEGs (image ``i`` shows file ``i mod
    n_files``), each annotation a box with its ellipse polygon.
    ``cat_images``: for each category, how many images hold it (the
    first category is in every image unless said otherwise).
    ``coco_url``: images carry ``coco_url`` and no ``file_name``, as LVIS
    v1 does.  Returns the json's path."""
    rng = np.random.RandomState(seed)
    h, w = size
    n_files = n_files or n_images
    files = []
    for i in range(n_files):
        name = osp.join(prefix, f"{i:012d}.jpg")
        img = background(h, w, rng)
        path = osp.join(root, name)
        os.makedirs(osp.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, 90))
        files.append(name)
    cats = [dict(id=i + 1, name=c) for i, c in enumerate(categories)]
    counts = cat_images or [n_images] * len(categories)
    holders = [set(rng.choice(n_images, min(k, n_images), replace=False))
               for k in counts]
    images, anns = [], []
    for i in range(n_images):
        info = dict(id=i + 1, width=w, height=h)
        name = files[i % n_files]
        if coco_url:
            info["coco_url"] = "http://images.cocodataset.org/" + name
        else:
            info["file_name"] = name
        images.append(info)
        for ci, hold in enumerate(holders):
            if i not in hold:
                continue
            box = random_boxes(rng, h, w, 1, 0.2, 0.6)[0]
            x1, y1, x2, y2 = box
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cats[ci]["id"],
                             bbox=[x1, y1, x2 - x1, y2 - y1],
                             area=float((x2 - x1) * (y2 - y1)), iscrowd=0,
                             segmentation=_polygon(box)))
    out = osp.join(root, "annotations.json")
    with open(out, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return out


def make_lvis(root, n_images=2000, n_files=4, n_rare=6, size=(96, 128),
              seed=0):
    """An LVIS-v1-style json: ``coco_url`` only, a frequent category in
    every image and ``n_rare`` categories in one image each (so that at
    ``oversample_thr=1e-3`` and 1001 or more images their images repeat),
    over ``n_files`` JPEGs under ``train2017/``."""
    cats = ["frequent"] + [f"rare_{i}" for i in range(n_rare)]
    return make_coco_style(root, cats, n_images, n_files, size, seed,
                           coco_url=True, cat_images=[n_images]
                           + [1] * n_rare, prefix="train2017")


def make_deepfashion(root, n=3, size=(96, 128), seed=0):
    return make_coco_style(root, DeepFashionDataset.CLASSES[:4], n, n, size,
                           seed, cat_images=[n, 2, 1, 1])


def make_cityscapes_tree(root, n=2, size=(1024, 2048), seed=0,
                         split="train", city="aachen"):
    """``root/leftImg8bit/<split>/<city>/*_leftImg8bit.png`` and the 16-bit
    ``gtFine/.../*_gtFine_instanceIds.png`` beside them: per image a car
    and a person instance (``label * 1000 + k``), a crowd of riders (the
    bare label 25), road (7) and a caravan (29: an instance label that is
    not evaluated)."""
    rng = np.random.RandomState(seed)
    h, w = size
    for i in range(n):
        stem = f"{city}_{i:06d}_000019"
        img = background(h, w, rng)
        inst = np.full((h, w), 7, np.uint16)
        for value in (26000, 24001, 25, 29000, 26002):
            box = random_boxes(rng, h, w, 1, 0.05, 0.25)[0]
            x1, y1, x2, y2 = box
            inst[y1:y2, x1:x2] = value
            paint(img, box, rng)
        for sub, name, arr in (
                ("leftImg8bit", f"{stem}_leftImg8bit.png", img),
                ("gtFine", f"{stem}_gtFine_instanceIds.png", inst)):
            path = osp.join(root, sub, split, city, name)
            os.makedirs(osp.dirname(path), exist_ok=True)
            write_png(path, arr)
    return root


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kind", choices=["voc", "wider", "lvis",
                                         "cityscapes", "deepfashion"])
    parser.add_argument("out")
    parser.add_argument("--n", type=int, default=4)
    parser.add_argument("--size", type=int, nargs=2, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    kw = dict(seed=args.seed)
    if args.size:
        kw["size"] = tuple(args.size)
    if args.kind == "voc":
        print(make_voc(args.out, args.n, **kw))
    elif args.kind == "wider":
        print(make_wider(args.out, args.n, **kw))
    elif args.kind == "lvis":
        print(make_lvis(args.out, max(args.n, 1), **kw))
    elif args.kind == "deepfashion":
        print(make_deepfashion(args.out, args.n, **kw))
    else:
        print(make_cityscapes_tree(args.out, args.n, **kw))


if __name__ == "__main__":
    main()
