"""Draw the train pipeline's outputs (counterpart of
``tools/browse_dataset.py``).

    python -m bonai_tpu_torch.tools.browse_dataset CONFIG \\
        [--output-dir work_dirs/browse] [--num 10]

For the first ``--num`` samples of the config's ``data.train`` (the
pipeline's draws from ``RandomState(0)``, as in JAX), draws each GT box
(thickness 2), its offset arrow from the box's centre and its polygon
outlines (thickness 1) on the pipeline's image, clipped to ``[0, 255]`` as
the JAX tool does, and writes ``sample_<i>.png`` with
``utils/raster.py`` and ``utils/png.py`` (no cv2).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..config import Config
from ..datasets import build_dataset
from ..utils import raster
from ..utils.png import write_png


def draw_sample(res):
    """The drawn ``uint8`` BGR image of one pipeline result."""
    img = res["img"]
    norm = res.get("img_norm_cfg")
    if norm is not None:
        img = res["img"] * norm["std"] + norm["mean"]
        if norm["to_rgb"]:
            img = img[..., ::-1]    # back to BGR
    img = np.clip(img, 0, 255).astype(np.uint8).copy()
    for j, box in enumerate(res.get("gt_bboxes", [])):
        x1, y1, x2, y2 = box.astype(int)
        raster.rectangle(img, (x1, y1), (x2, y2), (0, 255, 0), 2)
        off = res.get("gt_offsets")
        if off is not None:
            cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
            raster.arrowed_line(img, (cx, cy), (int(cx - off[j][0]),
                                                int(cy - off[j][1])),
                                (0, 0, 255), 2)
        for part in res.get("gt_masks", [[]])[j]:
            raster.polylines(img, [part.astype(np.int32)], True,
                             (255, 0, 0), 1)
    return img


def browse(cfg, output_dir, num=10):
    """Write the drawn samples; returns their paths."""
    dataset = build_dataset(cfg.data.train)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    written = []
    for i in range(min(num, len(dataset))):
        res = dataset.prepare(i, rng)
        if res is None:
            continue
        out = osp.join(output_dir, f"sample_{i}.png")
        write_png(out, draw_sample(res))
        written.append(out)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description="Draw pipeline outputs")
    parser.add_argument("config")
    parser.add_argument("--output-dir", default="work_dirs/browse")
    parser.add_argument("--num", type=int, default=10)
    args = parser.parse_args(argv)
    for out in browse(Config.fromfile(args.config), args.output_dir,
                      args.num):
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
