"""Detection visualisation (counterpart of ``bonai_tpu/utils/visualize.py``;
reference: ``mmdet/models/detectors/base.py:260-343`` and the LOFT offset
overlay, ``mmdet/models/detectors/loft.py:34-108``), drawn with
``utils/raster.py`` and written with ``utils/png.py`` instead of cv2.

The boxes, arrows and mask blends are the JAX function's pixels (a thick
line that crosses the image's border may differ from OpenCV's along its
edges, by at most 2 px).  A label is drawn in a 3x5 bitmap font of the
port's own, where the JAX function draws cv2's Hershey font (whose stroke
table the repository does not hold): its pixels lie inside the box
``cv2.getTextSize`` gives the label, and differ from cv2's there.
"""

from __future__ import annotations

import numpy as np

from ..datasets import mask_utils
from . import raster
from .png import write_png

# 3x5 glyphs, rows top to bottom; capitals are drawn as small letters
_GLYPHS = {
    "0": ("###", "#.#", "#.#", "#.#", "###"),
    "1": (".#.", "##.", ".#.", ".#.", "###"),
    "2": ("##.", "..#", ".#.", "#..", "###"),
    "3": ("##.", "..#", ".#.", "..#", "##."),
    "4": ("#.#", "#.#", "###", "..#", "..#"),
    "5": ("###", "#..", "##.", "..#", "##."),
    "6": (".##", "#..", "###", "#.#", "###"),
    "7": ("###", "..#", ".#.", ".#.", ".#."),
    "8": ("###", "#.#", "###", "#.#", "###"),
    "9": ("###", "#.#", "###", "..#", "##."),
    "a": ("...", ".##", "#.#", "#.#", ".##"),
    "b": ("#..", "##.", "#.#", "#.#", "##."),
    "c": ("...", ".##", "#..", "#..", ".##"),
    "d": ("..#", ".##", "#.#", "#.#", ".##"),
    "e": ("...", ".#.", "###", "#..", ".##"),
    "f": (".##", "#..", "##.", "#..", "#.."),
    "g": ("...", ".##", "#.#", ".##", "##."),
    "h": ("#..", "##.", "#.#", "#.#", "#.#"),
    "i": (".#.", "...", "##.", ".#.", "###"),
    "j": ("..#", "...", "..#", "#.#", ".#."),
    "k": ("#..", "#.#", "##.", "#.#", "#.#"),
    "l": ("##.", ".#.", ".#.", ".#.", "###"),
    "m": ("...", "###", "###", "#.#", "#.#"),
    "n": ("...", "##.", "#.#", "#.#", "#.#"),
    "o": ("...", ".#.", "#.#", "#.#", ".#."),
    "p": ("...", "##.", "#.#", "##.", "#.."),
    "q": ("...", ".##", "#.#", ".##", "..#"),
    "r": ("...", ".##", "#..", "#..", "#.."),
    "s": ("...", ".##", "##.", "..#", "##."),
    "t": (".#.", "###", ".#.", ".#.", "..#"),
    "u": ("...", "#.#", "#.#", "#.#", ".##"),
    "v": ("...", "#.#", "#.#", "#.#", ".#."),
    "w": ("...", "#.#", "#.#", "###", "###"),
    "x": ("...", "#.#", ".#.", ".#.", "#.#"),
    "y": ("...", "#.#", ".##", "..#", "##."),
    "z": ("...", "###", ".#.", "#..", "###"),
    ".": ("...", "...", "...", "...", ".#."),
    ",": ("...", "...", "...", ".#.", "#.."),
    ":": ("...", ".#.", "...", ".#.", "..."),
    "-": ("...", "...", "###", "...", "..."),
    "_": ("...", "...", "...", "...", "###"),
    "%": ("#.#", "..#", ".#.", "#..", "#.#"),
    "(": (".#.", "#..", "#..", "#..", ".#."),
    ")": (".#.", "..#", "..#", "..#", ".#."),
    " ": ("...",) * 5,
}
_UNKNOWN = ("###",) * 5


def put_text(img, text, org, color):
    """Draw ``text`` in the 3x5 font with its baseline row at ``org[1] - 1``
    and its first column at ``org[0]``, four pixels a character, clipped
    to the image.  In place; returns ``img``."""
    h, w = img.shape[:2]
    raw = raster._raw_color(img, color)
    x0, base = int(org[0]), int(org[1])
    for k, ch in enumerate(text):
        rows = _GLYPHS.get(ch.lower(), _UNKNOWN)
        for r, row in enumerate(rows):
            y = base - 5 + r
            for c, bit in enumerate(row):
                x = x0 + 4 * k + c
                if bit == "#" and 0 <= y < h and 0 <= x < w:
                    img[y, x] = raw
    return img


def _mask_pixels(rle):
    """The ``(ys, xs)`` of a COCO RLE's pixels, from its runs of ones (no
    full-image decode): the pixels the JAX function blends through the
    decoded mask."""
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = mask_utils.string_to_counts(counts)
    c = np.asarray(counts, np.int64)
    lengths = c[1::2]
    starts = np.cumsum(c)[1::2] - lengths
    idx = np.arange(int(lengths.sum())) + np.repeat(
        starts - (np.cumsum(lengths) - lengths), lengths)
    h = int(rle["size"][0])
    return idx % h, idx // h


def show_result(img, result, class_names=("building",), score_thr=0.3,
                out_file=None, offset_color=(0, 0, 255),
                bbox_color=(0, 255, 0), mask_color=(255, 144, 30)):
    """Draw boxes, labels, masks and roof-to-footprint offsets on a BGR
    ``uint8`` image, as the JAX ``show_result`` does: for every detection
    at or above ``score_thr``, its box (thickness 2) and label, its mask
    blended half and half with ``mask_color``, and its offset as an arrow
    from the box's centre (thickness 2).

    ``result`` is the reference-style tuple ``(bbox_results[, segm_results[,
    offsets]])`` (the offsets counted over every detection, as in JAX), or
    ``bbox_results`` alone.  Returns the drawn image, and writes it to
    ``out_file`` when given (a PNG: the port writes no other format).
    """
    if out_file and not str(out_file).lower().endswith(".png"):
        raise ValueError(f"{out_file}: the port writes PNG files only")
    img = np.ascontiguousarray(img).copy()
    if isinstance(result, tuple):
        bbox_r = result[0]
        segm_r = result[1] if len(result) > 1 else None
        offsets = result[2] if len(result) > 2 else None
    else:
        bbox_r, segm_r, offsets = result, None, None

    flat_idx = 0
    for c, dets in enumerate(bbox_r):
        dets = np.asarray(dets, np.float32).reshape(-1, 5)
        for j, det in enumerate(dets):
            score = det[4]
            if score < score_thr:
                flat_idx += 1
                continue
            x1, y1, x2, y2 = det[:4].astype(int)
            raster.rectangle(img, (x1, y1), (x2, y2), bbox_color, 2)
            label = class_names[c] if c < len(class_names) else str(c)
            put_text(img, f"{label} {score:.2f}", (x1, max(y1 - 3, 0)),
                     bbox_color)
            if segm_r is not None and j < len(segm_r[c]):
                ys, xs = _mask_pixels(segm_r[c][j])
                img[ys, xs] = (0.5 * img[ys, xs]
                               + 0.5 * np.array(mask_color)).astype(np.uint8)
            if offsets is not None and flat_idx < len(offsets):
                ox, oy = offsets[flat_idx]
                cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
                raster.arrowed_line(img, (cx, cy),
                                    (int(cx - ox), int(cy - oy)),
                                    offset_color, 2)
            flat_idx += 1
    if out_file:
        write_png(out_file, img)
    return img
