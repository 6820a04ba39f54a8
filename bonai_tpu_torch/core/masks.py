"""Host-side mask paste and COCO RLE, in numpy (counterpart of
``bonai_tpu/core/masks.py::paste_masks_np`` and the RLE encoder of
``bonai_tpu/datasets/mask_utils.py``, without cv2).

A detection's mask is pasted into its box crop only, and its RLE is built
from that crop: no ``(n, H, W)`` stack of full-image masks is ever made
(2000 detections of a 1024^2 tile would be 2 GB).
"""

from __future__ import annotations

import numpy as np


def _axis(n_in, n_out):
    """Source indices and weights of a half-pixel bilinear resize along one
    axis, with the border replicated (cv2 ``INTER_LINEAR``)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), max(n_in - 2, 0))
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_bilinear(img, out_h, out_w):
    """Bilinear resize of an ``(H, W)`` or ``(H, W, C)`` array to
    ``(out_h, out_w)``; float32 result."""
    y0, y1, fy = _axis(img.shape[0], out_h)
    x0, x1, fx = _axis(img.shape[1], out_w)
    img = np.asarray(img, np.float32)
    extra = (None,) * (img.ndim - 2)
    fy = fy[(slice(None), None) + extra]
    fx = fx[(slice(None),) + extra]
    top, bot = img[y0], img[y1]
    top = top[:, x0] * (1.0 - fx) + top[:, x1] * fx
    bot = bot[:, x0] * (1.0 - fx) + bot[:, x1] * fx
    return top * (1.0 - fy) + bot * fy


def counts_to_string(counts):
    """pycocotools ``rleToString``: 6-bit varints, delta-coded from the
    third count on."""
    s = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10))
                        or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(c + 48)
    return s.decode("ascii")


def crop_rle(crop, y0, x0, img_h, img_w):
    """COCO compressed RLE of the ``(img_h, img_w)`` binary mask that is
    zero except for ``crop`` placed at ``(y0, x0)``.  Runs are column-major
    and start with a zero run; only the crop's columns are scanned."""
    ch, cw = crop.shape
    counts = [img_h * img_w]
    if ch and cw:
        strip = np.zeros((img_h, cw), np.uint8)
        strip[y0:y0 + ch] = crop
        flat = strip.reshape(-1, order="F")
        change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
        if flat[0]:
            counts = [0] + counts
        counts[0] += x0 * img_h
        tail = (img_w - x0 - cw) * img_h
        if len(counts) % 2:           # last run is zeros
            counts[-1] += tail
        elif tail:
            counts.append(tail)
    return {"size": [int(img_h), int(img_w)],
            "counts": counts_to_string(counts)}


def paste_mask_rle(mask_prob, box, img_h, img_w, thr=0.5):
    """Paste one ``(S, S)`` mask probability map into its box of an
    ``(img_h, img_w)`` image, threshold it, and return its RLE."""
    x1, y1, x2, y2 = (float(v) for v in box)
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    w, h = max(x2i - x1i, 1), max(y2i - y1i, 1)
    xs, ys = max(x1i, 0), max(y1i, 0)
    xe, ye = min(x2i, img_w), min(y2i, img_h)
    if xe <= xs or ye <= ys:
        return crop_rle(np.zeros((0, 0), np.uint8), 0, 0, img_h, img_w)
    resized = resize_bilinear(mask_prob, h, w)
    crop = resized[ys - y1i:ye - y1i, xs - x1i:xe - x1i] > thr
    return crop_rle(crop.astype(np.uint8), ys, xs, img_h, img_w)
