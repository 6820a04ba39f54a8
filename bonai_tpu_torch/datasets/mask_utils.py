"""COCO compressed RLE and polygon rasterisation in numpy (counterpart of
``bonai_tpu/datasets/mask_utils.py``, without its native build and without
cv2).

The encoder is ``core/masks.py``'s (``counts_to_string`` and ``crop_rle``,
which also paste the detector's masks); this module adds the decoder, the
area and the full-mask encoder built on them.  ``counts`` are ``str``, as
the JAX package writes them, so the result pickles of the two packages
read each other.
"""

from __future__ import annotations

import numpy as np

from ..core.masks import counts_to_string, crop_rle
from ..utils.raster import fill_poly

__all__ = ["counts_to_string", "decode_mask", "encode_mask", "poly_to_mask",
           "rle_area", "rle_counts_to_mask", "string_to_counts"]


def poly_to_mask(polys, h, w):
    """Rasterise a multi-part polygon (COCO 'segmentation' list of flat
    ``[x0, y0, x1, y1, ...]``) into an ``(h, w)`` uint8 mask
    (``cv2.fillPoly``'s pixels)."""
    mask = np.zeros((h, w), np.uint8)
    pts = []
    for p in polys:
        arr = np.asarray(p, np.float64).reshape(-1, 2)
        if arr.shape[0] >= 3:
            pts.append(np.round(arr).astype(np.int32))
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def string_to_counts(s):
    """pycocotools ``rleFrString``: the run lengths of a compressed RLE
    string (``str`` or ``bytes``)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_counts_to_mask(counts, h, w):
    """Column-major run lengths, starting with a zero run -> ``(h, w)``
    uint8 mask."""
    flat = np.repeat(np.arange(len(counts), dtype=np.uint8) & 1,
                     np.asarray(counts, np.int64))
    out = np.zeros(h * w, np.uint8)
    out[:flat.size] = flat[:h * w]
    return out.reshape((h, w), order="F")


def encode_mask(mask):
    """``(h, w)`` binary mask -> COCO compressed RLE dict."""
    mask = np.asarray(mask, np.uint8)
    h, w = mask.shape
    return crop_rle(mask, 0, 0, h, w)


def _counts(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return counts


def decode_mask(rle):
    h, w = rle["size"]
    return rle_counts_to_mask(_counts(rle), h, w)


def rle_area(rle):
    return int(sum(_counts(rle)[1::2]))
