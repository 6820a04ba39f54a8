"""COCO compressed RLE and polygon rasterisation (counterpart of
``bonai_tpu/datasets/mask_utils.py``, without cv2).

Encoding, decoding and ``mask_iou`` without ``iscrowd`` run in the host's
mask library (``bonai_tpu_torch/native.py``), where the JAX package takes
its native library; a failed build raises.  Their numpy versions are the
plain ones, taken only when the caller passes ``native=False``: the
encoder of ``core/masks.py`` (``counts_to_string`` and ``crop_rle``, which
also paste the detector's masks), the decoder below, and a ``mask_iou``
that intersects the run lengths themselves and never decodes a mask.
``counts`` are ``str``, as the JAX package writes them, so the result
pickles of the two packages read each other.
"""

from __future__ import annotations

import numpy as np

from .. import native as maskops
from ..core.masks import counts_to_string, crop_rle
from ..utils.raster import fill_poly

__all__ = ["counts_to_string", "decode_mask", "encode_mask", "mask_iou",
           "poly_to_mask", "rle_area", "rle_counts_to_mask",
           "string_to_counts"]


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


def rle_counts_to_mask(counts, h, w, native=True):
    """Column-major run lengths, starting with a zero run -> ``(h, w)``
    uint8 mask (in the mask library unless ``native=False``)."""
    if native:
        return maskops.rle_decode_counts(counts, h, w)
    flat = np.repeat(np.arange(len(counts), dtype=np.uint8) & 1,
                     np.asarray(counts, np.int64))
    out = np.zeros(h * w, np.uint8)
    out[:flat.size] = flat[:h * w]
    return out.reshape((h, w), order="F")


def encode_mask(mask, native=True):
    """``(h, w)`` binary mask -> COCO compressed RLE dict (run lengths from
    the mask library unless ``native=False``)."""
    mask = np.asarray(mask, np.uint8)
    h, w = mask.shape
    if native:
        return {"size": [int(h), int(w)], "counts": counts_to_string(
            maskops.rle_encode_counts(mask))}
    return crop_rle(mask, 0, 0, h, w)


def _counts(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return counts


def decode_mask(rle, native=True):
    h, w = rle["size"]
    return rle_counts_to_mask(_counts(rle), h, w, native)


def rle_area(rle):
    return int(sum(_counts(rle)[1::2]))


class _Runs:
    """The runs of ones of a column-major RLE of height ``h``: ``starts``
    and ``ends`` (flat indices, ``int64``), the pixels before each run
    (``before``), the area and the bounding box ``(x0, y0, x1, y1)``,
    inclusive (``None`` when the mask is empty)."""

    def __init__(self, rle):
        c = np.asarray(_counts(rle), np.int64)
        h = int(rle["size"][0])
        ends = np.cumsum(c)[1::2]
        lengths = c[1::2]
        keep = lengths > 0
        self.ends, lengths = ends[keep], lengths[keep]
        self.starts = self.ends - lengths
        self.before = np.cumsum(lengths) - lengths
        self.area = int(lengths.sum())
        self.box = None
        if self.area:
            col0, col1 = self.starts // h, (self.ends - 1) // h
            one_col = col0 == col1
            self.box = (int(col0[0]), int(np.where(
                one_col, self.starts % h, 0).min()), int(col1[-1]),
                int(np.where(one_col, (self.ends - 1) % h, h - 1).max()))

    def covered(self, x):
        """The mask's pixels at flat indices below each of ``x``."""
        j = np.searchsorted(self.starts, x, side="left") - 1
        jc = np.maximum(j, 0)
        inside = np.minimum(x, self.ends[jc]) - self.starts[jc]
        return np.where(j >= 0, self.before[jc] + inside, 0)


def _overlap(a, b):
    return (a is not None and b is not None and a[0] <= b[2]
            and b[0] <= a[2] and a[1] <= b[3] and b[1] <= a[3])


def mask_iou(rles_a, rles_b, iscrowd=None, native=True):
    """Pairwise IoU ``(len(rles_a), len(rles_b))`` of two lists of COCO RLEs
    (the JAX package's ``mask_iou``: with ``iscrowd[j]`` the union is
    ``a``'s area alone).  Without ``iscrowd`` the mask library merges the
    run lengths of each pair, as JAX's does, unless ``native=False``.  The
    numpy version works from the run lengths too: the intersection of
    ``a`` and ``b`` is, over ``b``'s runs, ``a``'s pixels before each
    run's end less those before its start, and pairs whose bounding boxes
    do not overlap intersect in nothing and are skipped."""
    if native and iscrowd is None:
        return maskops.rle_iou_matrix([_counts(r) for r in rles_a],
                                      [_counts(r) for r in rles_b])
    ra = [_Runs(r) for r in rles_a]
    rb = [_Runs(r) for r in rles_b]
    out = np.zeros((len(ra), len(rb)), np.float64)
    for i, a in enumerate(ra):
        if not a.area:
            continue
        js = [j for j, b in enumerate(rb) if _overlap(a.box, b.box)]
        inter = np.zeros(len(rb), np.int64)
        if js:
            ids = np.concatenate([np.full(len(rb[j].starts), k)
                                  for k, j in enumerate(js)])
            lo = np.concatenate([rb[j].starts for j in js])
            hi = np.concatenate([rb[j].ends for j in js])
            inter[js] = np.bincount(ids, a.covered(hi) - a.covered(lo),
                                    minlength=len(js)).astype(np.int64)
        for j, b in enumerate(rb):
            if iscrowd is not None and iscrowd[j]:
                denom = a.area
            else:
                denom = a.area + b.area - int(inter[j])
            out[i, j] = int(inter[j]) / denom if denom > 0 else 0.0
    return out
