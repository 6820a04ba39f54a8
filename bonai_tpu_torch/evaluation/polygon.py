"""Exact polygon geometry for the BONAI evaluator (counterpart of
``bonai_tpu/evaluation/polygon.py``, the same float operations in the same
order, so that TP/FP decisions at the IoU threshold come out the same).

The reference computes polygon IoU with shapely/geopandas geometric overlay
(``tools/bonai/bonai_evaluation.py:403-501``).  This module implements the
needed slice exactly, in numpy:

  intersection area of two simple polygons
    = sum over triangle pairs of |T_a ∩ T_b|,
  with each polygon triangulated by ear clipping (exact for simple
  polygons — the two-ears theorem) and each triangle pair clipped by
  Sutherland–Hodgman (exact for convex∩convex).

This is exact up to float rounding — no pixel quantisation — so TP/FP
decisions near the 0.5 IoU threshold are stable.  The raster path is kept
in ``bonai_eval`` as the fallback for polygons that cannot be triangulated.

The ear test checks all remaining vertices in one numpy expression
(``_any_in_tri``) where the JAX package loops over them: the same
operations per vertex, so the same ears, without the loop's cubic cost on
traced contours of hundreds of vertices.
"""

from __future__ import annotations

import numpy as np


def polygon_area(poly):
    """Absolute shoelace area of an (N, 2) polygon."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _signed_area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _dedupe(poly, eps=1e-9):
    """Drop consecutive (near-)duplicate vertices, including wraparound."""
    if len(poly) == 0:
        return poly
    keep = [0]
    for i in range(1, len(poly)):
        if not np.allclose(poly[i], poly[keep[-1]], atol=eps):
            keep.append(i)
    while len(keep) > 1 and np.allclose(poly[keep[-1]], poly[keep[0]],
                                        atol=eps):
        keep.pop()
    return poly[keep]


def _any_in_tri(pts, a, b, c, eps):
    """Any of the ``(n, 2)`` points ``pts`` inside-or-on CCW triangle abc.
    Boundary counts: a reflex vertex lying exactly on the candidate ear's
    diagonal must block the ear, or clipping it leaves a self-touching
    remainder (e.g. an L-shape whose notch tip sits on the corner-to-corner
    diagonal).  The JAX package tests one point at a time; these are the
    same float64 operations per point, so the same points are inside."""
    px, py = pts[:, 0], pts[:, 1]
    d1 = (b[0] - a[0]) * (py - a[1]) - (b[1] - a[1]) * (px - a[0])
    d2 = (c[0] - b[0]) * (py - b[1]) - (c[1] - b[1]) * (px - b[0])
    d3 = (a[0] - c[0]) * (py - c[1]) - (a[1] - c[1]) * (px - c[0])
    return bool(np.any((d1 >= -eps) & (d2 >= -eps) & (d3 >= -eps)))


def triangulate(poly):
    """Ear-clip a simple polygon into triangles.

    Returns an (T, 3, 2) float64 array, or ``None`` if the polygon is
    degenerate / not simple enough to ear-clip (caller should fall back to
    the raster path).
    """
    poly = _dedupe(np.asarray(poly, np.float64))
    if len(poly) < 3:
        return None
    if _signed_area(poly) < 0:
        poly = poly[::-1]
    # scale-aware epsilon for the strictly-inside test
    span = max(poly.max() - poly.min(), 1.0)
    eps = 1e-12 * span * span
    idx = list(range(len(poly)))
    tris = []
    guard = 0
    while len(idx) > 3:
        n = len(idx)
        pts = poly[idx]
        clipped = False
        for k in range(n):
            i0, i1, i2 = idx[(k - 1) % n], idx[k], idx[(k + 1) % n]
            a, b, c = poly[i0], poly[i1], poly[i2]
            cross = (b[0] - a[0]) * (c[1] - a[1]) \
                - (b[1] - a[1]) * (c[0] - a[0])
            if cross <= eps:
                continue  # reflex or collinear — not an ear tip
            # no other vertex inside the candidate ear
            others = np.ones(n, bool)
            others[[(k - 1) % n, k, (k + 1) % n]] = False
            ok = not _any_in_tri(pts[others], a, b, c, eps)
            if ok:
                tris.append((a, b, c))
                idx.pop(k)
                clipped = True
                break
        if not clipped:
            # numerically degenerate remainder: drop a collinear vertex
            # (zero-area ear) if one exists, else give up
            for k in range(n):
                i0, i1, i2 = idx[(k - 1) % n], idx[k], idx[(k + 1) % n]
                a, b, c = poly[i0], poly[i1], poly[i2]
                cross = (b[0] - a[0]) * (c[1] - a[1]) \
                    - (b[1] - a[1]) * (c[0] - a[0])
                if abs(cross) <= eps:
                    idx.pop(k)
                    clipped = True
                    break
            if not clipped:
                return None
        guard += 1
        if guard > 10000:
            return None
    a, b, c = poly[idx[0]], poly[idx[1]], poly[idx[2]]
    tris.append((a, b, c))
    return np.asarray(tris, np.float64)


def _clip_convex(subject, cx0, cy0, cx1, cy1):
    """Sutherland–Hodgman: clip a convex polygon (list of xy) by the
    half-plane left of the directed edge (cx0,cy0)->(cx1,cy1)."""
    ex, ey = cx1 - cx0, cy1 - cy0
    out = []
    n = len(subject)
    for i in range(n):
        px, py = subject[i]
        qx, qy = subject[(i + 1) % n]
        dp = ex * (py - cy0) - ey * (px - cx0)
        dq = ex * (qy - cy0) - ey * (qx - cx0)
        if dp >= 0:
            out.append((px, py))
            if dq < 0:
                t = dp / (dp - dq)
                out.append((px + t * (qx - px), py + t * (qy - py)))
        elif dq >= 0:
            t = dp / (dp - dq)
            out.append((px + t * (qx - px), py + t * (qy - py)))
    return out


def _tri_pair_area(ta, tb):
    """|T_a ∩ T_b| for CCW triangles (3, 2)."""
    subject = [(ta[0, 0], ta[0, 1]), (ta[1, 0], ta[1, 1]),
               (ta[2, 0], ta[2, 1])]
    for i in range(3):
        x0, y0 = tb[i]
        x1, y1 = tb[(i + 1) % 3]
        subject = _clip_convex(subject, x0, y0, x1, y1)
        if len(subject) < 3:
            return 0.0
    area = 0.0
    n = len(subject)
    for i in range(n):
        x0, y0 = subject[i]
        x1, y1 = subject[(i + 1) % n]
        area += x0 * y1 - x1 * y0
    return 0.5 * abs(area)


class PreparedPolygon:
    """Cache triangulation + bbox for repeated IoU queries (the F1 stage
    IoUs every prediction against every ground truth in the image)."""

    __slots__ = ("poly", "area", "tris", "bbox", "tri_bboxes")

    def __init__(self, poly):
        self.poly = np.asarray(poly, np.float64)
        self.area = polygon_area(self.poly)
        self.tris = triangulate(self.poly)
        self.bbox = np.concatenate([self.poly.min(0), self.poly.max(0)])
        if self.tris is not None:
            self.tri_bboxes = np.concatenate(
                [self.tris.min(1), self.tris.max(1)], axis=1)  # (T, 4)
        else:
            self.tri_bboxes = None


def intersection_area(pa: PreparedPolygon, pb: PreparedPolygon):
    """Exact |A ∩ B| for prepared simple polygons; None on triangulation
    failure (caller falls back to raster)."""
    if pa.tris is None or pb.tris is None:
        return None
    if (pa.bbox[2] <= pb.bbox[0] or pb.bbox[2] <= pa.bbox[0]
            or pa.bbox[3] <= pb.bbox[1] or pb.bbox[3] <= pa.bbox[1]):
        return 0.0
    ba, bb = pa.tri_bboxes, pb.tri_bboxes
    # (Ta, Tb) bbox-overlap prefilter, vectorised
    ov = ((ba[:, None, 2] > bb[None, :, 0])
          & (bb[None, :, 2] > ba[:, None, 0])
          & (ba[:, None, 3] > bb[None, :, 1])
          & (bb[None, :, 3] > ba[:, None, 1]))
    pairs = np.argwhere(ov)
    total = 0.0
    for i, j in pairs:
        total += _tri_pair_area(pa.tris[i], pb.tris[j])
    return total


def poly_iou_exact(pa, pb):
    """Plain exact IoU of two simple polygons (no regulariser); None if
    either polygon cannot be triangulated."""
    A = pa if isinstance(pa, PreparedPolygon) else PreparedPolygon(pa)
    B = pb if isinstance(pb, PreparedPolygon) else PreparedPolygon(pb)
    inter = intersection_area(A, B)
    if inter is None:
        return None
    union = A.area + B.area - inter
    return inter / union if union > 0 else 0.0
