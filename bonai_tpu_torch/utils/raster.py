"""numpy counterparts of the OpenCV drawing and contour calls that the
synthetic BONAI generator and the instance-mask packing make.

- :func:`fill_poly` is ``cv2.fillPoly(img, polys, color)`` (``LINE_8``,
  ``shift=0``) pixel for pixel: each part's outline drawn with the
  8-connected Bresenham line of ``cv2.line`` (clipped to the image as
  OpenCV clips it), then the even-odd scanline fill of all parts' edges
  walked in 16.16 fixed point, every pixel centre inside a span filled.
- :func:`convex_hull` is ``cv2.convexHull`` (monotone chain: the same
  vertices in the same cyclic order).
- :func:`add_weighted` is ``cv2.addWeighted`` on ``uint8``.
- :func:`find_external_contours` is ``cv2.findContours(mask, RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)``: Suzuki–Abe outer border following with OpenCV's
  start pixel and direction, then chain compression; :func:`contour_area`
  is ``cv2.contourArea``.
- :func:`circle_filled_aa` and :func:`thick_line` draw the shapes of
  ``cv2.circle(..., -1, LINE_AA)`` and ``cv2.line(..., thickness)``; they
  agree with OpenCV inside the shapes and differ from it only along their
  edges.

A colour is a number or a sequence of numbers, converted to ``uint8`` as
OpenCV converts a ``Scalar``: rounded half to even and saturated.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _raw_color(img, color):
    """The ``Scalar`` ``color`` as the ``uint8`` value(s) of one pixel of
    ``img``."""
    vals = list(np.ravel(np.asarray(color, np.float64))) + [0.0] * 4
    nch = 1 if img.ndim == 2 else img.shape[2]
    raw = np.clip(np.rint(np.asarray(vals[:nch])), 0, 255).astype(np.uint8)
    return raw[0] if img.ndim == 2 else raw


def _trunc_div(a, b):
    """C integer division (rounds toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(w, h, x1, y1, x2, y2):
    """``cv2.clipLine`` on the ``w`` x ``h`` image: the clipped end points
    (as OpenCV leaves them, even when it returns false) and whether any
    part of the line lies inside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line_pixels(w, h, x0, y0, x1, y1):
    """The pixels ``(xs, ys)`` of ``cv2.line(img, p0, p1, color)`` (one
    pixel wide, ``LINE_8``) on a ``w`` x ``h`` image: OpenCV's
    ``LineIterator`` (clipped, left to right), its Bresenham error term in
    closed form."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
        x0, y0, x1, y1, inside = _clip_line(w, h, x0, y0, x1, y1)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # the minor axis steps m_k times in the first k steps: the k-th update
    # of err = major - 2 minor steps it when err < 0
    m = -((major - 2 * minor * k) // (2 * major)) if major else k * 0
    if dy > dx:
        return x0 + m, y0 + sy * k
    return x0 + k, y0 + sy * m


def _collect_edges(w, h, pts, edges, line_xy):
    """OpenCV's ``CollectPolyEdges`` for ``LINE_8``, ``shift=0``: the
    outline's pixels go to ``line_xy``, the non-horizontal edges (``y0``,
    ``y1``, 16.16 ``x`` at ``y0``, ``dx`` per row) to ``edges``.  An edge
    that leaves the image keeps its rows but takes its slope from the
    clipped line: its x from the clipped ends, its y too unless the clipped
    line is horizontal (then x runs between the clipped ends over the
    original rows; a line clipped to a point gives a vertical edge)."""
    n = len(pts)
    for i in range(n):
        px0, py0 = pts[i - 1]
        px1, py1 = pts[i]
        line_xy.append(_line_pixels(w, h, px0, py0, px1, py1))
        x0f, x1f = px0 << XY_SHIFT, px1 << XY_SHIFT
        y0c, y1c = py0, py1
        if not (0 <= px0 < w and 0 <= px1 < w and 0 <= py0 < h
                and 0 <= py1 < h):
            tx0, ty0, tx1, ty1, _ = _clip_line(w, h, px0, py0, px1, py1)
            x0f, x1f = tx0 << XY_SHIFT, tx1 << XY_SHIFT
            if ty0 != ty1:
                y0c, y1c = ty0, ty1
        if py0 == py1:
            continue
        d = _trunc_div(x1f - x0f, y1c - y0c)
        if py0 < py1:
            edges.append((py0, py1, x0f + (py0 - y0c) * d, d))
        else:
            edges.append((py1, py0, x1f + (py1 - y1c) * d, d))


def _fill_edges(img, edges, raw):
    """OpenCV's ``FillEdgeCollection`` (``LINE_8``): per row, the active
    edges (``y0 <= y < y1``) sorted by x and filled pairwise, from the
    pixel at or right of the left edge to the pixel at or left of the right
    edge, clipped to the image."""
    if len(edges) < 2:
        return
    h, w = img.shape[:2]
    e = np.asarray(edges, np.int64)
    y0, y1, x, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    xe = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x.max(), xe.max()) < 0
            or min(x.min(), xe.min()) >= (w << XY_SHIFT)):
        return
    lo = np.clip(y0, 0, h)
    n = np.clip(y1, 0, h) - lo
    if n.sum() <= 0:
        return
    n = np.maximum(n, 0)
    idx = np.repeat(np.arange(len(e)), n)
    rows = lo[idx] + np.arange(len(idx)) - np.repeat(np.cumsum(n) - n, n)
    xs = x[idx] + (rows - y0[idx]) * dx[idx]
    order = np.lexsort((xs, rows))
    # every row meets an even number of edges of closed parts: the sorted
    # list pairs up as (0, 1), (2, 3), ...
    rows, xs = rows[order][0::2], xs[order]
    xl = np.maximum((xs[0::2] + XY_ONE - 1) >> XY_SHIFT, 0)
    xr = np.minimum(xs[1::2] >> XY_SHIFT, w - 1)
    keep = xl <= xr
    for r, a, b in zip(rows[keep].tolist(), xl[keep].tolist(),
                       (xr[keep] + 1).tolist()):
        img[r, a:b] = raw


def fill_poly(img, polys, color):
    """``cv2.fillPoly(img, polys, color)`` with ``LINE_8`` and ``shift=0``,
    in place: ``polys`` is a list of ``(n, 2)`` integer vertex arrays (x,
    y); the parts are filled together (even-odd) and their outlines drawn.
    Returns ``img``."""
    h, w = img.shape[:2]
    raw = _raw_color(img, color)
    edges, line_xy = [], []
    for p in polys:
        pts = [tuple(q) for q in np.asarray(p, np.int64).reshape(
            -1, 2).tolist()]
        if pts:
            _collect_edges(w, h, pts, edges, line_xy)
    for xs, ys in line_xy:
        img[ys, xs] = raw
    _fill_edges(img, edges, raw)
    return img


def convex_hull(points):
    """``cv2.convexHull(points)`` (``clockwise=False``): the hull's
    vertices of the ``(n, 2)`` points as ``(m, 2)`` float64, collinear
    points dropped, in OpenCV's cyclic order (its first vertex may be
    another; a polygon fill does not depend on it)."""
    p = np.asarray(points, np.float64).reshape(-1, 2)
    order = np.lexsort((p[:, 1], p[:, 0]))
    p = p[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in p[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1] or [p[0]], np.float64)


def add_weighted(a, alpha, b, beta, gamma=0.0):
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` on ``uint8`` arrays:
    float32 arithmetic, rounded half to even and saturated."""
    t = (a.astype(np.float32) * np.float32(alpha)
         + b.astype(np.float32) * np.float32(beta)) + np.float32(gamma)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def circle_filled_aa(img, center, r, color):
    """A filled anti-aliased disc, the shape of ``cv2.circle(img, center,
    r, color, -1, LINE_AA)``: full colour inside, a coverage blend over the
    one-pixel rim.  In place; returns ``img``."""
    h, w = img.shape[:2]
    cx, cy, r = int(center[0]), int(center[1]), int(r)
    raw = _raw_color(img, color).astype(np.float32)
    y0, y1 = max(cy - r - 1, 0), min(cy + r + 2, h)
    x0, x1 = max(cx - r - 1, 0), min(cx + r + 2, w)
    if y0 >= y1 or x0 >= x1:
        return img
    yy, xx = np.mgrid[y0:y1, x0:x1]
    cover = np.clip(r + 0.5 - np.hypot(xx - cx, yy - cy), 0.0, 1.0)
    if img.ndim == 3:
        cover = cover[..., None]
    sub = img[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] = np.clip(np.rint(sub + (raw - sub) * cover), 0, 255)
    return img


def thick_line(img, p0, p1, color, thickness):
    """The shape of ``cv2.line(img, p0, p1, color, thickness)`` (``LINE_8``,
    round caps): every pixel whose centre lies within ``thickness / 2`` of
    the segment.  In place; returns ``img``."""
    h, w = img.shape[:2]
    raw = _raw_color(img, color)
    (ax, ay), (bx, by) = (float(v) for v in p0), (float(v) for v in p1)
    rad = thickness / 2.0
    y0 = max(int(math.floor(min(ay, by) - rad)), 0)
    y1 = min(int(math.ceil(max(ay, by) + rad)) + 1, h)
    x0 = max(int(math.floor(min(ax, bx) - rad)), 0)
    x1 = min(int(math.ceil(max(ax, bx) + rad)) + 1, w)
    if y0 >= y1 or x0 >= x1:
        return img
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    vx, vy = bx - ax, by - ay
    den = vx * vx + vy * vy
    t = np.zeros_like(xx) if den == 0 else np.clip(
        ((xx - ax) * vx + (yy - ay) * vy) / den, 0.0, 1.0)
    inside = np.hypot(xx - ax - t * vx, yy - ay - t * vy) <= rad
    img[y0:y1, x0:x1][inside] = raw
    return img



# --- lines, rectangles and polylines of OpenCV's drawing.cpp ---------------
# (``LINE_8``, ``shift=0``): a line of thickness 1 is ``cv2.line``'s
# Bresenham line; a thicker one is OpenCV's ``ThickLine``: the convex
# quadrilateral of the line's width filled in 16.16 fixed point
# (``FillConvexPoly``, its edges drawn by the fixed-point ``Line2``) and a
# filled circle (``Circle``) at the capped ends.


def _hline(img, y, x1, x2, raw):
    h, w = img.shape[:2]
    if 0 <= y < h and x2 >= 0 and x1 < w:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = raw


def _line2(img, p1, p2, raw):
    """OpenCV's ``Line2``: the line between two 16.16 points."""
    h, w = img.shape[:2]
    x1, y1, x2, y2, inside = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                        *p1, *p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _trunc_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _trunc_div(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = raw
    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(img, v, raw):
    """OpenCV's ``FillConvexPoly`` of 16.16 vertices ``v`` (``LINE_8``):
    the outline by :func:`_line2`, then each row between the two edges
    that walk down from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    xs_ = [p[0] for p in v]
    ys_ = [p[1] for p in v]
    imin = ys_.index(min(ys_))
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, raw)
        p0 = p
    xmin, xmax = (min(xs_) + delta) >> XY_SHIFT, (max(xs_) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys_) + delta) >> XY_SHIFT, (max(ys_) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % npts
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, idx=idx, x=xs, dx=_trunc_div(
                        (xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0 = idx
                idx = (idx + e["di"]) % npts
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            lo, hi = sorted((edge[0]["x"], edge[1]["x"]))
            _hline(img, y, (lo + delta) >> XY_SHIFT, (hi + delta) >> XY_SHIFT,
                   raw)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(img, cx, cy, radius, raw):
    """OpenCV's ``Circle`` with ``fill``: the midpoint circle's spans."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx),
                          (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy),
                          (cy + dx, cx - dy, cx + dy)):
            _hline(img, y, x1, x2, raw)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _thick_line(img, p0, p1, raw, thickness, flags):
    """OpenCV's ``ThickLine`` (``LINE_8``, ``shift=0``) between integer
    points; ``flags`` bit 0 caps ``p0``, bit 1 caps ``p1``."""
    h, w = img.shape[:2]
    if thickness <= 1:
        xs, ys = _line_pixels(w, h, *p0, *p1)
        img[ys, xs] = raw
        return
    a = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    b = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    dx = (a[0] - b[0]) / XY_ONE
    dy = (b[1] - a[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex_poly(img, [(a[0] + ddx, a[1] + ddy),
                                (a[0] - ddx, a[1] - ddy),
                                (b[0] - ddx, b[1] - ddy),
                                (b[0] + ddx, b[1] + ddy)], raw)
    for i, p in enumerate((a, b)):
        if flags & (i + 1):
            _circle_filled(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                           (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                           (t + (XY_ONE >> 1)) >> XY_SHIFT, raw)


def line(img, p0, p1, color, thickness=1):
    """``cv2.line(img, p0, p1, color, thickness)`` (``LINE_8``), in place;
    returns ``img``."""
    _thick_line(img, p0, p1, _raw_color(img, color), int(thickness), 3)
    return img


def polylines(img, pts, is_closed, color, thickness=1):
    """``cv2.polylines(img, pts, is_closed, color, thickness)`` (``LINE_8``)
    for a list of ``(n, 2)`` integer vertex arrays, in place; returns
    ``img``."""
    raw = _raw_color(img, color)
    for p in pts:
        v = [tuple(q) for q in np.asarray(p, np.int64).reshape(-1, 2).tolist()]
        if not v:
            continue
        p0 = v[-1] if is_closed else v[0]
        for q in v[0 if is_closed else 1:]:
            _thick_line(img, p0, q, raw, int(thickness),
                        2 if is_closed else 3)
            p0 = q
    return img


def rectangle(img, pt1, pt2, color, thickness=1):
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` (``LINE_8``,
    ``thickness >= 0``), in place; returns ``img``."""
    (x1, y1), (x2, y2) = pt1, pt2
    return polylines(img, [np.array([(x1, y1), (x2, y1), (x2, y2),
                                     (x1, y2)])], True, color, thickness)


def arrowed_line(img, pt1, pt2, color, thickness=1, tip_length=0.1):
    """``cv2.arrowedLine(img, pt1, pt2, color, thickness)`` (``LINE_8``):
    the line and two tip strokes of ``tip_length`` of its length at 45
    degrees, in place; returns ``img``."""
    (x1, y1), (x2, y2) = (tuple(int(v) for v in p) for p in (pt1, pt2))
    tip = math.hypot(x1 - x2, y1 - y2) * tip_length
    line(img, (x1, y1), (x2, y2), color, thickness)
    angle = math.atan2(y1 - y2, x1 - x2)
    for sign in (1, -1):
        p = (round(x2 + tip * math.cos(angle + sign * math.pi / 4)),
             round(y2 + tip * math.sin(angle + sign * math.pi / 4)))
        line(img, p, (x2, y2), color, thickness)
    return img

# --- contours ---------------------------------------------------------------

# OpenCV's chain codes: 0 right, then counter-clockwise on the screen
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_NBD = 2                   # OpenCV's label of a followed border pixel
_RIGHT = 2 - 128           # ... and of one whose right neighbour is 0


def _follow(img, y, x):
    """OpenCV's ``icvFetchContour`` for the outer border starting at
    ``(y, x)`` of the padded ``int8`` label image, ``CHAIN_APPROX_SIMPLE``:
    marks the border and returns its points (padded coordinates)."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        y1, x1 = y + _CODE_DY[s], x + _CODE_DX[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end and img[y1, x1] == 0:        # a single pixel
        img[y, x] = _RIGHT
        return [(x, y)]
    pts = []
    py, px = y, x
    y3, x3 = y, x
    prev_s = s ^ 4
    while True:
        s_end = s
        s = min(s, 15)
        while s < 15:
            s += 1
            y4, x4 = y3 + _CODE_DY[s & 7], x3 + _CODE_DX[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 0 < s <= s_end:
            img[y3, x3] = _RIGHT
        elif img[y3, x3] == 1:
            img[y3, x3] = _NBD
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        px += _CODE_DX[s]
        py += _CODE_DY[s]
        if (y4, x4) == (y, x) and (y3, x3) == (y1, x1):
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_external_contours(mask):
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``:
    the outer border of every component (8-connected) that lies in no
    other, in OpenCV's order and with its start point and direction, each
    as an ``(n, 2)`` int32 array of (x, y) corner points."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    contours = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd = 1, 0, 0
        while x < w + 1:
            nz = np.flatnonzero(row[x:w + 1] != prev)
            if not len(nz):
                break
            x += int(nz[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:
                contours.append(_follow(img, y, x))
                p = int(row[x])
            prev = p
            if prev & -2:
                lnbd = x
            x += 1
    return [np.asarray(pts, np.int32).reshape(-1, 2) - 1
            for pts in contours[::-1]]


def contour_area(contour):
    """``cv2.contourArea(contour)``: the absolute shoelace area."""
    c = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))) / 2
