"""Affine warps and the minimum-area rectangle in numpy, as OpenCV 5.0
computes them, for ``RandomRotate`` and ``Pointobb2RBBox`` without cv2.

- :func:`rotation_matrix_2d` is ``cv2.getRotationMatrix2D`` and
  :func:`invert_affine` ``cv2.invertAffineTransform``, both in float64.
- :func:`warp_affine` is ``cv2.warpAffine`` with a zero constant border.
  OpenCV 5.0 takes one of two arithmetic paths by the number of channels.
  For 1, 3 or 4 channels it maps each destination pixel through the
  inverse matrix in float32: the row's part ``m1 * y + m2`` with two
  roundings, then ``m0 * x`` added in one fused multiply-add.
  ``'nearest'`` rounds that source point to the nearest integer (half to
  even).  ``'linear'`` (uint8 only) blends the four neighbours by the
  fractions ``a`` and ``b``: ``fma(a, p01 - p00, p00)`` along each row,
  then ``fma(b, v1 - v0, v0)``, rounded half to even.  OpenCV computes a
  row in vector blocks of 16 pixels and its last ``width mod 16`` pixels
  in scalar code, which rounds otherwise: there the linear warp can differ
  by one level (a few pixels in a thousand warps; BONAI's 1024-pixel rows
  have no such tail).  A float32 single-channel image takes the same
  blend without the final rounding; there the scalar tail's source point
  is ``fma(m0, x, m1 * y) + m2``, which this module reproduces, so that
  path is exact at every width.  Any other number of channels takes the
  fixed-point path, with ``'nearest'`` only: the float64 coordinates
  times 1024 rounded to integers, plus 512, shifted right by 10.
- :func:`convex_hull` is ``cv2.convexHull`` of integer points (Sklansky's
  scan, with OpenCV's cyclic shift of the output), and
  :func:`min_area_rect` is ``cv2.minAreaRect``: the rotating calipers in
  float32 over the counter-clockwise hull, returning the centre, ``(w,
  h)`` and the angle in degrees, brought into ``[-90, 0)`` by quarter
  turns that swap ``w`` and ``h``.  Where several edges give boxes of the
  same area (every triangular hull does), float rounding picks one; on
  one random integer quad in about 4500 OpenCV 5.0 picks another of the
  equal boxes than these calipers.

``tests/test_torch_port_rotate.py`` holds every path to cv2.
"""

from __future__ import annotations

import math

import numpy as np

_AB_BITS = 10                    # the fixed-point path's coordinate bits


def rotation_matrix_2d(center, angle):
    """The ``(2, 3)`` float64 matrix that rotates by ``angle`` degrees
    (counter-clockwise on the screen) about ``center = (x, y)``, at scale
    1."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m):
    """The inverse of a ``(2, 3)`` affine matrix, in OpenCV's order of
    operations (a singular matrix inverts to zeros)."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.reshape(2, 3)


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, and the float64 sum rounds to float32 as
    the exact sum does unless it falls on a midpoint of float32 neighbours
    (its low 29 mantissa bits ``1 << 28``; below float32's normal range
    every nonzero sum is checked): there its rounding error decides the
    side."""
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    p = a.astype(np.float64) * b
    s = np.asarray(p + c)
    r = s.astype(np.float32)
    cand = ((s.view(np.int64) & 0x1FFFFFFF) == 0x10000000) | (
        (np.abs(s) < 2.0 ** -125) & (s != 0))
    if not cand.any():
        return r
    p, c, s = (np.broadcast_to(v, s.shape)[cand]
               for v in (p, c.astype(np.float64), s))
    bb = s - p
    err = (p - (s - bb)) + (c - bb)            # s + err == p + c exactly
    rc = s.astype(np.float32)
    r64 = rc.astype(np.float64)
    lo = np.nextafter(rc, np.float32(-np.inf)).astype(np.float64)
    hi = np.nextafter(rc, np.float32(np.inf)).astype(np.float64)
    rc = np.where((s == (r64 + lo) * 0.5) & (err < 0), lo, rc)
    rc = np.where((s == (r64 + hi) * 0.5) & (err > 0), hi, rc)
    r[cand] = rc
    return r


def _gather(src, xs, ys):
    """``src[ys, xs]`` with zeros outside the image."""
    h, w = src.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = src[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    out[~inside] = 0
    return out


def _source_points(inv, w, h):
    """Each destination pixel's source point in float32, as OpenCV 5.0's
    vector path computes it."""
    m = inv.reshape(6).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None]
    ys = np.arange(h, dtype=np.float32)[:, None]
    row_x = m[1] * ys + m[2]
    row_y = m[4] * ys + m[5]
    shape = (h, w)
    return (fma32(np.broadcast_to(m[0], shape), np.broadcast_to(xs, shape),
                  np.broadcast_to(row_x, shape)),
            fma32(np.broadcast_to(m[3], shape), np.broadcast_to(xs, shape),
                  np.broadcast_to(row_y, shape)))


def _fixed_point_nearest(src, inv, w, h):
    """OpenCV's fixed-point nearest-neighbour path."""
    scale = 1 << _AB_BITS
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    half = scale // 2
    x0 = np.rint((inv[0, 1] * ys + inv[0, 2]) * scale).astype(np.int64) + half
    y0 = np.rint((inv[1, 1] * ys + inv[1, 2]) * scale).astype(np.int64) + half
    dx = np.rint(inv[0, 0] * xs * scale).astype(np.int64)
    dy = np.rint(inv[1, 0] * xs * scale).astype(np.int64)
    return _gather(src, (x0[:, None] + dx[None]) >> _AB_BITS,
                   (y0[:, None] + dy[None]) >> _AB_BITS)


def _tail_source_points(inv, w, h, sx, sy):
    """``sx, sy`` with the row's last ``w mod 16`` pixels replaced by the
    scalar path's source points, ``fma(m0, x, m1 * y) + m2``."""
    m = inv.reshape(6).astype(np.float32)
    shape = (h, w)
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None], shape)
    ys = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], shape)
    tail = np.arange(w)[None] >= w - w % 16
    out = []
    for r, v in ((0, sx), (1, sy)):
        t = fma32(np.broadcast_to(m[3 * r], shape), xs,
                  m[3 * r + 1] * ys) + m[3 * r + 2]
        out.append(np.where(tail, t, v))
    return out


def warp_affine(src, m, dsize, interpolation="linear"):
    """``cv2.warpAffine(src, m, dsize, flags=INTER_LINEAR|INTER_NEAREST)``
    with a zero constant border: ``src`` ``(H, W)`` or ``(H, W, C)``,
    ``m`` the ``(2, 3)`` forward matrix, ``dsize = (w, h)``.  ``'linear'``
    takes uint8 images of 1, 3 or 4 channels and float32 images of one."""
    w, h = (int(v) for v in dsize)
    inv = invert_affine(m)
    channels = 1 if src.ndim == 2 else src.shape[2]
    if interpolation == "nearest":
        if channels not in (1, 3, 4):
            return _fixed_point_nearest(src, inv, w, h)
        sx, sy = _source_points(inv, w, h)
        return _gather(src, np.rint(sx).astype(np.int64),
                       np.rint(sy).astype(np.int64))
    if interpolation != "linear":
        raise ValueError(f"interpolation {interpolation!r}")
    is_f32 = src.dtype == np.float32 and src.ndim == 2
    if not is_f32 and (src.dtype != np.uint8 or channels not in (1, 3, 4)):
        raise ValueError(f"the linear warp takes uint8 images of 1, 3 or 4 "
                         f"channels or float32 images of one, not "
                         f"{src.dtype} with {channels}")
    sx, sy = _source_points(inv, w, h)
    if is_f32:
        sx, sy = _tail_source_points(inv, w, h, sx, sy)
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    img = src.astype(np.float32)
    p00, p01 = _gather(img, ix, iy), _gather(img, ix + 1, iy)
    p10, p11 = _gather(img, ix, iy + 1), _gather(img, ix + 1, iy + 1)
    a = np.broadcast_to(a, p00.shape)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    v = fma32(np.broadcast_to(b, p00.shape), v1 - v0, v0)
    if is_f32:
        return v
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# convex hull and minimum-area rectangle
# ---------------------------------------------------------------------------

def _sign(v):
    return (v > 0) - (v < 0)


def _sklansky(pts, start, end, nsign, sign2):
    """OpenCV's ``Sklansky_`` over the x-sorted points ``pts`` from
    ``start`` to ``end``: the stack of indices of one quarter hull."""
    incr = 1 if end > start else -1
    if start == end or pts[start] == pts[end]:
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points):
    """``cv2.convexHull(points)`` (counter-clockwise in OpenCV's sense) of
    ``(N, 2)`` integer points: the hull's indices into ``points``, in
    OpenCV's order."""
    pts = [(int(x), int(y)) for x, y in np.asarray(points).reshape(-1, 2)]
    order = sorted(range(len(pts)), key=lambda i: (pts[i][0], pts[i][1], i))
    s = [pts[i] for i in order]
    n = len(s)
    miny = maxy = 0
    for i in range(1, n):
        if s[miny][1] > s[i][1]:
            miny = i
        if s[maxy][1] < s[i][1]:
            maxy = i
    if s[0] == s[n - 1]:
        return [order[0]]
    tl = _sklansky(s, 0, maxy, -1, 1)
    tr = _sklansky(s, n - 1, maxy, -1, -1)
    tl, tr = tr, tl
    hull = [order[i] for i in tl[:-1]] + [order[tr[i]]
                                          for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(s, 0, miny, 1, -1)
    br = _sklansky(s, n - 1, miny, 1, 1)
    if stop >= 0:
        check = bl[1] if len(bl) > 2 else \
            br[2 - len(bl)] if len(bl) + len(br) > 2 else -1
        if check == stop or (check >= 0 and s[check] == s[stop]):
            # collinear points: the lower half mirrors the upper
            bl, br = bl[:2], br[:2]
    hull += [order[i] for i in bl[:-1]] + [order[br[i]]
                                           for i in range(len(br) - 1, 0, -1)]
    return _cyclic_shift(hull)


def _cyclic_shift(hull):
    """OpenCV's shift of the hull indices into an ascending or descending
    sequence, where a cyclic shift makes one."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = j = min_idx if ascending else max_idx
        if i0 > 0:
            out = []
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    break
                j = nj
            else:
                return out
    return hull


def _rotating_calipers(p):
    """OpenCV's ``rotatingCalipers`` in its minimum-area mode over the
    float32 hull ``p`` ``(n, 2)``: a corner and the two side vectors."""
    f = np.float32
    n = len(p)
    vect = np.zeros((n, 2), f)
    inv_len = np.zeros(n, f)
    left = bottom = right = top = 0
    left_x = right_x = p[0, 0]
    top_y = bottom_y = p[0, 1]
    pt0 = p[0]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = p[(i + 1) % n]
        dx = float(pt[0]) - float(pt0[0])
        dy = float(pt[1]) - float(pt0[1])
        vect[i] = (dx, dy)
        inv_len[i] = 1.0 / math.sqrt(dx * dx + dy * dy)
        pt0 = pt
    orientation = f(0)
    ax, ay = float(vect[n - 1, 0]), float(vect[n - 1, 1])
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = f(1) if convexity > 0 else f(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("the hull is degenerate")
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    minarea = f(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0], 0] + base_b * vect[seq[0], 1],
              -base_b * vect[seq[1], 0] + base_a * vect[seq[1], 1],
              -base_a * vect[seq[2], 0] - base_b * vect[seq[2], 1],
              base_b * vect[seq[3], 0] - base_a * vect[seq[3], 1])
        main = 0
        maxcos = dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            cosalpha = dp[i] * inv_len[seq[i]]
            if cosalpha > maxcos:
                main, maxcos = i, cosalpha
        pi = seq[main]
        lead_x = vect[pi, 0] * inv_len[pi]
        lead_y = vect[pi, 1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = p[seq[1], 0] - p[seq[3], 0]
        dy = p[seq[1], 1] - p[seq[3], 1]
        width = dx * base_a + dy * base_b
        dx = p[seq[2], 0] - p[seq[0], 0]
        dy = p[seq[2], 1] - p[seq[0], 1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    left_i, a1, width, b1, height, bottom_i = best
    a2, b2 = -b1, a1
    c1 = a1 * p[left_i, 0] + p[left_i, 1] * b1
    c2 = a2 * p[bottom_i, 0] + p[bottom_i, 1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (np.array([px, py], f), np.array([a1 * width, b1 * width], f),
            np.array([a2 * height, b2 * height], f))


def min_area_rect(points):
    """``cv2.minAreaRect`` of ``(N, 2)`` integer points: ``((cx, cy), (w,
    h), angle)`` as Python floats (float32 values), the angle in degrees
    in ``[-90, 0)``."""
    pts = np.asarray(points).reshape(-1, 2)
    hull = pts[convex_hull(pts)].astype(np.float32)
    f = np.float32
    n = len(hull)
    if n > 2:
        corner, side_w, side_h = _rotating_calipers(hull)
        center = corner + (side_w + side_h) * f(0.5)
        w = f(math.sqrt(float(side_w[0]) ** 2 + float(side_w[1]) ** 2))
        h = f(math.sqrt(float(side_h[0]) ** 2 + float(side_h[1]) ** 2))
        angle = f(math.atan2(float(side_w[1]), float(side_w[0])))
    elif n == 2:
        center = (hull[0] + hull[1]) * f(0.5)
        dx = float(hull[1, 0]) - float(hull[0, 0])
        dy = float(hull[1, 1]) - float(hull[0, 1])
        w, h = f(math.sqrt(dx * dx + dy * dy)), f(0)
        angle = f(math.atan2(dy, dx))
    else:
        center = hull[0] if n else np.zeros(2, f)
        w = h = angle = f(0)
    angle = f(float(angle * f(180)) / math.pi)
    while angle >= 0:                   # OpenCV 5.0's range, [-90, 0)
        angle, w, h = angle - f(90), h, w
    while angle < -90:
        angle, w, h = angle + f(90), h, w
    return ((float(center[0]), float(center[1])), (float(w), float(h)),
            float(angle))
