"""bonai_tpu_torch's cv2-free drawing, contour and PNG helpers against cv2,
and the port's synthetic BONAI generator against the cv2 tool
``tools/make_synthetic_bonai.py``.

Exact: ``fill_poly`` (pixel for pixel, masks and colour images, on rotated
quads, L/T part pairs, parts far off the canvas and degenerate polygons),
``convex_hull`` (cv2's vertices in cv2's cyclic order), ``add_weighted``,
``find_external_contours`` (cv2's point lists, start point and order) and
``contour_area``, PNG round trips both ways (cv2's files use all five row
filters), and the generator's json (every value, the L/T outlines
included) and its images once cv2's anti-aliased circle and thick line are
drawn in place of the port's.

Not exact: ``circle_filled_aa`` and ``thick_line`` differ from cv2 only
within 2 px of the shape's edge; measured mean absolute differences over
these tests' images (uint8 levels per channel) are below, and each is held
to twice its measured value.  The generator's images differ from the cv2
tool's by those two shapes alone.
"""

import importlib.util
import json
import math
import os.path as osp
import struct
import zlib

import cv2
import numpy as np
import pytest

from bonai_tpu_torch.utils import raster
from bonai_tpu_torch.utils.png import read_png, write_png
from torch_port_common import ROOT

# mean absolute differences measured on the seeded cases of this file, in
# uint8 levels per pixel and channel: 0.180 (circles) and 0.159 (roads) on
# 256^2 images, 0.205 (tiles) and 0.292 (a scene and its crops)
CIRCLE_MEAN_DIFF = 0.18
LINE_MEAN_DIFF = 0.16
TILE_MEAN_DIFF = 0.29


def _rot(pts, a, c):
    rm = np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
    return np.asarray(pts, np.float64) @ rm.T + c


def _quad(r, lo, hi):
    w, h = np.exp(r.normal(3.3, 0.55, 2))
    base = [(-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2)]
    return _rot(base, r.uniform(0, math.pi), r.uniform(lo, hi, 2))


def _lt_pair(r, lo, hi):
    w, h = np.exp(r.normal(3.3, 0.55, 2))
    w2, h2 = w * r.uniform(0.4, 0.7), h * r.uniform(0.4, 0.7)
    dx = (w - w2) / 2 * (1 if r.rand() < 0.5 else -1)
    a = [(-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, -h / 2 + h2),
         (-w / 2, -h / 2 + h2)]
    b = [(dx - w2 / 2, -h / 2 + h2), (dx + w2 / 2, -h / 2 + h2),
         (dx + w2 / 2, h / 2), (dx - w2 / 2, h / 2)]
    ang, c = r.uniform(0, math.pi), r.uniform(lo, hi, 2)
    return [_rot(a, ang, c), _rot(b, ang, c)]


def _polygons(kind, r, size):
    """One case of ``kind``: a list of int32 parts."""
    if kind == "rotated_quad":
        parts = [_quad(r, 0, size)]
    elif kind == "lt_pair":
        parts = _lt_pair(r, 0, size)
    elif kind == "off_canvas":
        span = r.choice([10, 100, 2000])
        parts = ([_quad(r, -40, size + 40)] if r.rand() < 0.5
                 else [r.uniform(-span, size + span, (r.randint(3, 7), 2))
                       for _ in range(r.randint(1, 3))])
    elif kind == "degenerate":
        c = r.uniform(0, size, 2)
        parts = [[c], [c, c + r.uniform(-20, 20, 2)],
                 [c, c, c + r.uniform(-9, 9, 2)],
                 [c, c + (7, 3), c + (14, 6), c + (21, 9)]][r.randint(4):]
        parts = parts[:r.randint(1, 3)]
    else:                         # a mask packed in a 112^2 box-local grid
        q = _quad(r, 0, 1024)
        lo, hi = q.min(0), q.max(0)
        parts = [(q - lo) / (hi - lo) * 112]
    return [np.round(p).astype(np.int32).reshape(-1, 2) for p in parts]


@pytest.mark.parametrize("kind", ["rotated_quad", "lt_pair", "off_canvas",
                                  "degenerate", "packed_mask"])
def test_fill_poly_equals_cv2(kind):
    """60 polygons of each kind (300 in all), each into a 2-D mask and a
    colour image with a float colour."""
    r = np.random.RandomState(["rotated_quad", "lt_pair", "off_canvas",
                               "degenerate", "packed_mask"].index(kind))
    for i in range(60):
        size = 112 if kind == "packed_mask" else int(r.choice([32, 128]))
        polys = _polygons(kind, r, size)
        mask_cv, mask = (np.zeros((size, size), np.uint8) for _ in range(2))
        cv2.fillPoly(mask_cv, polys, 1)
        raster.fill_poly(mask, polys, 1)
        np.testing.assert_array_equal(mask, mask_cv, err_msg=str(polys))
        img = r.randint(0, 256, (size, size, 3)).astype(np.uint8)
        color = tuple(r.uniform(-10, 270, 3))
        img_cv = img.copy()
        cv2.fillPoly(img_cv, polys, color)
        np.testing.assert_array_equal(raster.fill_poly(img, polys, color),
                                      img_cv, err_msg=str(polys))


def test_convex_hull_equals_cv2():
    r = np.random.RandomState(0)
    for i in range(200):
        pts = r.uniform(-20, 300, (8, 2)).astype(np.float32)
        if i % 2:
            pts = np.round(pts / 16) * 16            # ties and collinear runs
        ref = cv2.convexHull(pts)[:, 0, :].tolist()
        got = raster.convex_hull(pts).astype(np.float32).tolist()
        assert any(ref == got[k:] + got[:k] for k in range(len(got))), (ref,
                                                                         got)


def test_add_weighted_equals_cv2():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = np.ascontiguousarray(a.T)
    for alpha, beta, gamma in ((0.4, 0.6, 0.0), (0.3, 0.5, 7.5)):
        np.testing.assert_array_equal(
            raster.add_weighted(a, alpha, b, beta, gamma),
            cv2.addWeighted(a, alpha, b, beta, gamma))


def _shape_diff(ref, got, dist_to_edge):
    """Mean absolute difference, and the largest distance from the shape's
    edge of a pixel that differs."""
    diff = np.abs(ref.astype(np.int32) - got).max(2)
    ys, xs = np.nonzero(diff)
    far = float(dist_to_edge(xs, ys).max()) if len(ys) else 0.0
    return float(np.abs(ref.astype(np.int32) - got).mean()), far


@pytest.mark.parametrize("shape", ["circle", "line"])
def test_antialiased_shapes_differ_only_at_edges(shape):
    r = np.random.RandomState(1)
    means = []
    for _ in range(30):
        img = r.randint(0, 256, (256, 256, 3)).astype(np.uint8)
        ref, got = img.copy(), img.copy()
        if shape == "circle":
            c, rad = r.randint(0, 256, 2), int(r.randint(5, 150))
            col = r.uniform(40, 130, 3)
            cv2.circle(ref, (int(c[0]), int(c[1])), rad, col, -1,
                       lineType=cv2.LINE_AA)
            raster.circle_filled_aa(got, c, rad, col)

            def dist(xs, ys):
                return np.abs(np.hypot(xs - c[0], ys - c[1]) - rad)
        else:
            p0, p1 = r.randint(0, 256, 2), r.randint(0, 256, 2)
            t = int(r.randint(8, 22))
            cv2.line(ref, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
                     (150, 150, 150), t)
            raster.thick_line(got, p0, p1, (150, 150, 150), t)

            def dist(xs, ys):
                v = p1 - p0
                tt = np.clip(((xs - p0[0]) * v[0] + (ys - p0[1]) * v[1])
                             / max(float(v @ v), 1e-9), 0, 1)
                return np.abs(np.hypot(xs - p0[0] - tt * v[0],
                                       ys - p0[1] - tt * v[1]) - t / 2)
        mean, far = _shape_diff(ref, got, dist)
        assert far <= 2.0, (shape, far)
        means.append(mean)
    limit = CIRCLE_MEAN_DIFF if shape == "circle" else LINE_MEAN_DIFF
    assert np.mean(means) <= 2 * limit, np.mean(means)


def _rect_unions(r):
    h, w = r.randint(5, 60, 2)
    m = np.zeros((h, w), np.uint8)
    for _ in range(r.randint(1, 4)):
        x0, y0 = r.randint(-3, w), r.randint(-3, h)
        m[max(y0, 0):y0 + r.randint(1, 20), max(x0, 0):x0 + r.randint(1, 20)] = 1
    if r.rand() < 0.5:                 # rotated parts, as the generator's
        for p in _lt_pair(r, 0, max(h, w)):
            cv2.fillPoly(m, [np.round(p / 2).astype(np.int32)], 1)
    return m


def test_find_external_contours_equals_cv2():
    """cv2's point lists exactly (start point, direction, corner points,
    contour order) on 300 seeded unions of rectangles and rotated L/T
    parts; and ``contour_area`` is ``cv2.contourArea``."""
    r = np.random.RandomState(2)
    for _ in range(300):
        m = _rect_unions(r)
        ref, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                  cv2.CHAIN_APPROX_SIMPLE)
        got = raster.find_external_contours(m)
        assert [c[:, 0, :].tolist() for c in ref] == [c.tolist() for c in got]
        for c in got:
            assert raster.contour_area(c) == cv2.contourArea(c)


def _filters(path):
    """The row filter types of an 8-bit PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, _, ct = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[ct]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


def test_png_round_trips(tmp_path):
    """``write_png`` -> ``cv2.imread`` and ``cv2.imwrite`` -> ``read_png``
    are exact, for BGR, gray and BGRA images; cv2's files at its
    compression levels and strategies use all five row filters."""
    r = np.random.RandomState(3)
    seen = set()
    for i, (h, w) in enumerate([(1, 1), (7, 13), (64, 48), (96, 128)]):
        img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i >= 2:           # smooth along x, then y: cv2 filters them
            img = np.cumsum(r.randint(0, 3, (h, w, 3)), 3 - i).astype(
                np.uint8)
        path = str(tmp_path / "a.png")
        write_png(path, img)
        assert _filters(path) == {0}
        np.testing.assert_array_equal(cv2.imread(path), img)
        write_png(path, img[..., 0])
        np.testing.assert_array_equal(cv2.imread(path), cv2.cvtColor(
            img[..., 0], cv2.COLOR_GRAY2BGR))
        for level in (0, 1, 3, 9):
            for strategy in range(5):
                cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                        cv2.IMWRITE_PNG_STRATEGY, strategy])
                seen |= _filters(path)
                np.testing.assert_array_equal(read_png(path), img)
        for other in (img[..., 0], np.concatenate(
                [img, r.randint(0, 256, (h, w, 1)).astype(np.uint8)], 2)):
            cv2.imwrite(path, other)
            np.testing.assert_array_equal(read_png(path), cv2.imread(path))
    assert seen == {0, 1, 2, 3, 4}, seen


def test_png_other_formats_raise(tmp_path):
    """A palette PNG and a JPEG raise naming A3c.  16-bit PNGs are read
    since the dataset slice (``test_torch_port_jpeg.py`` holds them to
    cv2), and ``LoadImageFromFile`` reads JPEGs through ``utils/jpeg.py``."""
    import struct
    import zlib
    cv2.imwrite(str(tmp_path / "a16.png"), np.zeros((4, 4, 3), np.uint16))
    assert read_png(str(tmp_path / "a16.png"), unchanged=True).dtype == \
        np.uint16

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    palette = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0))
               + chunk(b"PLTE", bytes(range(6)))
               + chunk(b"IDAT", zlib.compress(b"\x00" * 20))
               + chunk(b"IEND", b""))
    (tmp_path / "a.png").write_bytes(palette)
    cv2.imwrite(str(tmp_path / "a.jpg"), np.zeros((4, 4, 3), np.uint8))
    for name in ("a.png", "a.jpg"):
        with pytest.raises(NotImplementedError, match="A3c"):
            read_png(str(tmp_path / name))


# --- the generator ----------------------------------------------------------

def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_bonai_cv2",
        osp.join(ROOT, "tools/make_synthetic_bonai.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cv2_shapes(monkeypatch, gen):
    """Draw the port generator's circles and roads with cv2."""
    monkeypatch.setattr(gen, "circle_filled_aa", lambda img, c, r, col: cv2.circle(
        img, (int(c[0]), int(c[1])), int(r), col, -1, lineType=cv2.LINE_AA))
    monkeypatch.setattr(gen, "thick_line", lambda img, p0, p1, col, t: cv2.line(
        img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), col, int(t)))


@pytest.mark.parametrize("split", ["tiles", "scenes"])
def test_generator_matches_the_cv2_tool(tmp_path, monkeypatch, split):
    """``write_split`` at 256^2 with 3 tiles and ``write_scene_split`` with
    one 512^2 scene cut into four 256^2 crops: the jsons are equal (every
    drawn value, the L/T outlines included); the images differ from the
    cv2 tool's within the stated mean, and not at all once cv2 draws the
    anti-aliased circles and the roads."""
    from bonai_tpu_torch.tools import make_synthetic_bonai as gen
    ref = _reference_tool()

    def run(module, out):
        if split == "tiles":
            module.write_split(str(out), "train", 3, 0, 256)
            return ["train"]
        module.write_scene_split(str(out), "val", 1, 77, 512, 256)
        return ["val", "val_originals"]
    tags = run(ref, tmp_path / "cv2")
    run(gen, tmp_path / "port")
    _cv2_shapes(monkeypatch, gen)
    run(gen, tmp_path / "port_cv2_shapes")
    means = []
    for tag in tags:
        want = json.load(open(tmp_path / "cv2" / tag / f"{tag}.json"))
        got = json.load(open(tmp_path / "port" / tag / f"{tag}.json"))
        assert got == want
        assert any(len(a["footprint_mask"]) > 8 for a in got["annotations"])
        for im in want["images"]:
            ref_img = cv2.imread(str(tmp_path / "cv2" / tag / "images"
                                     / im["file_name"]))
            got_img = read_png(str(tmp_path / "port" / tag / "images"
                                   / im["file_name"]))
            means.append(np.abs(ref_img.astype(np.int32) - got_img).mean())
            np.testing.assert_array_equal(read_png(str(
                tmp_path / "port_cv2_shapes" / tag / "images"
                / im["file_name"])), ref_img)
    assert np.mean(means) <= 2 * TILE_MEAN_DIFF, means


def test_generator_prefix_is_the_longer_split(tmp_path):
    """The first tiles of a split are the first tiles of a longer split of
    the same seed (chip_smoke trains on the acceptance set's first 8)."""
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_split
    write_split(str(tmp_path / "a"), "train", 1, 0, 128)
    write_split(str(tmp_path / "b"), "train", 2, 0, 128)
    a = json.load(open(tmp_path / "a/train/train.json"))
    b = json.load(open(tmp_path / "b/train/train.json"))
    assert a["images"] == b["images"][:1]
    assert a["annotations"] == [x for x in b["annotations"]
                                if x["image_id"] == 0]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "a/train/images/train_00000.png")),
        read_png(str(tmp_path / "b/train/images/train_00000.png")))
