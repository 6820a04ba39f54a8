"""Generate the synthetic BONAI-format dataset without cv2.

The counterpart of ``tools/make_synthetic_bonai.py``, drawn with numpy
(``bonai_tpu_torch.utils.raster``) and written as PNG through ``zlib``
(``bonai_tpu_torch.utils.png``), so that it runs where OpenCV is not
installed.  It makes the same ``numpy.random.RandomState`` draws in the
same order, so every drawn value of the json (boxes, offsets, heights,
``offset_angle``, roof parts, rectangular footprints) equals the original
tool's for the same arguments, and the first ``k`` tiles of a split are the
first ``k`` tiles of any longer split of the same seed.  The L/T footprint
outlines come from the same 2x-supersampled raster and contour trace; the
images differ from the original tool's only along the edges of the
anti-aliased ground patches and the roads (``circle_filled_aa``,
``thick_line``).

- 1024x1024 tiles with 15-110 buildings each (clustered city-block
  layout plus scattered singles);
- footprints are rotated rectangles and L/T-shaped polygons, log-normal
  size distribution;
- one off-nadir direction and angle per tile: every building's
  roof-to-footprint offset is ``height * tan(off_nadir) * ppm`` along it;
- painter's order along the view direction: ground, shadow, facade, then
  roof with per-building albedo and texture noise;
- annotations carry the BONAI schema: roof ``segmentation``,
  ``footprint_mask``, ``building_bbox``, ``footprint_bbox``, ``offset``
  (roof -> footprint: footprint = roof - offset), ``building_height``,
  ``offset_angle`` per image.

The acceptance set (the arguments of ``tools/make_synth_data.sh``):

  python -m bonai_tpu_torch.tools.make_synthetic_bonai \\
      --out data/synth_bonai --train 800 --val-scenes 40 --size 1024 --seed 0
"""

import argparse
import json
import math
import os
import os.path as osp

import numpy as np

from ..utils.png import write_png
from ..utils.raster import (add_weighted, circle_filled_aa, contour_area,
                            convex_hull, fill_poly, find_external_contours,
                            thick_line)


def _rot(points, angle, cx, cy):
    c, s = math.cos(angle), math.sin(angle)
    p = np.asarray(points, np.float64) - (cx, cy)
    return np.stack([p[:, 0] * c - p[:, 1] * s + cx,
                     p[:, 0] * s + p[:, 1] * c + cy], 1)


def _footprint_poly(rng, cx, cy, w, h, angle):
    """Rotated rect, or L/T shape built from two overlapping rects."""
    kind = rng.rand()
    if kind < 0.6:
        base = [(cx - w / 2, cy - h / 2), (cx + w / 2, cy - h / 2),
                (cx + w / 2, cy + h / 2), (cx - w / 2, cy + h / 2)]
        return [_rot(base, angle, cx, cy)]
    # L/T: union of two rects sharing a corner/edge (kept as two parts;
    # the polygon fill unions them when rasterised, and the json stores the
    # multi-part polygon the same way real annotations do)
    w2 = w * rng.uniform(0.4, 0.7)
    h2 = h * rng.uniform(0.4, 0.7)
    dx = (w - w2) / 2 * (1 if rng.rand() < 0.5 else -1)
    dy = (h - h2) / 2
    a = [(cx - w / 2, cy - h / 2), (cx + w / 2, cy - h / 2),
         (cx + w / 2, cy - h / 2 + h2), (cx - w / 2, cy - h / 2 + h2)]
    b = [(cx + dx - w2 / 2, cy - h / 2 + h2),
         (cx + dx + w2 / 2, cy - h / 2 + h2),
         (cx + dx + w2 / 2, cy + h / 2), (cx + dx - w2 / 2, cy + h / 2)]
    return [_rot(a, angle, cx, cy), _rot(b, angle, cx, cy)]


def _union_outline(parts):
    """Single outline polygon of (possibly multi-part, edge-connected)
    parts via 2x-supersampled raster + contour extraction.  Needed
    because the BONAI schema stores ``footprint_mask`` as ONE polygon."""
    if len(parts) == 1:
        return parts[0]
    allp = np.concatenate(parts, 0)
    x0, y0 = np.floor(allp.min(0)) - 2
    ss = 2
    w = int((allp[:, 0].max() - x0 + 4) * ss)
    h = int((allp[:, 1].max() - y0 + 4) * ss)
    m = np.zeros((h, w), np.uint8)
    for p in parts:
        fill_poly(m, [np.round((p - (x0, y0)) * ss).astype(np.int32)], 1)
    cs = find_external_contours(m)
    c = max(cs, key=contour_area).astype(np.float64)
    return c / ss + (x0, y0)


def _poly_bbox(parts):
    allp = np.concatenate(parts, 0)
    x1, y1 = allp.min(0)
    x2, y2 = allp.max(0)
    return float(x1), float(y1), float(x2), float(y2)


def make_tile(rng, size=1024):
    """Returns (image, list of building dicts, off-nadir meta)."""
    img = np.full((size, size, 3), 0, np.uint8)
    # ground: noise + patches + roads
    base = rng.randint(60, 110)
    img[:] = (base + rng.randn(size, size, 3) * 12).clip(0, 255)
    for _ in range(rng.randint(2, 6)):     # dirt/grass patches
        c = rng.randint(0, size, 2)
        r = rng.randint(60, 300)
        col = np.array([rng.randint(40, 90), rng.randint(70, 130),
                        rng.randint(60, 110)], float)
        circle_filled_aa(img, c, r, col + rng.randn(3) * 6)
    for _ in range(rng.randint(2, 5)):     # roads
        p0 = rng.randint(0, size, 2)
        p1 = rng.randint(0, size, 2)
        thick_line(img, p0, p1, (150, 150, 150), rng.randint(8, 22))
    img = (img.astype(np.float32)
           + rng.randn(size, size, 3) * 6).clip(0, 255).astype(np.uint8)

    # one acquisition geometry per tile
    theta = rng.uniform(0, 2 * math.pi)           # offset direction
    off_nadir = rng.uniform(0.05, 0.55)           # radians-ish factor
    ppm = 1.7                                     # pixels per meter scale
    dirv = np.array([math.cos(theta), math.sin(theta)])

    # building placement: blocks + scatter
    n_target = rng.randint(15, 110)
    centers = []
    n_blocks = rng.randint(1, 5)
    blocks = [(rng.uniform(100, size - 100, 2),
               rng.uniform(0, 2 * math.pi)) for _ in range(n_blocks)]
    while len(centers) < n_target:
        if rng.rand() < 0.7 and blocks:
            bc, ba = blocks[rng.randint(len(blocks))]
            gx = rng.randint(-4, 5) * rng.uniform(45, 90)
            gy = rng.randint(-2, 3) * rng.uniform(45, 90)
            c, s = math.cos(ba), math.sin(ba)
            centers.append((bc[0] + gx * c - gy * s,
                            bc[1] + gx * s + gy * c))
        else:
            centers.append(tuple(rng.uniform(20, size - 20, 2)))
        if len(centers) > 4 * n_target:
            break
    buildings = []
    for cx, cy in centers[:n_target]:
        if not (0 <= cx < size and 0 <= cy < size):
            continue
        scale = float(np.exp(rng.normal(3.3, 0.55)))       # ~15-100px
        w = scale * rng.uniform(0.7, 1.4)
        h = scale * rng.uniform(0.7, 1.4)
        if w < 9 or h < 9:
            continue
        angle = rng.uniform(0, math.pi)
        height_m = float(np.exp(rng.normal(2.2, 0.7)))      # ~3-60 m
        off = dirv * height_m * math.tan(off_nadir) * ppm
        fp = _footprint_poly(rng, cx, cy, w, h, angle)
        roof = [p + off for p in fp]
        bx = _poly_bbox(fp + roof)
        if bx[0] < -10 or bx[1] < -10 or bx[2] > size + 10 \
                or bx[3] > size + 10:
            continue
        buildings.append(dict(fp=fp, roof=roof, off=off,
                              height=height_m, cx=cx, cy=cy))

    # painter's order: far-from-camera first (projected onto view dir)
    buildings.sort(key=lambda b: -(b["cx"] * dirv[0] + b["cy"] * dirv[1]))

    for b in buildings:
        albedo = np.array([rng.randint(70, 230) for _ in range(3)], float)
        facade = (albedo * 0.45).clip(20, 255)
        shadow_dir = -dirv
        # soft shadow on the ground
        sh = [np.round(p + shadow_dir * b["height"] * 0.9).astype(np.int32)
              for p in b["fp"]]
        overlay = img.copy()
        fill_poly(overlay, sh, (35, 35, 35))
        # the blend keeps every pixel the shadow left unchanged, so only
        # the shadow's box is blended
        allp = np.concatenate(sh, 0)
        (x0, y0), (x1, y1) = (np.clip(allp.min(0), 0, size),
                              np.clip(allp.max(0) + 1, 0, size))
        win = np.s_[y0:y1, x0:x1]
        img[win] = add_weighted(overlay[win], 0.4, img[win], 0.6)
        # facade: convex hull of footprint+roof minus roof (approx: fill
        # hull with facade colour, roof painted after)
        for pf, pr in zip(b["fp"], b["roof"]):
            hull = convex_hull(np.concatenate(
                [pf, pr], 0).astype(np.float32)).astype(np.int32)
            fill_poly(img, [hull.reshape(-1, 2)], facade)
        roof_col = albedo + rng.randn(3) * 5
        fill_poly(img, [np.round(p).astype(np.int32)
                        for p in b["roof"]], roof_col)
        # roof texture + ridge line
        x1, y1, x2, y2 = map(int, _poly_bbox(b["roof"]))
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, size), min(y2, size)
        if x2 > x1 and y2 > y1:
            patch = img[y1:y2, x1:x2].astype(np.float32)
            img[y1:y2, x1:x2] = (patch + rng.randn(
                y2 - y1, x2 - x1, 3) * 4).clip(0, 255).astype(np.uint8)
    return img, buildings, dict(theta=theta, off_nadir=off_nadir)


def _clip_half(poly, cx0, cy0, cx1, cy1):
    """Sutherland–Hodgman: keep the part of ``poly`` left of the directed
    edge (cx0,cy0)->(cx1,cy1)."""
    ex, ey = cx1 - cx0, cy1 - cy0
    out = []
    n = len(poly)
    for i in range(n):
        px, py = poly[i]
        qx, qy = poly[(i + 1) % n]
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


def _clip_rect(poly, x0, y0, x1, y1):
    """Clip polygon (array (n,2)) to [x0,x1]x[y0,y1]; returns (m,2) array
    (possibly empty)."""
    p = [tuple(q) for q in np.asarray(poly, np.float64)]
    for edge in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                 ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        p = _clip_half(p, *edge[0], *edge[1])
        if len(p) < 3:
            return np.zeros((0, 2))
    return np.asarray(p)


def _shoelace(poly):
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))) / 2


def _ann_from_parts(aid, img_id, roof_parts, fp_poly, off, height):
    """One BONAI-schema annotation dict from roof polygon parts + the
    footprint outline polygon."""
    bx = _poly_bbox(roof_parts + [fp_poly])
    rx1, ry1, rx2, ry2 = _poly_bbox(roof_parts)
    fx1, fy1, fx2, fy2 = _poly_bbox([fp_poly])
    return dict(
        id=aid, image_id=img_id, category_id=1,
        bbox=[rx1, ry1, rx2 - rx1, ry2 - ry1],
        building_bbox=[bx[0], bx[1], bx[2] - bx[0], bx[3] - bx[1]],
        footprint_bbox=[fx1, fy1, fx2 - fx1, fy2 - fy1],
        roof_bbox=[rx1, ry1, rx2 - rx1, ry2 - ry1],
        segmentation=[p.reshape(-1).tolist() for p in roof_parts],
        footprint_mask=fp_poly.reshape(-1).tolist(),
        offset=[float(off[0]), float(off[1])],
        building_height=float(height),
        area=float((rx2 - rx1) * (ry2 - ry1)),
        iscrowd=0, only_footprint=0)


def write_scene_split(out, name, n_scenes, seed, scene_size=2048,
                      crop=1024, min_clip_area=60.0):
    """Generate true ``scene_size``² originals AND their ``crop``² tiles
    named ``scene{i}__{x}_{y}.png`` (the real BONAI crop protocol:
    reference ``tools/bonai/bonai_evaluation.py:104-112`` merges crop CSVs
    back to original-image coordinates by parsing that suffix).

    Writes two datasets:
      {out}/{name}/            crop tiles + {name}.json   (crop coords)
      {out}/{name}_originals/  scene images + json        (scene coords)

    Buildings spanning a crop boundary appear clipped in the crop json
    (like the real crop1024 annotations) but whole in the originals json,
    so crop-level and merged scene-level F1 measure genuinely different
    things.
    """
    crop_dir = osp.join(out, name, "images")
    orig_dir = osp.join(out, name + "_originals", "images")
    os.makedirs(crop_dir, exist_ok=True)
    os.makedirs(orig_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    o_images, o_anns, c_images, c_anns = [], [], [], []
    o_aid = c_aid = 1
    cid = 0
    for i in range(n_scenes):
        img, buildings, meta = make_tile(rng, scene_size)
        stem = f"scene{i:04d}"
        write_png(osp.join(orig_dir, stem + ".png"), img)
        o_images.append(dict(id=i, file_name=stem + ".png",
                             width=scene_size, height=scene_size,
                             offset_angle=dict(angle=meta["off_nadir"])))
        for b in buildings:
            fp_poly = _union_outline(b["fp"])
            o_anns.append(_ann_from_parts(
                o_aid, i, [np.asarray(p) for p in b["roof"]], fp_poly,
                b["off"], b["height"]))
            o_aid += 1
        for y in range(0, scene_size, crop):
            for x in range(0, scene_size, crop):
                cname = f"{stem}__{x}_{y}.png"
                write_png(osp.join(crop_dir, cname),
                          img[y:y + crop, x:x + crop])
                c_images.append(dict(
                    id=cid, file_name=cname, width=crop, height=crop,
                    offset_angle=dict(angle=meta["off_nadir"])))
                shift = np.array([x, y], np.float64)
                for b in buildings:
                    roof_parts = []
                    for p in b["roof"]:
                        cp = _clip_rect(p, x, y, x + crop, y + crop)
                        if _shoelace(cp) >= min_clip_area:
                            roof_parts.append(cp - shift)
                    if not roof_parts:
                        continue
                    fp_poly = _clip_rect(_union_outline(b["fp"]),
                                         x, y, x + crop, y + crop)
                    if _shoelace(fp_poly) < min_clip_area:
                        continue
                    c_anns.append(_ann_from_parts(
                        c_aid, cid, roof_parts, fp_poly - shift,
                        b["off"], b["height"]))
                    c_aid += 1
                cid += 1
        if (i + 1) % 10 == 0:
            print(f"{name}: scene {i + 1}/{n_scenes}", flush=True)
    for tag, images, anns in ((name, c_images, c_anns),
                              (name + "_originals", o_images, o_anns)):
        ds = dict(images=images, annotations=anns,
                  categories=[dict(id=1, name="building")])
        jp = osp.join(out, tag, f"{tag}.json")
        with open(jp, "w") as f:
            json.dump(ds, f)
        print(f"wrote {jp}: {len(images)} images, {len(anns)} anns")


def write_split(out, name, n_tiles, seed, size=1024, stems=None):
    img_dir = osp.join(out, name, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    aid = 1
    for i in range(n_tiles):
        img, buildings, meta = make_tile(rng, size)
        stem = stems(i) if stems else f"{name}_{i:05d}"
        fname = stem + ".png"
        write_png(osp.join(img_dir, fname), img)
        images.append(dict(id=i, file_name=fname, width=size, height=size,
                           offset_angle=dict(angle=meta["off_nadir"])))
        for b in buildings:
            roof_parts = [p.reshape(-1).tolist() for p in b["roof"]]
            fp_poly = _union_outline(b["fp"]).reshape(-1).tolist()
            bx1, by1, bx2, by2 = _poly_bbox(b["fp"] + b["roof"])
            rx1, ry1, rx2, ry2 = _poly_bbox(b["roof"])
            fx1, fy1, fx2, fy2 = _poly_bbox(b["fp"])
            annotations.append(dict(
                id=aid, image_id=i, category_id=1,
                bbox=[rx1, ry1, rx2 - rx1, ry2 - ry1],
                building_bbox=[bx1, by1, bx2 - bx1, by2 - by1],
                footprint_bbox=[fx1, fy1, fx2 - fx1, fy2 - fy1],
                roof_bbox=[rx1, ry1, rx2 - rx1, ry2 - ry1],
                segmentation=roof_parts,
                footprint_mask=fp_poly,
                offset=[float(b["off"][0]), float(b["off"][1])],
                building_height=b["height"],
                area=float((rx2 - rx1) * (ry2 - ry1)),
                iscrowd=0, only_footprint=0,
            ))
            aid += 1
        if (i + 1) % 100 == 0:
            print(f"{name}: {i + 1}/{n_tiles}", flush=True)
    ds = dict(images=images, annotations=annotations,
              categories=[dict(id=1, name="building")])
    jp = osp.join(out, name, f"{name}.json")
    with open(jp, "w") as f:
        json.dump(ds, f)
    print(f"wrote {jp}: {len(images)} images, {len(annotations)} anns")
    return jp, img_dir


def write_attribute_maps(out, name):
    """LOFT's dense GT of a written split: for each image, a side-face map
    ``<name>/side_face/<file_name>`` (gray PNG, 255 on the pixels of a
    building's box outside its roof, its visible facade) and an offset
    field ``<name>/offset_field/<stem>.npy`` (``(H, W, 2)`` float32: each
    roof pixel holds its building's offset, the other pixels the ignore
    sentinel 400), the names the BONAI dataset reads under its
    ``side_face_prefix`` and ``offset_field_prefix``.  Returns the two
    directories."""
    with open(osp.join(out, name, f"{name}.json")) as f:
        ds = json.load(f)
    dirs = [osp.join(out, name, d) for d in ("side_face", "offset_field")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    anns = {}
    for a in ds["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    for im in ds["images"]:
        h, w = im["height"], im["width"]
        roof = np.zeros((h, w), np.int32)             # building index + 1
        side = np.zeros((h, w), np.uint8)
        offsets = [np.full(2, 400.0, np.float32)]
        for k, a in enumerate(anns.get(im["id"], []), 1):
            x, y, bw, bh = a["building_bbox"]
            side[int(y):int(y + bh) + 1, int(x):int(x + bw) + 1] = 255
            fill_poly(roof, [np.round(np.reshape(p, (-1, 2)))
                             for p in a["segmentation"]], k)
            offsets.append(np.asarray(a["offset"], np.float32))
        side[roof > 0] = 0
        write_png(osp.join(dirs[0], im["file_name"]), side)
        np.save(osp.join(dirs[1], osp.splitext(im["file_name"])[0]
                         + ".npy"), np.stack(offsets)[roof])
    return dirs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--val", type=int, default=200)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-scenes", type=int, default=None,
                    help="generate the val split as N true 2*size scenes "
                         "cropped into size tiles (__x_y naming) instead "
                         "of independent tiles")
    args = ap.parse_args()
    if args.train:
        write_split(args.out, "train", args.train, args.seed, args.size)
    if args.val_scenes:
        # true originals + crops: exercises the evaluator's crop->scene
        # merge path on buildings genuinely split across crop boundaries
        write_scene_split(args.out, "val", args.val_scenes, args.seed + 77,
                          scene_size=2 * args.size, crop=args.size)
    elif args.val:
        write_split(args.out, "val", args.val, args.seed + 77, args.size)


if __name__ == "__main__":
    main()
