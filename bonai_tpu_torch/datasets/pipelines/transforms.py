"""The train and test pipelines' steps in numpy, without cv2
(counterparts of the steps of ``bonai_tpu/datasets/pipelines/
transforms.py`` that the BONAI and synthetic configs use):
``LoadImageFromFile`` (PNG through ``utils/png.py`` and JPEG through
``utils/jpeg.py``, with the decoded-image cache), ``LoadAnnotations``
(with LOFT's edge, side-face and offset-field maps), ``LoadProposals``,
``Resize``, ``RandomFlip``, ``RandomRotate`` (its warps in
``utils/warp.py``), ``OffsetTransform``, ``Pointobb2RBBox``,
``Normalize``, ``Pad``, ``DefaultFormatBundle``, ``ImageToTensor``,
``Collect`` and ``MultiScaleFlipAug``; ``Corrupt`` (``corrupt.py``);
CornerNet's ``PhotoMetricDistortion`` (its HSV conversions in
``utils/color.py``) and ``RandomCenterCropPad``.

Masks travel as polygons (lists of ``(K, 2)`` float32 arrays per instance
part) until the loader packs them, so the geometric steps are exact.  The
dense maps (``edge_fields``, ``side_face_fields``, ``offset_field_fields``)
travel at image resolution: resized nearest, flipped, rotated (nearest)
and padded with the image.
"""

from __future__ import annotations

import hashlib
import math
import os
import os.path as osp
import warnings

import numpy as np

from ...core.masks import resize_bilinear
from ...registry import Registry, build_from_cfg
from ...utils.color import bgr_to_hsv, hsv_to_bgr
from ...utils.jpeg import read_jpeg
from ...utils.png import read_png
from ...utils.warp import min_area_rect, rotation_matrix_2d, warp_affine

PIPELINES = Registry("pipeline")
MAP_FIELDS = ("edge_fields", "side_face_fields", "offset_field_fields")

# the JAX package's other transforms, by the ROADMAP.md item that ports them
UNPORTED = {
    **dict.fromkeys(("Expand", "MinIoURandomCrop", "RandomCrop",
                     "AutoAugment"), "item A6"),
    "SegRescale": "item A7",
    **dict.fromkeys(("InstaBoost", "Albu"),
                    "not queued: it wraps a package (instaboostfast, "
                    "albumentations) that neither machine has"),
}


def build_pipeline(cfgs):
    for c in cfgs:
        if c.get("type") in UNPORTED:
            raise NotImplementedError(
                f"transform {c['type']} is not ported to bonai_tpu_torch "
                f"(ROADMAP.md {UNPORTED[c['type']]})")
    return Compose([build_from_cfg(c, PIPELINES) for c in cfgs])


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


def imread(path):
    """A PNG or baseline JPEG file as ``(H, W, 3)`` BGR ``uint8``, as
    ``cv2.imread(path, IMREAD_COLOR)`` reads it; the decoder is chosen by
    the file's signature, not its name."""
    with open(path, "rb") as f:
        head = f.read(2)
    return read_jpeg(path) if head == b"\xff\xd8" else read_png(path)


@PIPELINES.register_module()
class LoadImageFromFile:
    """Loads the image as BGR ``uint8`` (``imread``).

    ``cache_dir``: a decoded-image cache.  The first read of a file
    decodes it and publishes a raw ``uint8`` ``.npy`` (written to a
    temporary name, then renamed: atomic), later reads load that."""

    def __init__(self, to_float32=False, cache_dir=None):
        self.to_float32 = to_float32
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _read(self, path):
        if not self.cache_dir:
            return imread(path)
        key = hashlib.sha1(path.encode()).hexdigest()[:24]
        cpath = osp.join(self.cache_dir, key + ".npy")
        if osp.exists(cpath):
            return np.load(cpath)
        img = imread(path)
        tmp = cpath[:-4] + f".{os.getpid()}.tmp.npy"
        try:
            np.save(tmp, img)
            os.replace(tmp, cpath)
        except OSError:
            pass
        return img

    def __call__(self, results):
        path = osp.join(results.get("img_prefix", ""),
                        results["img_info"]["filename"])
        img = self._read(path)
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = path
        results["img"] = img
        results["img_shape"] = img.shape[:2]
        results["ori_shape"] = img.shape[:2]
        results["scale_factor"] = 1.0
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """Boxes, labels, polygon masks, offsets, building heights, footprint
    boxes, the mean angle and the footprint-only flag of ``ann_info``;
    the image's edge and side-face maps (PNG, read as
    ``cv2.IMREAD_UNCHANGED`` reads them, squeezed) and offset field
    (``.npy``, the 400/500 sentinels zeroed) from the dataset's
    ``<kind>_prefix``, where it has one."""

    # sentinel component values of an offset field's unsupervised pixels
    OFFSET_FIELD_IGNORE = (400.0, 500.0)

    def __init__(self, with_bbox=True, with_label=True, with_mask=False,
                 with_offset=False, with_building_height=False,
                 with_angle=False, with_seg=False,
                 with_footprint_bbox=False,
                 with_only_footprint_flag=False,
                 with_edge=False, with_side_face=False,
                 with_offset_field=False, **kwargs):
        self.with_edge = with_edge
        self.with_side_face = with_side_face
        self.with_offset_field = with_offset_field
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.with_offset = with_offset
        self.with_building_height = with_building_height
        self.with_angle = with_angle
        self.with_footprint_bbox = with_footprint_bbox
        self.with_only_footprint_flag = with_only_footprint_flag

    @staticmethod
    def _polys(segmentation):
        """A COCO ``segmentation`` as polygons: an RLE (the whole
        segmentation or one part of it) is decoded and traced into the
        evaluator's contours, so the geometric steps stay exact."""
        from ...evaluation.bonai_eval import masks_to_polygons
        from ..mask_utils import decode_mask
        if isinstance(segmentation, dict):
            return masks_to_polygons(decode_mask(segmentation))
        out = []
        for part in segmentation:
            if isinstance(part, dict):
                out.extend(masks_to_polygons(decode_mask(part)))
                continue
            arr = np.asarray(part, np.float32).reshape(-1, 2)
            if arr.shape[0] >= 3:
                out.append(arr)
        return out

    def __call__(self, results):
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = np.asarray(
                ann["bboxes"], np.float32).reshape(-1, 4)
        if self.with_label:
            results["gt_labels"] = np.asarray(
                ann["labels"], np.int64).reshape(-1)
        if self.with_mask:
            results["gt_masks"] = [self._polys(m) for m in ann["masks"]]
        if self.with_offset:
            results["gt_offsets"] = np.asarray(
                ann["offsets"], np.float32).reshape(-1, 2)
        if self.with_building_height:
            results["gt_building_heights"] = np.asarray(
                ann.get("building_heights", []), np.float32)
        if self.with_angle:
            results["gt_angle"] = np.float32(ann.get("angle", 0.0))
        if self.with_footprint_bbox:
            results["gt_footprint_bboxes"] = np.asarray(
                ann.get("footprint_bboxes", np.zeros((0, 4))),
                np.float32).reshape(-1, 4)
        if self.with_only_footprint_flag:
            results["gt_only_footprint_flag"] = np.float32(
                ann.get("only_footprint_flag", 0.0))
        if self.with_edge:
            self._load_aux_map(results, "edge")
        if self.with_side_face:
            self._load_aux_map(results, "side_face")
        if self.with_offset_field:
            self._load_offset_field(results)
        return results

    @staticmethod
    def _load_aux_map(results, kind):
        """``gt_<kind>_maps``: the image's ``(H, W)`` map, registered in
        ``<kind>_fields``."""
        prefix = results.get(f"{kind}_prefix")
        if prefix is None:
            return
        path = osp.join(prefix, results["ann_info"][f"{kind}_map"])
        key = f"gt_{kind}_maps"
        results[key] = np.squeeze(read_png(path, unchanged=True))
        results.setdefault(f"{kind}_fields", []).append(key)

    def _load_offset_field(self, results):
        """``gt_offset_field``: the image's ``(H, W, 2)`` float32 field,
        each component's sentinel pixels set to 0."""
        prefix = results.get("offset_field_prefix")
        if prefix is None:
            return
        field = np.load(osp.join(prefix, results["ann_info"][
            "offset_field"])).astype(np.float32)
        for c in range(2):
            field[..., c][np.isin(field[..., c],
                                  self.OFFSET_FIELD_IGNORE)] = 0.0
        results["gt_offset_field"] = field
        results.setdefault("offset_field_fields", []).append(
            "gt_offset_field")


def resize_nearest(img, h, w):
    """``img`` ``(H, W, ...)`` resized to ``(h, w)`` as
    ``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` does:
    source index ``floor(i / (h / H))`` in float64, clamped."""
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    return img[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


@PIPELINES.register_module()
class LoadProposals:
    """Fast R-CNN's precomputed proposals: the dataset's
    ``results['proposals']`` (from its ``proposal_file``), an ``(N, 4|5)``
    array an image in the original image's pixels, cut to the first
    ``num_max_proposals`` and to its boxes.  ``Resize`` and
    ``RandomFlip`` then move them with the GT boxes; the loader pads them
    to ``num_max_proposals`` (2000 without one)."""

    def __init__(self, num_max_proposals=None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results):
        props = np.asarray(results.get("proposals", np.zeros((0, 4))),
                           np.float32)
        if props.ndim != 2 or props.shape[1] not in (4, 5):
            raise AssertionError(
                f"proposals should be (N, 4|5), got {props.shape}")
        props = props[:, :4]
        if self.num_max_proposals is not None:
            props = props[:self.num_max_proposals]
            results["_num_max_proposals"] = int(self.num_max_proposals)
        results["proposals"] = props
        return results


@PIPELINES.register_module()
class Resize:
    """Keep-ratio resize to fit ``img_scale``.  Instance offsets are not
    rescaled, as in the JAX package.  At the identity size (the 1024^2
    tiles at ``img_scale=(1024, 1024)``) nothing is resampled; other sizes
    resample bilinearly (``core/masks.py::resize_bilinear``, rounded to
    ``uint8``), the dense maps by their nearest pixel
    (:func:`resize_nearest`: their values are classes and offsets).

    Multi-scale training: ``img_scale`` may be a list of scales with
    ``multiscale_mode='value'`` (pick one) or ``'range'`` (long and short
    edges uniform between the two scales), drawn from ``np.random`` as the
    JAX step draws them."""

    def __init__(self, img_scale=None, keep_ratio=True,
                 multiscale_mode="range"):
        if img_scale and isinstance(img_scale[0], (list, tuple)):
            self.img_scales = [tuple(s) for s in img_scale]
            self.img_scale = self.img_scales[0]
        else:
            self.img_scales = None
            self.img_scale = tuple(img_scale) if img_scale else None
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode

    def _sample_scale(self):
        if self.img_scales is None:
            return self.img_scale
        if self.multiscale_mode == "value" or len(self.img_scales) > 2:
            return self.img_scales[
                np.random.randint(len(self.img_scales))]
        (l0, s0), (l1, s1) = [(max(s), min(s)) for s in self.img_scales]
        long_edge = np.random.randint(min(l0, l1), max(l0, l1) + 1)
        short_edge = np.random.randint(min(s0, s1), max(s0, s1) + 1)
        return (long_edge, short_edge)

    def __call__(self, results):
        h, w = results["img"].shape[:2]
        target = results.get("scale", self._sample_scale())
        if target is None:
            return results
        max_long, max_short = max(target), min(target)
        if self.keep_ratio:
            scale = min(max_long / max(h, w), max_short / min(h, w))
            new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        else:
            new_w, new_h = target
        if (new_h, new_w) != (h, w):
            img = resize_bilinear(results["img"], new_h, new_w)
            if results["img"].dtype == np.uint8:
                img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
            results["img"] = img
        w_scale = new_w / w
        h_scale = new_h / h
        results["img_shape"] = (new_h, new_w)
        results["scale_factor"] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        for key in ("gt_bboxes", "gt_footprint_bboxes", "proposals"):
            if key in results and len(results[key]):
                b = results[key] * results["scale_factor"]
                b[:, 0::2] = b[:, 0::2].clip(0, new_w)
                b[:, 1::2] = b[:, 1::2].clip(0, new_h)
                results[key] = b
        if "gt_masks" in results:
            results["gt_masks"] = [
                [p * np.array([w_scale, h_scale], np.float32) for p in inst]
                for inst in results["gt_masks"]]
        for group in MAP_FIELDS:
            for key in results.get(group, []):
                results[key] = resize_nearest(results[key], new_h, new_w)
        return results


@PIPELINES.register_module()
class RandomFlip:
    """Horizontal / vertical flip of the image, boxes, polygons, offsets
    and dense maps (an offset's x is negated by a horizontal flip, its y by
    a vertical one; so is an offset field's component, whose sentinel
    pixels stay marked, as 500).  Draws ``rng.rand()`` and then
    ``rng.randint(len(directions))`` from ``results['_rng']``, in that
    order, unless ``flip`` is set."""

    def __init__(self, flip_ratio=0.5, direction="horizontal"):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        rng = results.setdefault("_rng", np.random.RandomState())
        if "flip" not in results:
            flip = rng.rand() < self.flip_ratio
            directions = (self.direction if isinstance(self.direction, list)
                          else [self.direction])
            direction = directions[rng.randint(len(directions))]
            results["flip"] = bool(flip)
            results["flip_direction"] = direction if flip else None
        direction = results.get("flip_direction") or "horizontal"
        if not results["flip"]:
            return results
        h, w = results["img_shape"]
        horizontal = direction == "horizontal"
        results["img"] = (results["img"][:, ::-1] if horizontal
                          else results["img"][::-1])
        for key in ("gt_bboxes", "gt_footprint_bboxes", "proposals"):
            if key in results and len(results[key]):
                b = results[key].copy()
                src = results[key]
                if horizontal:
                    b[:, 0], b[:, 2] = w - src[:, 2], w - src[:, 0]
                else:
                    b[:, 1], b[:, 3] = h - src[:, 3], h - src[:, 1]
                results[key] = b
        if "gt_masks" in results:
            flipped = []
            for inst in results["gt_masks"]:
                parts = []
                for p in inst:
                    q = p.copy()
                    if horizontal:
                        q[:, 0] = w - q[:, 0]
                    else:
                        q[:, 1] = h - q[:, 1]
                    parts.append(q)
                flipped.append(parts)
            results["gt_masks"] = flipped
        if "gt_offsets" in results and len(results["gt_offsets"]):
            o = results["gt_offsets"].copy()
            o[:, 0 if horizontal else 1] *= -1
            results["gt_offsets"] = o
        axis = 1 if horizontal else 0
        for key in (results.get("edge_fields", [])
                    + results.get("side_face_fields", [])):
            results[key] = np.flip(results[key], axis=axis).copy()
        comp = 0 if horizontal else 1
        for key in results.get("offset_field_fields", []):
            field = np.flip(results[key], axis=axis).copy()
            ignore = np.isin(field[..., comp],
                             LoadAnnotations.OFFSET_FIELD_IGNORE)
            field[..., comp] = -field[..., comp]
            field[..., comp][ignore] = 500.0
            results[key] = field
        return results


@PIPELINES.register_module()
class RandomRotate:
    """Rotation of the image, boxes, polygons, offsets and dense maps about
    the image centre, by an angle drawn from ``angles`` (``'any'``: every
    whole degree of 0..359).  Draws ``rng.rand()`` and, only when it
    rotates, ``rng.randint(len(angles))`` from ``results['_rng']``, as the
    JAX transform does.

    Multiples of 90 degrees are exact: ``np.rot90`` and the matching
    integer remap of the coordinates.  Other angles warp the image
    bilinearly (``utils/warp.py::warp_affine``, cv2's ``warpAffine`` on
    the same fixed canvas, zero border) and the edge and side-face maps and
    the offset field by their nearest pixel; a box becomes the bounding box
    of its four turned corners, clipped to the canvas; polygon points go
    through the affine; offsets and the field's vectors turn by the angle
    (``(x cos a + y sin a, -x sin a + y cos a)``)."""

    def __init__(self, rotate_ratio=0.5, angles=(90, 180, 270)):
        self.rotate_ratio = rotate_ratio
        self.angles = list(range(0, 360)) if isinstance(angles, str) \
            else list(angles)

    @staticmethod
    def _rotate_points(xy, m):
        """A ``(2, 3)`` affine applied to ``(N, 2)`` points."""
        return xy @ m[:, :2].T + m[:, 2]

    @staticmethod
    def _turn(vectors, angle):
        """``(..., 2)`` vectors turned by ``angle`` degrees, float32."""
        a = math.radians(angle)
        c, s = math.cos(a), math.sin(a)
        x, y = vectors[..., 0], vectors[..., 1]
        return np.stack([x * c + y * s, -x * s + y * c],
                        -1).astype(np.float32)

    def _rotate_general(self, results, angle):
        h, w = results["img_shape"][:2]
        m = rotation_matrix_2d(((w - 1) * 0.5, (h - 1) * 0.5), angle)
        results["img"] = warp_affine(results["img"], m, (w, h), "linear")
        results["img_shape"] = results["img"].shape[:2]

        def rot_boxes(b):
            if not len(b):
                return b
            corners = np.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 1],
                                b[:, 2], b[:, 3], b[:, 0], b[:, 3]],
                               -1).reshape(-1, 2)
            r = self._rotate_points(corners, m).reshape(-1, 4, 2)
            out = np.concatenate([r.min(1), r.max(1)],
                                 -1).astype(np.float32)
            out[:, 0::2] = out[:, 0::2].clip(0, w)
            out[:, 1::2] = out[:, 1::2].clip(0, h)
            return out

        for key in ("gt_bboxes", "gt_footprint_bboxes", "proposals"):
            if key in results:
                results[key] = rot_boxes(results[key])
        if "gt_masks" in results:
            results["gt_masks"] = [
                [self._rotate_points(p, m).astype(np.float32) for p in inst]
                for inst in results["gt_masks"]]
        if "gt_offsets" in results and len(results["gt_offsets"]):
            results["gt_offsets"] = self._turn(results["gt_offsets"], angle)
        for key in (results.get("edge_fields", [])
                    + results.get("side_face_fields", [])):
            results[key] = warp_affine(results[key], m, (w, h), "nearest")
        for key in results.get("offset_field_fields", []):
            results[key] = self._turn(
                warp_affine(results[key], m, (w, h), "nearest"), angle)
        return results

    def draw_angle(self, rng):
        """The angle to turn by, drawn from ``rng`` as the JAX transform
        draws it, or ``None``: no turn."""
        if rng.rand() >= self.rotate_ratio:
            return None
        return self.angles[rng.randint(len(self.angles))]

    def __call__(self, results):
        angle = self.draw_angle(results.setdefault("_rng",
                                                   np.random.RandomState()))
        if angle is None:
            return results
        if angle % 90 != 0:
            return self._rotate_general(results, angle)
        k = (angle // 90) % 4
        if k == 0:
            return results
        h, w = results["img_shape"]
        results["img"] = np.ascontiguousarray(np.rot90(results["img"], k=k))
        results["img_shape"] = results["img"].shape[:2]

        def rotate_xy(x, y, hh, ww):
            """``(x, y)`` turned ``k`` quarter turns counter-clockwise."""
            for _ in range(k):
                x, y = y, ww - x
                hh, ww = ww, hh
            return x, y

        for key in ("gt_bboxes", "gt_footprint_bboxes", "proposals"):
            if key in results and len(results[key]):
                b = results[key]
                x1, y1 = rotate_xy(b[:, 0].copy(), b[:, 1].copy(), h, w)
                x2, y2 = rotate_xy(b[:, 2].copy(), b[:, 3].copy(), h, w)
                results[key] = np.stack(
                    [np.minimum(x1, x2), np.minimum(y1, y2),
                     np.maximum(x1, x2), np.maximum(y1, y2)], -1)
        if "gt_masks" in results:
            results["gt_masks"] = [
                [np.stack(rotate_xy(p[:, 0].copy(), p[:, 1].copy(), h, w),
                          -1) for p in inst]
                for inst in results["gt_masks"]]
        if "gt_offsets" in results and len(results["gt_offsets"]):
            results["gt_offsets"] = self._turn(results["gt_offsets"], angle)
        for key in (results.get("edge_fields", [])
                    + results.get("side_face_fields", [])):
            results[key] = np.ascontiguousarray(np.rot90(results[key], k=k))
        for key in results.get("offset_field_fields", []):
            results[key] = self._turn(np.ascontiguousarray(
                np.rot90(results[key], k=k)), angle)
        return results


@PIPELINES.register_module()
class OffsetTransform:
    """Offsets between rectangular ``(x, y)`` and polar ``(length,
    angle)`` form: ``'xy2la'`` (the polar offset head's training
    pipeline, after ``RandomFlip``) or ``'la2xy'``."""

    def __init__(self, transform_flag="xy2la"):
        self.transform_flag = transform_flag

    def __call__(self, results):
        if "gt_offsets" not in results or not len(results["gt_offsets"]):
            return results
        o = results["gt_offsets"]
        if self.transform_flag == "xy2la":
            out = [np.hypot(o[:, 0], o[:, 1]), np.arctan2(o[:, 1], o[:, 0])]
        elif self.transform_flag == "la2xy":
            out = [o[:, 0] * np.cos(o[:, 1]), o[:, 0] * np.sin(o[:, 1])]
        else:
            raise ValueError(self.transform_flag)
        results["gt_offsets"] = np.stack(out, -1).astype(np.float32)
        return results


@PIPELINES.register_module()
class Pointobb2RBBox:
    """Four-point oriented boxes ``(N, 8)`` of every key in
    ``results['rbbox_fields']`` encoded for the rotated-box experiments:
    ``'thetaobb'`` -> ``(xc, yc, w, h, theta)``, the minimum-area rectangle
    of the rounded points (``utils/warp.py::min_area_rect``, cv2's
    convention: theta in degrees, in ``[-90, 0)``); ``'hobb'`` -> ``(x1, y1,
    x2, y2, h)`` from the point order (of the four cyclic rolls) nearest
    the axis-aligned corners, ``h`` the length from its first point to its
    fourth; ``'pointobb'``: unchanged."""

    def __init__(self, encoding_method="thetaobb"):
        if encoding_method not in ("thetaobb", "hobb", "pointobb"):
            raise ValueError(encoding_method)
        self.encoding_method = encoding_method

    @staticmethod
    def _best_point_sort(pointobb):
        xs, ys = pointobb[0::2], pointobb[1::2]
        ref = np.array([xs.min(), ys.min(), xs.max(), ys.min(),
                        xs.max(), ys.max(), xs.min(), ys.max()])
        rolls = [np.roll(pointobb, k) for k in (0, 2, 4, 6)]
        d = [np.sum((c - ref) ** 2) for c in rolls]
        return rolls[int(np.argmin(d))]

    def __call__(self, results):
        for key in results.get("rbbox_fields", []):
            rb = np.asarray(results[key], np.float32).reshape(-1, 8)
            if self.encoding_method == "thetaobb":
                out = []
                for p in rb:
                    (x, y), (w, h), theta = min_area_rect(
                        np.round(p).astype(np.int64).reshape(4, 2))
                    out.append([x, y, w, h, theta])
                results[key] = np.asarray(out, np.float32).reshape(-1, 5)
            elif self.encoding_method == "hobb":
                out = []
                for p in rb:
                    s = self._best_point_sort(p)
                    h = float(np.hypot(s[6] - s[0], s[7] - s[1]))
                    out.append([s[0], s[1], s[2], s[3], h])
                results[key] = np.asarray(out, np.float32).reshape(-1, 5)
        return results


@PIPELINES.register_module()
class RandomCenterCropPad:
    """CornerNet's random centre crop with padding around.  Train mode: up
    to 50 tries, each drawing from ``results['_rng']`` a ratio (of
    ``ratios``, times ``crop_size``) and a centre away from the borders
    (``randint`` x, then y); the image pasted on a mean-filled canvas of
    that size; boxes whose centre falls in the pasted patch kept (with
    their labels, offsets and polygons), shifted and clipped; a try that
    keeps no box of an image that has some is redrawn.  Test mode: the
    image centred on a canvas of ``logical_or``-padded (or
    ``size_divisor``-rounded) size.  Both record ``border``."""

    def __init__(self, crop_size=None, ratios=(0.9, 1.0, 1.1), border=128,
                 mean=(0, 0, 0), std=None, to_rgb=None, test_mode=False,
                 test_pad_mode=("logical_or", 127)):
        self.crop_size = crop_size
        self.ratios = ratios
        self.border = border
        self.mean = list(mean)[::-1] if to_rgb else list(mean)
        self.test_mode = test_mode
        self.test_pad_mode = test_pad_mode

    @staticmethod
    def _get_border(border, size):
        k = 2 * border / size
        i = 2 ** (np.ceil(np.log2(np.ceil(k))) + (k == int(k)))
        return int(border // i)

    def _paste(self, img, cy, cx, th, tw):
        h, w = img.shape[:2]
        x0, x1 = max(0, cx - tw // 2), min(cx + tw // 2, w)
        y0, y1 = max(0, cy - th // 2), min(cy + th // 2, h)
        canvas = np.empty((th, tw, img.shape[2]), img.dtype)
        canvas[...] = np.asarray(self.mean, img.dtype)
        ccy, ccx = th // 2, tw // 2
        top, bottom = cy - y0, y1 - cy
        left, right = cx - x0, x1 - cx
        canvas[ccy - top:ccy + bottom, ccx - left:ccx + right] = \
            img[y0:y1, x0:x1]
        border = np.array([ccy - top, ccy + bottom, ccx - left,
                           ccx + right], np.float32)
        return canvas, border, (x0, y0, x1, y1), (ccx - left - x0,
                                                  ccy - top - y0)

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        if self.test_mode:
            mode, value = self.test_pad_mode
            if mode == "logical_or":
                th, tw = h | value, w | value
            else:
                th = int(np.ceil(h / value) * value)
                tw = int(np.ceil(w / value) * value)
            results["img"], results["border"], _, _ = self._paste(
                img, h // 2, w // 2, th, tw)
            results["img_shape"] = (th, tw)
            return results
        rng = results.setdefault("_rng", np.random.RandomState())
        boxes = results.get("gt_bboxes", np.zeros((0, 4), np.float32))
        for _ in range(50):
            scale = self.ratios[rng.randint(len(self.ratios))]
            th = int(self.crop_size[0] * scale)
            tw = int(self.crop_size[1] * scale)
            hb = self._get_border(self.border, h)
            wb = self._get_border(self.border, w)
            cx = rng.randint(wb, max(w - wb, wb + 1))
            cy = rng.randint(hb, max(h - hb, hb + 1))
            canvas, border, patch, (sx, sy) = self._paste(img, cy, cx, th,
                                                          tw)
            ctr = (boxes[:, :2] + boxes[:, 2:]) / 2
            keep = ((ctr[:, 0] > patch[0]) & (ctr[:, 1] > patch[1])
                    & (ctr[:, 0] < patch[2]) & (ctr[:, 1] < patch[3]))
            if len(boxes) and not keep.any():
                continue
            results["img"] = canvas
            results["img_shape"] = (th, tw)
            results["border"] = border
            if len(boxes):
                b = boxes[keep] + np.array([sx, sy, sx, sy], np.float32)
                b[:, 0::2] = b[:, 0::2].clip(0, tw)
                b[:, 1::2] = b[:, 1::2].clip(0, th)
                results["gt_bboxes"] = b
                for key in ("gt_labels", "gt_offsets"):
                    if key in results and len(results[key]):
                        results[key] = results[key][keep]
                if "gt_masks" in results:
                    shift = np.array([sx, sy], np.float32)
                    results["gt_masks"] = [
                        [p + shift for p in inst]
                        for inst, k in zip(results["gt_masks"], keep) if k]
            return results
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter of the BGR image,
    each applied when a ``randint(2)`` draw of ``results['_rng']`` says
    so, in the JAX transform's order of draws; the image always makes the
    round trip through uint8 HSV (``utils/color.py``, cv2's rounding)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results):
        rng = results.setdefault("_rng", np.random.RandomState())
        img = results["img"].astype(np.float32)
        if rng.randint(2):
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        if rng.randint(2):
            img *= rng.uniform(*self.contrast_range)
        hsv = bgr_to_hsv(img.clip(0, 255).astype(np.uint8)).astype(
            np.float32)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(*self.saturation_range)
        if rng.randint(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_delta,
                                                     self.hue_delta)) % 180
        results["img"] = hsv_to_bgr(hsv.clip(0, 255).astype(
            np.uint8)).astype(np.float32)
        return results


@PIPELINES.register_module()
class Normalize:
    """BGR -> RGB, then ``(x - mean) / std``.  With ``device=True`` the
    host only flips the channels; the train step normalises on the card
    (the image crosses to the card as ``uint8``)."""

    def __init__(self, mean, std, to_rgb=True, device=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb
        self.device = device

    def __call__(self, results):
        img = results["img"]
        if self.to_rgb:
            img = np.ascontiguousarray(img[..., ::-1])
        if not self.device:
            img = img.astype(np.float32)
            img -= self.mean
            img /= self.std
        results["img"] = img
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb,
                                       device=self.device)
        return results


@PIPELINES.register_module()
class Pad:
    """Zero padding at the bottom and right, to ``size`` or to a multiple
    of ``size_divisor``; the dense maps are zero-padded to the same
    canvas."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-h // d) * d, -(-w // d) * d
        if (th, tw) != (h, w):
            img = np.pad(img, ((0, th - h), (0, tw - w), (0, 0)),
                         constant_values=self.pad_val)
        results["img"] = img
        results["pad_shape"] = (th, tw)
        for group in MAP_FIELDS:
            for key in results.get(group, []):
                m = results[key]
                mh, mw = m.shape[:2]
                if (th, tw) != (mh, mw):
                    pad = [(0, th - mh), (0, tw - mw)] + [(0, 0)] * (
                        m.ndim - 2)
                    results[key] = np.pad(m, pad, constant_values=0)
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """No-op kept for config parity (the loader packs the arrays)."""

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """No-op kept for config parity (the loader stacks the images)."""

    def __init__(self, keys=("img",)):
        self.keys = keys

    def __call__(self, results):
        return results


@PIPELINES.register_module()
class Collect:
    """Selects ``keys`` and the meta keys; a missing key is warned about
    and dropped, as in the JAX package."""

    DEFAULT_META = ("filename", "ori_shape", "img_shape", "pad_shape",
                    "scale_factor", "flip", "flip_direction")
    GT_KEYS = ("gt_bboxes", "gt_labels", "gt_masks", "gt_offsets",
               "gt_footprint_bboxes", "gt_only_footprint_flag",
               "gt_building_heights", "gt_angle", "gt_edge_maps",
               "gt_side_face_maps", "gt_offset_field")

    def __init__(self, keys, meta_keys=None):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys or self.DEFAULT_META)

    def __call__(self, results):
        out = {}
        for k in self.keys:
            if k in results:
                out[k] = results[k]
            else:
                warnings.warn(
                    f"Collect: key '{k}' not produced by the pipeline "
                    "(check the LoadAnnotations with_* flags)")
        out["img_metas"] = {m: results.get(m) for m in self.meta_keys}
        for m in self.meta_keys:
            out.setdefault(m, results.get(m))
        for k in self.GT_KEYS:
            if k in results and k not in out:
                out[k] = results[k]
        out["img"] = results["img"]
        return out


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """The test pipeline's wrapper: runs ``transforms`` once, on the base
    view, the first ``img_scale`` unflipped, as the JAX step does.  The
    views it declares (:meth:`tta_cfg`) are made from that base view on
    the device by test-time augmentation (``apis/test.py``)."""

    def __init__(self, transforms, img_scale=None, flip=False,
                 flip_direction="horizontal", scale_factors=None):
        self.transforms = build_pipeline(transforms)
        scales = img_scale if isinstance(img_scale, (list, tuple)) and \
            img_scale and isinstance(img_scale[0], (list, tuple)) \
            else ([img_scale] if img_scale else [])
        self.img_scales = [tuple(s) for s in scales]
        self.img_scale = self.img_scales[0] if self.img_scales else None
        self.flip = flip
        self.flip_direction = (list(flip_direction)
                               if isinstance(flip_direction, (list, tuple))
                               else [flip_direction])
        self.scale_factors = scale_factors

    def tta_cfg(self):
        """The declared views: relative scales, flip and directions."""
        if self.scale_factors is not None:
            factors = list(self.scale_factors)
        elif len(self.img_scales) > 1:
            base = max(s[0] * s[1] for s in self.img_scales) ** 0.5
            factors = sorted({round((s[0] * s[1]) ** 0.5 / base, 4)
                              for s in self.img_scales}, reverse=True)
        else:
            factors = [1.0]
        return dict(scales=factors, flip=self.flip,
                    flip_directions=self.flip_direction)

    def __call__(self, results):
        results["scale"] = tuple(self.img_scale) if self.img_scale else None
        results["flip"] = False
        results["flip_direction"] = None
        return self.transforms(results)
