"""Anchor generation (counterpart of ``bonai_tpu/core/anchors.py``
``AnchorGenerator``, ``SSDAnchorGenerator``, ``LegacySSDAnchorGenerator``
and ``RAnchorGenerator``).  Anchors depend only on the feature-map sizes, so
they are built in numpy and moved to the device by the caller."""

from __future__ import annotations

import numpy as np


class AnchorGenerator:
    def __init__(self, strides, ratios, scales=None, base_sizes=None,
                 scale_major=True, octave_base_scale=None,
                 scales_per_octave=None, centers=None, center_offset=0.):
        self.strides = [(s, s) if isinstance(s, (int, float)) else tuple(s)
                        for s in strides]
        self.base_sizes = ([min(s) for s in self.strides]
                           if base_sizes is None else list(base_sizes))
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave_scales = np.array(
                [2 ** (i / scales_per_octave) for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale).astype(np.float32)
        else:
            raise ValueError("either scales or octave_base_scale+scales_per_"
                             "octave must be set")
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.centers = centers
        self.center_offset = center_offset
        self.base_anchors = [
            self._single_level_base_anchors(
                size, None if centers is None else centers[i])
            for i, size in enumerate(self.base_sizes)]

    @property
    def num_levels(self):
        return len(self.strides)

    def _single_level_base_anchors(self, base_size, center=None):
        w = h = float(base_size)
        if center is None:
            x_c, y_c = self.center_offset * w, self.center_offset * h
        else:
            x_c, y_c = center
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                         x_c + 0.5 * ws, y_c + 0.5 * hs], axis=-1)

    def grid_anchors(self, featmap_sizes):
        """List of ``(H*W*A, 4)`` float32 arrays, row-major over (y, x, a)."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{self.num_levels} anchor levels")
        out = []
        for base, (feat_h, feat_w), stride in zip(
                self.base_anchors, featmap_sizes, self.strides):
            shift_x = np.arange(0, feat_w, dtype=np.float32) * stride[0]
            shift_y = np.arange(0, feat_h, dtype=np.float32) * stride[1]
            xx = np.tile(shift_x, feat_h)
            yy = np.repeat(shift_y, feat_w)
            shifts = np.stack([xx, yy, xx, yy], axis=-1)
            out.append((base[None, :, :] + shifts[:, None, :])
                       .reshape(-1, 4).astype(np.float32))
        return out


class RAnchorGenerator(AnchorGenerator):
    """Rotated anchors ``(xc, yc, w, h, theta)``: each level's base
    anchors once per angle of ``angles`` (degrees; ``theta`` in radians),
    ``(A * len(angles), 5)``, and the grid anchors ``(H*W*A*len(angles),
    5)`` row-major over (y, x, anchor), the shifts moving the centres
    only."""

    def __init__(self, *args, angles=(0.0,), **kwargs):
        self.angles = [float(a) for a in angles]
        super().__init__(*args, **kwargs)

    def _single_level_base_anchors(self, base_size, center=None):
        aligned = super()._single_level_base_anchors(base_size, center)
        xc = (aligned[:, 0] + aligned[:, 2]) * 0.5
        yc = (aligned[:, 1] + aligned[:, 3]) * 0.5
        w = aligned[:, 2] - aligned[:, 0]
        h = aligned[:, 3] - aligned[:, 1]
        return np.concatenate([
            np.stack([xc, yc, w, h, np.full_like(xc, np.deg2rad(a))], -1)
            for a in self.angles])

    def grid_anchors(self, featmap_sizes):
        """List of ``(H*W*A, 5)`` float32 arrays."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{self.num_levels} anchor levels")
        out = []
        for base, (feat_h, feat_w), stride in zip(
                self.base_anchors, featmap_sizes, self.strides):
            shift_x = np.arange(0, feat_w, dtype=np.float32) * stride[0]
            shift_y = np.arange(0, feat_h, dtype=np.float32) * stride[1]
            xx = np.tile(shift_x, feat_h)
            yy = np.repeat(shift_y, feat_w)
            zeros = np.zeros_like(xx)
            shifts = np.stack([xx, yy, zeros, zeros, zeros], axis=-1)
            out.append((base[None, :, :] + shifts[:, None, :])
                       .reshape(-1, 5).astype(np.float32))
        return out


def _base_anchors(base_size, scales, ratios, center, scale_major,
                  legacy=False):
    """One level's base anchors (the JAX ``_single_level_base_anchors``,
    or with ``legacy`` mmdetection v1.x's ``size - 1`` corners, rounded)."""
    w = h = float(base_size)
    x_c, y_c = center
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    if scale_major:
        ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
    else:
        ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
    if legacy:
        return np.round(np.stack(
            [x_c - 0.5 * (ws - 1), y_c - 0.5 * (hs - 1),
             x_c + 0.5 * (ws - 1), y_c + 0.5 * (hs - 1)], axis=-1))
    return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                     x_c + 0.5 * ws, y_c + 0.5 * hs], axis=-1)


class SSDAnchorGenerator(AnchorGenerator):
    """SSD's anchors (JAX ``SSDAnchorGenerator``): per level a
    ``min_size``/``max_size`` pair from ``basesize_ratio_range`` (the first
    level a fixed smaller pair), scales ``[1, sqrt(max / min)]``, ratios
    ``[1, 1/r, r, ...]``, centred at half a stride; a level's base
    anchors are ``[min@1, sqrt(min*max)@1, min@1/r, min@r, ...]``, so the
    levels carry 4 or 6 anchors a cell.  ``legacy``: mmdetection v1.x's
    (``LegacySSDAnchorGenerator``: centres at ``(stride - 1) / 2``, the
    ``size - 1`` corners)."""

    def __init__(self, strides, ratios, basesize_ratio_range,
                 input_size=300, scale_major=False, legacy=False):
        self.strides = [(s, s) if isinstance(s, (int, float)) else tuple(s)
                        for s in strides]
        self.input_size = int(input_size)
        off = 1.0 if legacy else 0.0
        self.centers = [((s[0] - off) / 2.0, (s[1] - off) / 2.0)
                        for s in self.strides]
        min_ratio = int(basesize_ratio_range[0] * 100)
        max_ratio = int(basesize_ratio_range[1] * 100)
        step = int(np.floor(max_ratio - min_ratio) / (len(strides) - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(self.input_size * ratio / 100))
            max_sizes.append(int(self.input_size * (ratio + step) / 100))
        head = {(300, 15): (7, 15), (300, 20): (10, 20),
                (512, 10): (4, 10), (512, 15): (7, 15)}.get(
                    (self.input_size, min_ratio),
                    (min_ratio // 2, min_ratio))
        min_sizes.insert(0, int(self.input_size * head[0] / 100))
        max_sizes.insert(0, int(self.input_size * head[1] / 100))
        self.base_sizes = min_sizes[:len(strides)]
        max_sizes = max_sizes[:len(strides)]
        self.scale_major = scale_major
        self.base_anchors = []
        for i, (mn, mx) in enumerate(zip(self.base_sizes, max_sizes)):
            ar = [1.0]
            for r in ratios[i]:
                ar += [1.0 / r, float(r)]
            a = _base_anchors(mn, np.asarray([1.0, np.sqrt(mx / mn)],
                                             np.float32),
                              np.asarray(ar, np.float32), self.centers[i],
                              scale_major, legacy)
            idx = list(range(len(ar)))
            idx.insert(1, len(idx))
            self.base_anchors.append(a[np.asarray(idx)])
