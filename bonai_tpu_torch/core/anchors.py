"""Anchor generation (counterpart of ``bonai_tpu/core/anchors.py``
``AnchorGenerator``).  Anchors depend only on the feature-map sizes, so
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
