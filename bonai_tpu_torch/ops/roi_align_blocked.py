"""The blocked RoIAlign (``roi_align_impl='blocked'``) in plain PyTorch.

Counterpart of ``bonai_tpu.ops.roi_align_blocked.multilevel_roi_align_blocked``,
an XLA formulation of the JAX package (no Pallas kernel, so no CUDA kernel
here): it fetches each sample row's x-window as aligned blocks of ``gcd(32,
level widths)`` cells, 96 cells in all, and contracts one-hot x weights in
the feature dtype.  What that computes, and this module with it
(``window_corner_plan``): the gather level rule; a sample outside the level
in y keeps full weight on its clamped row (``ly = 0``); an x corner 96 or
more cells past the RoI's block-aligned window start counts zero; the x
weights are rounded to the feature dtype.  When a level width is not a
multiple of 8 the JAX function falls back to the gather RoIAlign, and so
does this one.  Runs on any device; autograd gives its gradient.
"""

from __future__ import annotations

import math

import torch

from .roi_align import (flatten_levels, map_roi_levels, multilevel_roi_align,
                        pool_corners, window_corner_plan)

TARGET_WINDOW = 96      # cells of the x window


def roi_align_blocked(levels, rois, output_size, featmap_strides,
                      sampling_ratio=2, aligned=True, finest_scale=56,
                      roi_valid=None):
    """Multi-level blocked RoIAlign (same contract as
    :func:`~.roi_align.multilevel_roi_align`).  Returns ``(R, oh, ow, C)``
    in the levels' dtype, float32 sums."""
    levels = list(levels[:len(featmap_strides)])
    # the JAX function's blocks must tile every level row; it also checks
    # that they tile its flat buffer, which then always holds
    block = math.gcd(32, *(int(f.shape[2]) for f in levels))
    if block < 8:
        return multilevel_roi_align(levels, rois, output_size,
                                    featmap_strides, sampling_ratio, aligned,
                                    finest_scale, roi_valid)
    xblocks = max(TARGET_WINDOW // block, 2)
    lvl = map_roi_levels(rois[:, 1:5].float(), len(featmap_strides),
                         finest_scale)

    def start(x0min, Wl):
        first = torch.div(x0min, block, rounding_mode="floor")
        last = (torch.div(Wl, block, rounding_mode="floor")
                - xblocks).clamp(min=0).float()
        return torch.minimum(first, last) * block
    corners, weights = window_corner_plan(
        [f.shape for f in levels], rois, lvl, output_size, featmap_strides,
        sampling_ratio, aligned, start, block * xblocks,
        weight_dtype=levels[0].dtype)
    out = pool_corners(flatten_levels(levels), corners, weights, output_size,
                       sampling_ratio)
    if roi_valid is not None:
        out = out * roi_valid.to(out.dtype)[:, None, None, None]
    return out.to(levels[0].dtype)
