"""The forward-only window-64 strip RoIAlign: the CUDA kernel
(``csrc/roi_align_strip_fwd.cu``) and its plain PyTorch version.

Counterpart of ``bonai_tpu.ops.pallas_roi_align.pallas_roi_align``, the
``pallas`` impl of the RoIAlign micro-benchmark
(``bonai_tpu_torch/tools/bench_roi_align.py``); no detector selects it.  It
keeps the gather level rule (no push) and computes what that Pallas kernel
computes, which is not quite RoIAlign (``window_corner_plan``): a sample
outside the level in y keeps full weight on its clamped row, and an x
corner 64 or more cells past the RoI's window start counts zero (a wide,
flat RoI kept at level 0 loses its right-hand samples).  ``roi_valid``
multiplies the output.

The JAX function has no gradient (its docstring promises one, but the
``pallas_call`` has no VJP), so neither has this one: ``roi_align_strip``
raises when a level requires a gradient.  CPU tensors go to the plain
version, CUDA tensors to the kernel, or it raises.
"""

from __future__ import annotations

import torch

from .roi_align import (_as_pair, flatten_levels, map_roi_levels,
                        pool_corners, window_corner_plan)
from .roi_align_block import _check_inputs, _launch

_MAX_SR = 4             # kMaxSr in csrc/roi_align_strip_common.cuh
_WINDOW = 64            # kWindow of StripRule in the CUDA source


def strip_corner_plan(shapes, rois, output_size, featmap_strides,
                      sampling_ratio=2, aligned=True, finest_scale=56):
    """The kernel's corners and weights (``window_corner_plan`` at the
    gather levels, the window starting at ``min(min x0, max(Wl-64,
    0))``) for levels of ``shapes``; no validity gate."""
    lvl = map_roi_levels(rois[:, 1:5].float(), len(featmap_strides),
                         finest_scale)

    def start(x0min, Wl):
        return torch.minimum(x0min, (Wl - _WINDOW).clamp(min=0).float())
    return window_corner_plan(shapes, rois, lvl, output_size,
                              featmap_strides, sampling_ratio, aligned,
                              start, _WINDOW)


def roi_align_strip_ref(levels, rois, output_size, featmap_strides,
                        sampling_ratio=2, aligned=True, finest_scale=56,
                        roi_valid=None):
    """Plain PyTorch version of the kernel: the gather level rule, the
    window-64 border rule of ``window_corner_plan``, float32 sums, output
    in the levels' dtype times ``roi_valid``."""
    levels = list(levels[:len(featmap_strides)])
    corners, weights = strip_corner_plan(
        [f.shape for f in levels], rois, output_size, featmap_strides,
        sampling_ratio, aligned, finest_scale)
    out = pool_corners(flatten_levels(levels), corners, weights, output_size,
                       sampling_ratio).to(levels[0].dtype)
    if roi_valid is not None:
        out = out * roi_valid.to(out.dtype)[:, None, None, None]
    return out


def roi_align_strip(levels, rois, output_size, featmap_strides,
                    sampling_ratio=2, aligned=True, finest_scale=56,
                    roi_valid=None):
    """Window-64 strip RoIAlign, forward only.

    Args as :func:`~.roi_align_fused.roi_align_fused`.  Returns ``(R, oh,
    ow, C)`` in the levels' dtype.  CUDA tensors go to the kernel
    (``roi_align_strip.launches`` counts its launches), CPU tensors to
    :func:`roi_align_strip_ref`; levels that require a gradient raise.
    """
    num_levels = len(featmap_strides)
    if torch.is_grad_enabled() and any(f.requires_grad
                                       for f in levels[:num_levels]):
        raise RuntimeError("roi_align_strip is not differentiable (nor is "
                           "the JAX pallas_roi_align it ports)")
    device = levels[0].device
    if device.type == "cpu":
        return roi_align_strip_ref(levels, rois, output_size,
                                   featmap_strides, sampling_ratio, aligned,
                                   finest_scale, roi_valid)
    if device.type != "cuda":
        raise ValueError(f"roi_align_strip runs on cuda or cpu, not {device}")
    _check_inputs(levels, rois, roi_valid, num_levels, aligned,
                  sampling_ratio, "roi_align_strip", _MAX_SR)
    lvl = map_roi_levels(rois[:, 1:5], num_levels,
                         finest_scale).to(torch.int32)
    if roi_valid is None:
        roi_valid = torch.ones(rois.shape[0], dtype=torch.bool, device=device)
    output_size = _as_pair(output_size)
    levels = levels[:num_levels]
    out = torch.empty((rois.shape[0], *output_size, levels[0].shape[-1]),
                      dtype=levels[0].dtype, device=device)
    _launch("roi_align_strip_fwd", [f.data_ptr() for f in levels],
            [tuple(f.shape) for f in levels], featmap_strides, rois, lvl,
            roi_valid, output_size, int(sampling_ratio), levels[0].dtype, out)
    roi_align_strip.launches += 1
    return out


roi_align_strip.launches = 0
