"""The forward-only window-64 strip RoIAlign: on the card the RoIAlign
forward kernel (``csrc/roi_align_block_fwd.cu``) in its window-64 mode, and
its plain PyTorch version.

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

from .roi_align import (_as_pair, _level_samples, flatten_levels,
                        map_roi_levels, pool_corners, window_corner_plan)
from .roi_align_block import WINDOW64_RULE, _check_inputs, launch_forward

_WINDOW = 64            # kWindow64 in csrc/roi_align_block_fwd.cu


def gather_levels(boxes, featmap_strides, finest_scale=56):
    """Level per RoI under the window-64 route's rule: the gather rule, no
    push (the signature of ``block_levels`` and ``strip_levels``)."""
    return map_roi_levels(boxes, len(featmap_strides), finest_scale)


def strip_corner_plan(shapes, rois, output_size, featmap_strides,
                      sampling_ratio=2, aligned=True, finest_scale=56):
    """The kernel's corners and weights (``window_corner_plan`` at the
    gather levels, the window starting at ``min(min x0, max(Wl-64,
    0))``) for levels of ``shapes``; no validity gate."""
    lvl = gather_levels(rois[:, 1:5].float(), featmap_strides, finest_scale)

    def start(x0min, Wl):
        return torch.minimum(x0min, (Wl - _WINDOW).clamp(min=0).float())
    return window_corner_plan(shapes, rois, lvl, output_size,
                              featmap_strides, sampling_ratio, aligned,
                              start, _WINDOW)


def _bin_lists(lo, hi, w_lo, w_hi, sr):
    """Per bin of one axis, the distinct cells among its samples' corners
    of nonzero weight and their summed weights, in sample order (low corner
    before high): ``(cells, weights, count)``, the first two ``(R, bins,
    2*sr)`` padded with cell -1 and weight 0."""
    R, n = lo.shape[0], lo.shape[1] // sr
    cand = torch.stack([lo, hi], -1).reshape(R, n, 2 * sr)
    wts = torch.stack([w_lo, w_hi], -1).reshape(R, n, 2 * sr)
    cells = torch.full_like(cand, -1)
    weights = torch.zeros_like(wts)
    count = torch.zeros((R, n), dtype=torch.long, device=lo.device)
    slots = torch.arange(2 * sr, device=lo.device)
    for k in range(2 * sr):
        c, w = cand[..., k, None], wts[..., k, None]
        live = w != 0
        match = (cells == c) & live
        weights = torch.where(match, weights + w, weights)
        new = live & ~match.any(-1, keepdim=True)
        slot = new & (slots == count[..., None])
        cells = torch.where(slot, c, cells)
        weights = torch.where(slot, w, weights)
        count = count + new[..., 0]
    return cells, weights, count


def strip_bin_lists(shapes, rois, output_size, featmap_strides,
                    sampling_ratio=2, finest_scale=56):
    """The forward kernel's per-bin lists in its window-64 mode, for levels
    of ``shapes`` (``bin_cells`` in ``csrc/roi_align_block_fwd.cu``).

    Returns a dict: ``lvl``, each RoI's gather level; ``start``, its x
    window start, ``min(x0, max(Wl - 64, 0))`` of the first and the last x
    sample only (``x0`` is monotone in the sample coordinate, which is
    monotone in the sample index); ``y`` and ``x``, per bin of each axis
    ``(cells, weights, count)`` as :func:`_bin_lists` gives them (cells
    as rows y and columns x of the level).  Along y a sample outside
    ``[-1, Hl]`` keeps weight 1 on its clamped low row; along x a sample
    outside ``[-1, Wl]`` counts zero, and so does a corner 64 or more cells
    past the window start.  No validity gate."""
    sr = max(int(sampling_ratio), 1)
    lvl = gather_levels(rois[:, 1:5].float(), featmap_strides, finest_scale)
    _, Hl, Wl, ys, xs = _level_samples(shapes, rois, lvl, output_size,
                                       featmap_strides, sr, True)

    def axis(v, size):
        size = size.float()[:, None]
        outside = (v < -1.0) | (v > size)
        c = torch.minimum(v.clamp(min=0.0), size - 1.0)
        lo = torch.minimum(torch.floor(c), (size - 2.0).clamp(min=0.0))
        hi = torch.minimum(lo + 1.0, size - 1.0)
        return lo.long(), hi.long(), c - lo, outside

    y0, y1, fy, out_y = axis(ys, Hl)
    x0, x1, fx, out_x = axis(xs, Wl)
    start = torch.minimum(torch.minimum(x0[:, 0], x0[:, -1]),
                          (Wl - _WINDOW).clamp(min=0))
    e0 = x0 - start[:, None]
    return {
        "lvl": lvl, "start": start,
        "y": _bin_lists(y0, y1, torch.where(out_y, 1.0, 1.0 - fy),
                        torch.where(out_y, 0.0, fy), sr),
        "x": _bin_lists(x0, x1,
                        torch.where(out_x | (e0 >= _WINDOW), 0.0, 1.0 - fx),
                        torch.where(out_x | (e0 + 1 >= _WINDOW), 0.0, fx),
                        sr)}


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
    ow, C)`` in the levels' dtype.  CUDA tensors go to the forward kernel
    in its window-64 mode (``roi_align_strip.launches`` counts its
    launches), CPU tensors to :func:`roi_align_strip_ref`; levels that
    require a gradient raise.
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
                  sampling_ratio, "roi_align_strip")
    if roi_valid is not None:
        roi_valid = roi_valid.contiguous()
    out, _ = launch_forward(levels[:num_levels], rois, roi_valid,
                            _as_pair(output_size), featmap_strides,
                            int(sampling_ratio), WINDOW64_RULE,
                            int(finest_scale), _WINDOW, want_levels=False)
    roi_align_strip.launches += bool(rois.shape[0])
    return out


roi_align_strip.launches = 0
