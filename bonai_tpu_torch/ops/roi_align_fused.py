"""Multi-level RoIAlign with the strip level rule, the detector's
``roi_align_impl='pallas'``: its plain PyTorch version, and on the card the
block RoIAlign's kernels (``csrc/roi_align_block_fwd.cu`` forward,
``csrc/roi_align_block_bwd.cu`` backward) under the strip rule.

Counterpart of
``bonai_tpu.ops.pallas_roi_align_fused.pallas_multilevel_roi_align`` and
its custom VJP.  The level rule is the gather rule
(``floor(log2(sqrt(wh)/56))``) with the strip kernel's push: an RoI whose
x-extent spans more than ``window - 4`` cells at its level moves coarser
until it fits (``_plan`` there).  The function is the RoIAlign of
``roi_align_block`` at those levels, so the port keeps one kernel pair for
both: the forward kernel computes the strip rule itself, in the float
operations torch performs for :func:`strip_levels` on the card, and saves
each RoI's level for the backward.  The plain version and the CPU path take
:func:`strip_levels`.

``chunk=`` and ``chains=`` of the JAX function are not ported: they are
limits of the TPU (the RoI chunking keeps the scalar-prefetched plan in
SMEM; the K chains overlap the backward's DMA round trips) and change
nothing in what is computed.

``roi_align_fused`` takes the plain version for tensors on the CPU; for
CUDA tensors it launches the forward kernel and, where the levels require
a gradient, the backward kernel (``backward="rmw"``), through the custom
ops of ``roi_align_block.py`` under the strip rule, or raises; its own
counters (``roi_align_fused.launches``,
``roi_align_fused_backward.launches``) count those launches.
``backward="scatter"`` (the JAX package's XLA scatter transpose,
accumulating in the feature dtype) is plain torch on both devices.  The
RoIs get no gradient.
"""

from __future__ import annotations

import torch

from .roi_align import (_as_pair, corner_plan, map_roi_levels,
                        roi_align_at_levels, scatter_corners)
from .roi_align_block import (STRIP_RULE, _check_inputs,
                              roi_align_levels,
                              roi_align_levels_backward_op,
                              roi_align_levels_op)

_BACKWARDS = ("rmw", "scatter")


def strip_levels(boxes, featmap_strides, finest_scale=56, window=40):
    """Level per RoI under the strip rule: the gather rule, then pushed
    coarser until the x-extent spans at most ``window - 4`` cells."""
    num_levels = len(featmap_strides)
    lvl = map_roi_levels(boxes, num_levels, finest_scale)
    w = boxes[:, 2] - boxes[:, 0]
    # a device tensor: CUDA divides by a host scalar as a multiplication by
    # its reciprocal, which can move `need` off an exact power of two
    need = w / w.new_tensor(float(featmap_strides[0]) * (window - 4))
    lvl_min = torch.ceil(torch.log2(need.clamp(min=1e-9))).long()
    return torch.maximum(lvl, lvl_min).clamp(0, num_levels - 1)


def roi_align_fused_ref(levels, rois, output_size, featmap_strides,
                        sampling_ratio=2, aligned=True, finest_scale=56,
                        roi_valid=None, window=40):
    """Plain PyTorch version of the kernels: the strip level rule, the
    RoIAlign of :func:`~.roi_align.roi_align_at_levels` (float32 sums,
    output in the levels' dtype); autograd gives its gradient."""
    lvl = strip_levels(rois[:, 1:5].float(), featmap_strides, finest_scale,
                       window)
    return roi_align_at_levels(levels, rois, lvl, output_size,
                               featmap_strides, sampling_ratio, aligned,
                               roi_valid)


def roi_align_fused_backward(grad_out, shapes, featmap_strides, rois, lvl,
                             roi_valid, sampling_ratio=2):
    """Gradient of the strip RoIAlign with respect to its levels: on CUDA
    launches the backward kernel at the strip levels
    (``roi_align_fused_backward.launches`` counts its launches).  Arguments
    and result as :func:`~.roi_align_block.roi_align_block_backward`: one
    ``(B, Hl, Wl, C)`` gradient per level in ``grad_out``'s dtype, summed
    in float32 and rounded once."""
    return roi_align_levels_backward_op(
        grad_out, [int(d) for s in shapes for d in s],
        [float(s) for s in featmap_strides], rois, lvl, roi_valid,
        int(sampling_ratio), STRIP_RULE)


roi_align_fused_backward.launches = 0


def strip_scatter_backward(grad_out, shapes, featmap_strides, rois, lvl,
                           roi_valid, sampling_ratio=2):
    """The ``backward="scatter"`` gradient: the transpose of the corner
    gather at the same levels, summed in ``grad_out``'s dtype with
    ``index_add_`` (``scatter_corners``).  Returns one ``(B, Hl, Wl, C)``
    gradient per level."""
    corners, weights = corner_plan(shapes, rois, lvl, grad_out.shape[1:3],
                                   featmap_strides, sampling_ratio, True,
                                   roi_valid)
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    dflat = scatter_corners(grad_out, sum(sizes), corners, weights,
                            sampling_ratio, grad_out.dtype)
    return [g.reshape(s) for g, s in zip(dflat.split(sizes), shapes)]


class _RoIAlignScatter(torch.autograd.Function):
    """The strip RoIAlign under ``backward="scatter"``: the forward of
    :func:`~.roi_align_block.roi_align_levels_op` (the forward kernel on
    CUDA, which computes each RoI's strip level; the plain version on the
    CPU), the backward :func:`strip_scatter_backward` at those levels."""

    @staticmethod
    def forward(ctx, rois, roi_valid, output_size, featmap_strides,
                sampling_ratio, finest_scale, window, *levels):
        out, lvl = roi_align_levels_op(
            list(levels), rois, roi_valid, list(output_size),
            [float(s) for s in featmap_strides], sampling_ratio, STRIP_RULE,
            finest_scale, window, any(ctx.needs_input_grad[7:]))
        ctx.save_for_backward(rois, lvl, roi_valid)
        ctx.shapes = [tuple(f.shape) for f in levels]
        ctx.strides = featmap_strides
        ctx.sampling_ratio = sampling_ratio
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, lvl, roi_valid = ctx.saved_tensors
        grads = strip_scatter_backward(grad_out, ctx.shapes, ctx.strides,
                                       rois, lvl, roi_valid,
                                       ctx.sampling_ratio)
        return (None,) * 7 + tuple(grads)


def roi_align_fused(levels, rois, output_size, featmap_strides,
                    sampling_ratio=2, aligned=True, finest_scale=56,
                    roi_valid=None, window=40, backward="rmw"):
    """Multi-level RoIAlign, strip level rule.

    Args:
      levels: list of ``(B, Hl, Wl, C)`` contiguous NHWC maps (float32 or
        bfloat16), one per stride.
      rois: ``(R, 5)`` float32 ``[batch_idx, x1, y1, x2, y2]``.
      roi_valid: optional ``(R,)`` bool; invalid rows come out as zeros.
      window: the strip width of the JAX kernel; an RoI is pushed coarser
        until its x-extent spans at most ``window - 4`` cells.
      backward: ``"rmw"`` (the backward kernel on CUDA) or ``"scatter"``
        (plain torch, sums in the levels' dtype).

    Returns ``(R, oh, ow, C)`` in the levels' dtype.  CUDA tensors go to
    the forward kernel (``roi_align_fused.launches`` counts its launches);
    CPU tensors go to :func:`roi_align_fused_ref` (with
    ``backward="scatter"``, to its forward under the scatter backward).
    """
    if backward not in _BACKWARDS:
        raise ValueError(f"backward must be one of {_BACKWARDS}, got "
                         f"{backward!r}")
    device = levels[0].device
    if device.type == "cpu" and backward == "rmw":
        return roi_align_fused_ref(levels, rois, output_size,
                                   featmap_strides, sampling_ratio, aligned,
                                   finest_scale, roi_valid, window)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_fused runs on cuda or cpu, not {device}")
    num_levels = len(featmap_strides)
    if device.type == "cuda":
        _check_inputs(levels, rois, roi_valid, num_levels, aligned,
                      sampling_ratio, "roi_align_fused")
    elif not aligned:
        raise ValueError("roi_align_fused computes aligned=True only")
    if backward == "rmw":
        return roi_align_levels(levels[:num_levels], rois, output_size,
                                featmap_strides, sampling_ratio, STRIP_RULE,
                                finest_scale, window, roi_valid)
    if roi_valid is not None:
        roi_valid = roi_valid.contiguous()
    return _RoIAlignScatter.apply(rois, roi_valid, _as_pair(output_size),
                                  tuple(featmap_strides), int(sampling_ratio),
                                  int(finest_scale), int(window),
                                  *levels[:num_levels])


roi_align_fused.launches = 0
