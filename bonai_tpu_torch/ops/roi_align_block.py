"""Multi-level RoIAlign with the block level rule: the CUDA kernels
(``csrc/roi_align_block_fwd.cu`` forward, ``csrc/roi_align_block_bwd.cu``
backward) and their plain PyTorch version.

Counterpart of ``bonai_tpu.ops.pallas_roi_align_block.pallas_block_roi_align``
and its custom VJP.  The level rule is the gather rule
(``floor(log2(sqrt(wh)/56))``) with the block kernel's symmetric push: an
RoI whose larger extent spans more than ``window - 4`` cells at its level
moves coarser until it fits (``_block_plan`` there).  The plain version
takes it from :func:`block_levels`; on the card the forward kernel computes
it itself, in the float operations torch performs for
:func:`block_levels` there, and saves it for the backward.  The same two
kernels compute the strip route (``roi_align_fused``) under the strip rule,
and the forward kernel the window-64 route (``roi_align_strip``).

``roi_align_block`` takes the plain version only for tensors on the CPU
(autograd differentiates it there); for CUDA tensors it calls the custom
op ``bonai_tpu_torch::roi_align_levels`` (:func:`roi_align_levels_op`),
which launches the forward kernel, and whose registered gradient,
``bonai_tpu_torch::roi_align_levels_backward``, launches the backward
kernel, or raises.  Both ops have fake implementations of their output
shapes, so ``torch.export`` traces a detector through them and the
exported program launches the kernels.  The RoIs get no gradient (the
detector's RoIs are sampled proposals, constants of the step).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from .roi_align import (_as_pair, _level_samples, corner_plan,
                        map_roi_levels, roi_align_at_levels, scatter_corners)

_MAX_LEVELS = 4         # kMaxLevels in the CUDA source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WINDOW = 32            # the block rule's window: max(w, h) fits 28 cells
# the forward kernel's level_rule: block, strip, or the window-64 mode (the
# gather rule and the window-64 border rule of ``roi_align_strip``)
BLOCK_RULE, STRIP_RULE, WINDOW64_RULE = 0, 1, 2


def block_levels(boxes, featmap_strides, finest_scale=56, window=_WINDOW):
    """Level per RoI under the block rule: the gather rule, then pushed
    coarser until ``max(w, h)`` spans at most ``window - 4`` cells."""
    num_levels = len(featmap_strides)
    lvl = map_roi_levels(boxes, num_levels, finest_scale)
    ext = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    need = ext / (float(featmap_strides[0]) * (window - 4))
    lvl_min = torch.ceil(torch.log2(need.clamp(min=1e-9))).long()
    return torch.maximum(lvl, lvl_min).clamp(0, num_levels - 1)


def roi_align_block_ref(levels, rois, output_size, featmap_strides,
                        sampling_ratio=2, aligned=True, finest_scale=56,
                        roi_valid=None):
    """Plain PyTorch version of the kernel: same level rule, same
    arithmetic, float32 sums, output in the levels' dtype."""
    lvl = block_levels(rois[:, 1:5].float(), featmap_strides, finest_scale)
    return roi_align_at_levels(levels, rois, lvl, output_size,
                               featmap_strides, sampling_ratio, aligned,
                               roi_valid)


def block_footprint(shapes, rois, lvl, output_size, featmap_strides,
                    sampling_ratio=2):
    """The level cells each RoI's samples can touch, at the level ``lvl``
    gives it: ``(R, 4)`` int64 ``[y_lo, y_hi, x_lo, x_hi]``, inclusive.

    The plain version of the backward kernel's tile test
    (``axis_footprint`` in ``csrc/roi_align_block_common.cuh``): the sample
    coordinates are monotone in the sample index and the corners monotone
    in the coordinate, so every corner of every sample lies between the low
    corner of the first or last sample and the high corner of the other."""
    _, Hl, Wl, ys, xs = _level_samples(shapes, rois, lvl, output_size,
                                       featmap_strides, sampling_ratio, True)

    def axis(v, size):
        size = size.float()[:, None]
        ends = torch.stack([v[:, 0], v[:, -1]], 1)
        c = torch.minimum(ends.clamp(min=0.0), size - 1.0)
        i0 = torch.minimum(torch.floor(c), (size - 2.0).clamp(min=0.0)).long()
        hi = torch.minimum(i0.amax(1) + 1, size[:, 0].long() - 1)
        return i0.amin(1), hi
    return torch.stack([*axis(ys, Hl), *axis(xs, Wl)], 1)


_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int
_TABLE = [ctypes.POINTER(_VOID_P), ctypes.POINTER(_INT),
          ctypes.POINTER(_INT), ctypes.POINTER(ctypes.c_float), _INT, _INT,
          _INT, _VOID_P, _INT, _VOID_P]
# the C signatures of csrc/roi_align_block_{fwd,bwd}.cu: the level table,
# batch, channels, RoIs, their count and validity, then
_ARGTYPES = {
    # lvl_out, level_rule, finest_scale, push_extent, out_h, out_w,
    # sampling_ratio, dtype, out, stream
    "roi_align_block_fwd": _TABLE + [_VOID_P, _INT, _INT, ctypes.c_float,
                                     _INT, _INT, _INT, _INT, _VOID_P,
                                     _VOID_P],
    # lvl, out_h, out_w, sampling_ratio, dtype, grad_out, stream
    "roi_align_block_bwd": _TABLE + [_VOID_P, _INT, _INT, _INT, _INT,
                                     _VOID_P, _VOID_P],
}


@functools.cache
def _kernel(name):
    """The C entry point of ``csrc/<name>.cu``, built and bound at first
    use."""
    fn = getattr(load_library(name), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _level_table(shapes, featmap_strides):
    """The kernels' level arguments for levels of ``shapes``, built once
    per set of shapes: heights, widths and inverse strides as ``ctypes``
    arrays, the level count, batch and channels."""
    n = len(shapes)
    return ((_INT * n)(*[s[1] for s in shapes]),
            (_INT * n)(*[s[2] for s in shapes]),
            (ctypes.c_float * n)(*[1.0 / s for s in featmap_strides]),
            n, shapes[0][0], shapes[0][-1])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(name, tensors, shapes, featmap_strides, rois, roi_valid, *args):
    """One call of kernel ``name`` on the current stream; raises on the
    CUDA error it returns."""
    heights, widths, inv, n, B, C = _level_table(shapes, featmap_strides)
    rc = _kernel(name)((_VOID_P * n)(*[t.data_ptr() for t in tensors]),
                       heights, widths, inv, n, B, C, rois.data_ptr(),
                       rois.shape[0], _ptr(roi_valid), *args,
                       torch.cuda.current_stream(rois.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def launch_forward(levels, rois, roi_valid, output_size, featmap_strides,
                   sampling_ratio, level_rule, finest_scale, window,
                   want_levels=True):
    """The forward kernel on CUDA, uncounted: ``(out, lvl)``, the
    ``(R, oh, ow, C)`` output in the levels' dtype and each RoI's level
    (``int32``; ``None`` unless ``want_levels``), which the kernel computes
    under ``level_rule``: ``BLOCK_RULE`` (:func:`block_levels`),
    ``STRIP_RULE`` (:func:`~.roi_align_fused.strip_levels`), both with
    ``finest_scale`` and ``window``, or ``WINDOW64_RULE`` (the gather rule
    :func:`~.roi_align.map_roi_levels`, and the border rule of
    :func:`~.roi_align_strip.roi_align_strip_ref`; ``window`` unused).
    Arguments checked by the caller (``_check_inputs``)."""
    shapes = tuple(tuple(f.shape) for f in levels)
    oh, ow = output_size
    R = rois.shape[0]
    out = torch.empty((R, oh, ow, shapes[0][-1]), dtype=levels[0].dtype,
                      device=rois.device)
    lvl = (torch.empty(R, dtype=torch.int32, device=rois.device)
           if want_levels else None)
    if R:
        _call("roi_align_block_fwd", levels, shapes, tuple(featmap_strides),
              rois, roi_valid, _ptr(lvl), int(level_rule),
              int(finest_scale), float(featmap_strides[0]) * (window - 4),
              oh, ow, int(sampling_ratio), _DTYPE_CODES[levels[0].dtype],
              out.data_ptr())
    return out, lvl


def _check_inputs(levels, rois, roi_valid, num_levels, aligned,
                  sampling_ratio, name="roi_align_block"):
    """Raises on what the kernels of ``name`` do not take."""
    if not 1 <= num_levels <= _MAX_LEVELS or len(levels) < num_levels:
        raise ValueError(f"{name} takes 1..{_MAX_LEVELS} levels, "
                         f"got {len(levels)} maps for {num_levels} strides")
    if not aligned:
        raise ValueError(f"{name} computes aligned=True only")
    if int(sampling_ratio) < 1:
        raise ValueError("sampling_ratio must be >= 1")
    dev, dtype = levels[0].device, levels[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 "
                        f"levels, got {dtype}")
    B, C = levels[0].shape[0], levels[0].shape[-1]
    for f in levels[:num_levels]:
        if f.device != dev or f.dtype != dtype:
            raise ValueError("all levels must share one device and dtype")
        if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"levels must be (B, H, W, C) with one B and "
                             f"C, got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError("levels must be contiguous NHWC tensors")
    if C % 2:
        raise ValueError(f"{name} needs an even channel count, got {C}")
    if (rois.device != dev or rois.dtype != torch.float32 or rois.dim() != 2
            or rois.shape[1] != 5 or not rois.is_contiguous()):
        raise ValueError("rois must be a contiguous float32 (R, 5) tensor "
                         "on the levels' device")
    if roi_valid is not None and (roi_valid.device != dev
                                  or roi_valid.dtype != torch.bool
                                  or roi_valid.shape != rois.shape[:1]):
        raise ValueError("roi_valid must be a bool (R,) tensor on the "
                         "levels' device")


def _check_aligned(levels):
    """Raises on levels the kernels cannot read 8 bytes at a time (checked
    in the op's body: a traced graph's fake tensors have no address)."""
    if any(f.data_ptr() % 8 for f in levels):
        raise ValueError("levels must be 8-byte aligned")


def launch_backward(grad_out, shapes, featmap_strides, rois, lvl,
                    roi_valid, sampling_ratio):
    """The backward kernel on CUDA, uncounted: one ``(B, Hl, Wl, C)``
    gradient per level in ``grad_out``'s dtype, each written whole by the
    kernel (no zeroing, no float32 copy, no cast)."""
    shapes = tuple(tuple(s) for s in shapes)
    R, oh, ow, C = grad_out.shape
    if (grad_out.dtype not in _DTYPE_CODES or not grad_out.is_cuda
            or C != shapes[0][-1] or R != rois.shape[0]):
        raise ValueError("grad_out must be a float32 or bfloat16 CUDA "
                         "(R, oh, ow, C) tensor for the forward's RoIs")
    if (lvl.dtype != torch.int32 or lvl.shape != rois.shape[:1]
            or lvl.device != rois.device or not lvl.is_contiguous()):
        raise ValueError("lvl must be the forward's contiguous int32 (R,) "
                         "levels")
    grad_out = grad_out.contiguous()
    grads = [torch.empty(s, dtype=grad_out.dtype, device=grad_out.device)
             for s in shapes]
    _call("roi_align_block_bwd", grads, shapes, tuple(featmap_strides), rois,
          roi_valid, lvl.data_ptr(), oh, ow, int(sampling_ratio),
          _DTYPE_CODES[grad_out.dtype], grad_out.data_ptr())
    return grads


def _forward_counter(level_rule):
    """The wrapper whose ``launches`` count the forward kernel's launches
    under ``level_rule``."""
    from .roi_align_fused import roi_align_fused
    from .roi_align_strip import roi_align_strip
    return {BLOCK_RULE: roi_align_block, STRIP_RULE: roi_align_fused,
            WINDOW64_RULE: roi_align_strip}[level_rule]


def _backward_counter(level_rule):
    """The wrapper whose ``launches`` count the backward kernel's launches
    at the levels of ``level_rule``."""
    from .roi_align_fused import roi_align_fused_backward
    return {BLOCK_RULE: roi_align_block_backward,
            STRIP_RULE: roi_align_fused_backward}[level_rule]


def _plain_levels(rois, featmap_strides, level_rule, finest_scale, window):
    """Each RoI's level under ``level_rule``, as the plain versions compute
    it."""
    from .roi_align_fused import strip_levels
    boxes = rois[:, 1:5].float()
    if level_rule == BLOCK_RULE:
        return block_levels(boxes, featmap_strides, finest_scale, window)
    if level_rule == STRIP_RULE:
        return strip_levels(boxes, featmap_strides, finest_scale, window)
    return map_roi_levels(boxes, len(featmap_strides), finest_scale)


@torch.library.custom_op("bonai_tpu_torch::roi_align_levels",
                         mutates_args=())
def roi_align_levels_op(levels: list[torch.Tensor], rois: torch.Tensor,
                        roi_valid: Optional[torch.Tensor],
                        output_size: list[int], featmap_strides: list[float],
                        sampling_ratio: int, level_rule: int,
                        finest_scale: int, window: int, want_levels: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The multi-level RoIAlign of the forward kernel as the op
    ``bonai_tpu_torch::roi_align_levels``: ``(out, lvl)``, the ``(R, oh,
    ow, C)`` output in the levels' dtype and each RoI's ``int32`` level
    under ``level_rule`` (empty unless ``want_levels``).

    On CUDA tensors it launches the forward kernel (counted on the
    wrapper of ``level_rule``: ``roi_align_block``, ``roi_align_fused`` or
    ``roi_align_strip``); on CPU tensors it computes the plain version.
    Arguments checked by the caller (``_check_inputs``), but for the
    levels' alignment.  Its gradient, registered below, is
    :func:`roi_align_levels_backward_op` at the saved levels."""
    strides = tuple(featmap_strides)
    if rois.is_cuda:
        _check_aligned(levels)
        out, lvl = launch_forward(levels, rois, roi_valid, output_size,
                                  strides, sampling_ratio, level_rule,
                                  finest_scale, window, want_levels)
        _forward_counter(level_rule).launches += bool(rois.shape[0])
    else:
        out, lvl = _plain_forward(levels, rois, roi_valid, output_size,
                                  strides, sampling_ratio, level_rule,
                                  finest_scale, window, want_levels)
    if lvl is None:
        lvl = torch.empty(0, dtype=torch.int32, device=rois.device)
    return out, lvl


def _plain_forward(levels, rois, roi_valid, output_size, featmap_strides,
                   sampling_ratio, level_rule, finest_scale, window,
                   want_levels):
    """The op's CPU body: the plain version of ``level_rule``."""
    lvl = _plain_levels(rois, featmap_strides, level_rule, finest_scale,
                        window)
    if level_rule == WINDOW64_RULE:
        from .roi_align_strip import roi_align_strip_ref
        out = roi_align_strip_ref(levels, rois, output_size,
                                  featmap_strides, sampling_ratio, True,
                                  finest_scale, roi_valid)
    else:
        out = roi_align_at_levels(levels, rois, lvl, output_size,
                                  featmap_strides, sampling_ratio,
                                  roi_valid=roi_valid)
    return out, lvl.int() if want_levels else None


@roi_align_levels_op.register_fake
def _(levels, rois, roi_valid, output_size, featmap_strides, sampling_ratio,
      level_rule, finest_scale, window, want_levels):
    R = rois.shape[0]
    return (levels[0].new_empty((R, *output_size, levels[0].shape[-1])),
            rois.new_empty((R,) if want_levels else (0,),
                           dtype=torch.int32))


@torch.library.custom_op("bonai_tpu_torch::roi_align_levels_backward",
                         mutates_args=())
def roi_align_levels_backward_op(grad_out: torch.Tensor, shapes: list[int],
                                 featmap_strides: list[float],
                                 rois: torch.Tensor, lvl: torch.Tensor,
                                 roi_valid: Optional[torch.Tensor],
                                 sampling_ratio: int, level_rule: int
                                 ) -> list[torch.Tensor]:
    """The gradient of :func:`roi_align_levels_op` with respect to its
    levels, as the op ``bonai_tpu_torch::roi_align_levels_backward``:
    ``shapes`` is the levels' ``(B, Hl, Wl, C)`` shapes, flattened.  On
    CUDA it launches the backward kernel (counted on
    ``roi_align_block_backward`` or ``roi_align_fused_backward`` by
    ``level_rule``); on the CPU it is the plain scatter, summed in float32
    and rounded once.  One ``(B, Hl, Wl, C)`` gradient per level, in
    ``grad_out``'s dtype."""
    level_shapes = [tuple(shapes[i:i + 4]) for i in range(0, len(shapes), 4)]
    strides = tuple(featmap_strides)
    if grad_out.is_cuda:
        grads = launch_backward(grad_out, level_shapes, strides, rois, lvl,
                                roi_valid, sampling_ratio)
        _backward_counter(level_rule).launches += 1
        return grads
    corners, weights = corner_plan(level_shapes, rois, lvl,
                                   grad_out.shape[1:3], strides,
                                   sampling_ratio, True, roi_valid)
    sizes = [b * h * w for b, h, w, _ in level_shapes]
    dflat = scatter_corners(grad_out.float(), sum(sizes), corners, weights,
                            sampling_ratio, torch.float32)
    return [g.reshape(s).to(grad_out.dtype, copy=True)    # no shared base
            for g, s in zip(dflat.split(sizes), level_shapes)]


@roi_align_levels_backward_op.register_fake
def _(grad_out, shapes, featmap_strides, rois, lvl, roi_valid,
      sampling_ratio, level_rule):
    return [grad_out.new_empty(shapes[i:i + 4])
            for i in range(0, len(shapes), 4)]


def _setup_backward(ctx, inputs, output):
    levels, rois, roi_valid, _, strides, sr, rule = inputs[:7]
    ctx.save_for_backward(rois, output[1], roi_valid)
    ctx.shapes = [d for f in levels for d in f.shape]
    ctx.strides, ctx.sampling_ratio, ctx.level_rule = strides, sr, rule


def _levels_backward(ctx, grad_out, _grad_lvl):
    rois, lvl, roi_valid = ctx.saved_tensors
    if lvl.shape[0] != rois.shape[0]:
        raise RuntimeError("roi_align_levels was called with "
                           "want_levels=False: it has no gradient")
    grads = roi_align_levels_backward_op(
        grad_out.contiguous(), ctx.shapes, ctx.strides, rois, lvl,
        roi_valid, ctx.sampling_ratio, ctx.level_rule)
    return (grads,) + (None,) * 9


roi_align_levels_op.register_autograd(_levels_backward,
                                      setup_context=_setup_backward)


def roi_align_block_backward(grad_out, shapes, featmap_strides, rois, lvl,
                             roi_valid, sampling_ratio=2):
    """Gradient of the block RoIAlign with respect to its levels: on CUDA
    launches the backward kernel (``roi_align_block_backward.launches``
    counts its launches) through :func:`roi_align_levels_backward_op`.

    Args:
      grad_out: ``(R, oh, ow, C)`` gradient of the output (float32 or
        bfloat16, the levels' dtype).
      shapes: the levels' ``(B, Hl, Wl, C)`` shapes.
      rois, lvl, roi_valid: the forward's RoIs, ``int32`` levels and bool
        validity (``None``: every row valid).

    Returns one ``(B, Hl, Wl, C)`` contiguous gradient per level in
    ``grad_out``'s dtype: summed in float32, rounded once.
    """
    return roi_align_levels_backward_op(
        grad_out, [int(d) for s in shapes for d in s],
        [float(s) for s in featmap_strides], rois, lvl, roi_valid,
        int(sampling_ratio), BLOCK_RULE)


roi_align_block_backward.launches = 0


def roi_align_levels(levels, rois, output_size, featmap_strides,
                     sampling_ratio, level_rule, finest_scale, window,
                     roi_valid=None):
    """:func:`roi_align_levels_op` on checked arguments, with the levels
    saved for the backward kernel where the levels require a gradient."""
    want = torch.is_grad_enabled() and any(f.requires_grad for f in levels)
    out, _ = roi_align_levels_op(
        list(levels), rois,
        None if roi_valid is None else roi_valid.contiguous(),
        list(_as_pair(output_size)), [float(s) for s in featmap_strides],
        int(sampling_ratio), level_rule, int(finest_scale), int(window),
        want)
    return out


def roi_align_block(levels, rois, output_size, featmap_strides,
                    sampling_ratio=2, aligned=True, finest_scale=56,
                    roi_valid=None):
    """Multi-level RoIAlign, block level rule.

    Args:
      levels: list of ``(B, Hl, Wl, C)`` contiguous NHWC maps (float32 or
        bfloat16), one per stride.
      rois: ``(R, 5)`` float32 ``[batch_idx, x1, y1, x2, y2]``.
      roi_valid: optional ``(R,)`` bool; invalid rows come out as zeros.

    Returns ``(R, oh, ow, C)`` in the levels' dtype.  CUDA tensors go to
    the forward kernel (``roi_align_block.launches`` counts its launches)
    and, where the levels require a gradient, the backward kernel
    (:func:`roi_align_block_backward`); CPU tensors go to
    :func:`roi_align_block_ref`.
    """
    device = levels[0].device
    if device.type == "cpu":
        return roi_align_block_ref(levels, rois, output_size,
                                   featmap_strides, sampling_ratio, aligned,
                                   finest_scale, roi_valid)
    if device.type != "cuda":
        raise ValueError(f"roi_align_block runs on cuda or cpu, not {device}")
    num_levels = len(featmap_strides)
    _check_inputs(levels, rois, roi_valid, num_levels, aligned,
                  sampling_ratio)
    return roi_align_levels(levels[:num_levels], rois, output_size,
                            featmap_strides, sampling_ratio, BLOCK_RULE,
                            finest_scale, _WINDOW, roi_valid)


roi_align_block.launches = 0
