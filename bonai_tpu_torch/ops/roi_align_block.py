"""Multi-level RoIAlign with the block level rule: the CUDA kernels
(``csrc/roi_align_block_fwd.cu`` forward, ``csrc/roi_align_block_bwd.cu``
backward) and their plain PyTorch version.

Counterpart of ``bonai_tpu.ops.pallas_roi_align_block.pallas_block_roi_align``
and its custom VJP.  The level rule is the gather rule
(``floor(log2(sqrt(wh)/56))``) with the block kernel's symmetric push: an
RoI whose larger extent spans more than ``window - 4`` cells at its level
moves coarser until it fits (``_block_plan`` there).  It is computed here
in torch, once, and both versions read it.

``roi_align_block`` takes the plain version only for tensors on the CPU
(autograd differentiates it there); for CUDA tensors it goes through
:class:`_RoIAlignBlock`, whose forward launches the forward kernel and
whose backward launches the backward kernel, or raises.  The RoIs get no
gradient (the detector's RoIs are sampled proposals, constants of the
step).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .roi_align import _as_pair, map_roi_levels, roi_align_at_levels

_MAX_LEVELS = 4         # kMaxLevels in the CUDA source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def block_levels(boxes, featmap_strides, finest_scale=56, window=32):
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


@functools.cache
def _kernel(name):
    """The C entry point of ``csrc/<name>.cu``, built and bound at first
    use.  Every RoIAlign kernel of the port has this signature (levels or
    their gradient buffers, level table, RoIs, levels per RoI, validity,
    output size, sampling ratio, dtype, output or its gradient, stream)."""
    fn = getattr(load_library(name), name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, ptrs, shapes, featmap_strides, rois, lvl, roi_valid,
            output_size, sampling_ratio, dtype, data):
    """One launch of the forward or backward kernel: ``ptrs`` are the
    levels (forward) or their float32 gradient buffers (backward), ``data``
    the output (forward) or the output gradient (backward)."""
    n = len(ptrs)
    oh, ow = output_size
    B, C = shapes[0][0], shapes[0][-1]
    rc = _kernel(name)(
        (ctypes.c_void_p * n)(*ptrs),
        (ctypes.c_int * n)(*[s[1] for s in shapes]),
        (ctypes.c_int * n)(*[s[2] for s in shapes]),
        (ctypes.c_float * n)(*[1.0 / s for s in featmap_strides]),
        n, B, C, rois.data_ptr(), lvl.data_ptr(), roi_valid.data_ptr(),
        rois.shape[0], oh, ow, int(sampling_ratio), _DTYPE_CODES[dtype],
        data.data_ptr(), torch.cuda.current_stream(rois.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_inputs(levels, rois, roi_valid, num_levels, aligned,
                  sampling_ratio, name="roi_align_block", max_sr=None):
    """Raises on what the kernels of ``name`` do not take."""
    if not 1 <= num_levels <= _MAX_LEVELS or len(levels) < num_levels:
        raise ValueError(f"{name} takes 1..{_MAX_LEVELS} levels, "
                         f"got {len(levels)} maps for {num_levels} strides")
    if not aligned:
        raise ValueError(f"{name} computes aligned=True only")
    if int(sampling_ratio) < 1:
        raise ValueError("sampling_ratio must be >= 1")
    if max_sr is not None and int(sampling_ratio) > max_sr:
        raise ValueError(f"{name} takes sampling_ratio <= {max_sr}, got "
                         f"{sampling_ratio}")
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
        if f.data_ptr() % 8:
            raise ValueError("levels must be 8-byte aligned")
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


def _launch_backward(name, grad_out, shapes, featmap_strides, rois, lvl,
                     roi_valid, sampling_ratio):
    """One launch of the backward kernel ``name`` into zeroed float32
    buffers, one per level, each rounded once to ``grad_out``'s dtype."""
    grad_out = grad_out.contiguous()
    bufs = [torch.zeros(s, dtype=torch.float32, device=grad_out.device)
            for s in shapes]
    _launch(name, [b.data_ptr() for b in bufs], shapes, featmap_strides,
            rois, lvl, roi_valid, tuple(grad_out.shape[1:3]), sampling_ratio,
            grad_out.dtype, grad_out)
    return [b.to(grad_out.dtype) for b in bufs]


def roi_align_block_backward(grad_out, shapes, featmap_strides, rois, lvl,
                             roi_valid, sampling_ratio=2):
    """Gradient of the block RoIAlign with respect to its levels: launches
    the backward kernel (``roi_align_block_backward.launches`` counts its
    launches).

    Args:
      grad_out: ``(R, oh, ow, C)`` CUDA gradient of the output (float32 or
        bfloat16, the levels' dtype).
      shapes: the levels' ``(B, Hl, Wl, C)`` shapes.
      rois, lvl, roi_valid: the forward's RoIs, ``int32`` levels and bool
        validity.

    Returns one ``(B, Hl, Wl, C)`` contiguous gradient per level in
    ``grad_out``'s dtype: summed in float32, rounded once.
    """
    grads = _launch_backward("roi_align_block_bwd", grad_out, shapes,
                             featmap_strides, rois, lvl, roi_valid,
                             sampling_ratio)
    roi_align_block_backward.launches += 1
    return grads


roi_align_block_backward.launches = 0


class _RoIAlignBlock(torch.autograd.Function):
    """The block RoIAlign on CUDA: forward kernel, backward kernel.  The
    level per RoI is computed once by the caller and saved for the
    backward."""

    @staticmethod
    def forward(ctx, rois, lvl, roi_valid, output_size, featmap_strides,
                sampling_ratio, *levels):
        out = torch.empty((rois.shape[0], *output_size, levels[0].shape[-1]),
                          dtype=levels[0].dtype, device=levels[0].device)
        _launch("roi_align_block_fwd", [f.data_ptr() for f in levels],
                [tuple(f.shape) for f in levels], featmap_strides, rois, lvl,
                roi_valid, output_size, sampling_ratio, levels[0].dtype, out)
        roi_align_block.launches += 1
        ctx.save_for_backward(rois, lvl, roi_valid)
        ctx.shapes = [tuple(f.shape) for f in levels]
        ctx.strides = featmap_strides
        ctx.sampling_ratio = sampling_ratio
        return out

    @staticmethod
    def backward(ctx, grad_out):
        rois, lvl, roi_valid = ctx.saved_tensors
        grads = roi_align_block_backward(grad_out, ctx.shapes, ctx.strides,
                                         rois, lvl, roi_valid,
                                         ctx.sampling_ratio)
        return (None,) * 6 + tuple(grads)


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
    lvl = block_levels(rois[:, 1:5], featmap_strides,
                       finest_scale).to(torch.int32)
    if roi_valid is None:
        roi_valid = torch.ones(rois.shape[0], dtype=torch.bool, device=device)
    return _RoIAlignBlock.apply(rois, lvl, roi_valid, _as_pair(output_size),
                                tuple(featmap_strides), int(sampling_ratio),
                                *levels[:num_levels])


roi_align_block.launches = 0
