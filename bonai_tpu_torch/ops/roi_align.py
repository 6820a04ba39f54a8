"""Multi-level RoIAlign over an FPN pyramid, in plain PyTorch.

Counterpart of ``bonai_tpu/ops/roi_align.py``: ``aligned=True`` and a
fixed ``sampling_ratio`` (2 in the detector: the config's 0 becomes 2, as
in the JAX package; this is not mmcv's adaptive grid).  Every bilinear
corner is a row gather from the pyramid flattened to ``(P, C)``, and the
sums run in float32.

This module is the plain version that the detector uses off the card and
that the CUDA kernels are held against.  The level rule is an argument of
:func:`roi_align_at_levels`: the gather rule (:func:`map_roi_levels`)
here, the block rule in ``roi_align_block``, the strip rule in
``roi_align_fused``.  :func:`window_corner_plan` holds the border rule of
the windowed formulations (``roi_align_strip``, ``roi_align_blocked``),
and :func:`scatter_corners` the scatter backward.
"""

from __future__ import annotations

import torch

# RoIs per gather chunk: bounds the (chunk, samples, C) float32 temporaries
# (~0.4 GB at 14x14 output, C=256) when the plain version runs at the
# detector's full shapes on the card.
_CHUNK = 512


def _bilinear_params(y, x, height, width):
    """Corner indices + weights with the RoIAlign border rule: points
    outside ``[-1, size]`` contribute zero; coordinates are clamped into
    the map.  ``height``/``width`` broadcast against ``y``/``x``."""
    outside = (y < -1.0) | (y > height) | (x < -1.0) | (x > width)
    y = torch.minimum(y.clamp(min=0.0), height - 1.0)
    x = torch.minimum(x.clamp(min=0.0), width - 1.0)
    y0 = torch.minimum(torch.floor(y), (height - 2.0).clamp(min=0.0))
    x0 = torch.minimum(torch.floor(x), (width - 2.0).clamp(min=0.0))
    ly = y - y0
    lx = x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    weights = tuple(torch.where(outside, zero, w) for w in
                    (hy * hx, hy * lx, ly * hx, ly * lx))
    return y0.long(), x0.long(), weights


def _sample_coords(boxes, output_size, sampling_ratio, aligned=True):
    """Sample-point coordinates per RoI: ``(R, oh*sr)`` ys and
    ``(R, ow*sr)`` xs in the coordinates of the level ``boxes`` are
    scaled to."""
    out_h, out_w = output_size
    sr = sampling_ratio
    offset = 0.5 if aligned else 0.0
    # every division here is by a device tensor, not a Python number: CUDA
    # turns division by a host scalar into multiplication by its
    # reciprocal, an ulp off the true quotient that the kernel computes
    x1 = boxes[:, 0] - offset
    y1 = boxes[:, 1] - offset
    roi_w = boxes[:, 2] - offset - x1
    roi_h = boxes[:, 3] - offset - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    sub = (torch.arange(sr, dtype=torch.float32, device=boxes.device)
           + 0.5) / boxes.new_tensor(float(sr))

    def grid(n):
        cells = torch.arange(n, dtype=torch.float32, device=boxes.device)
        return (cells[:, None] + sub[None, :]).reshape(-1)

    bin_h = roi_h / roi_h.new_tensor(float(out_h))
    bin_w = roi_w / roi_w.new_tensor(float(out_w))
    ys = y1[:, None] + bin_h[:, None] * grid(out_h)[None, :]
    xs = x1[:, None] + bin_w[:, None] * grid(out_w)[None, :]
    return ys, xs


def map_roi_levels(boxes, num_levels, finest_scale=56):
    """FPN level per RoI: ``floor(log2(sqrt(w*h) / finest_scale + 1e-6))``
    clamped to the pyramid (mmdet ``SingleRoIExtractor``).

    The division is a multiplication by the float32 reciprocal of
    ``finest_scale`` on every device: what torch does for a division by a
    Python number on CUDA, and what the forward kernel does.  A true
    division on the CPU gave another level than the card on RoIs within an
    ulp of the rule's edges."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    scale = torch.sqrt((w * h).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale * (1.0 / finest_scale) + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _as_pair(output_size):
    if isinstance(output_size, int):
        return (output_size, output_size)
    return tuple(output_size)


def flatten_levels(levels):
    """The levels as one ``(sum(B*Hl*Wl), C)`` float32 buffer, level after
    level, each in ``(B, Hl, Wl)`` order."""
    C = levels[0].shape[-1]
    return torch.cat([f.reshape(-1, C) for f in levels]).float()


def _level_samples(shapes, rois, lvl, output_size, featmap_strides,
                   sampling_ratio, aligned):
    """Each RoI's sample grid at the pyramid level ``lvl`` gives it.

    ``shapes`` are the levels' ``(B, Hl, Wl, C)``.  Returns each RoI's
    first row of its image at its level in the :func:`flatten_levels`
    buffer ``base``, its level's height ``Hl`` and width ``Wl``, and its
    sample coordinates ``ys`` ``(R, oh*sr)`` and ``xs`` ``(R, ow*sr)`` in
    cells of that level."""
    shapes = [tuple(s) for s in shapes[:len(featmap_strides)]]
    B = shapes[0][0]
    dev = rois.device
    sizes = [B * s[1] * s[2] for s in shapes]
    offsets = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)
    heights = torch.tensor([s[1] for s in shapes], device=dev)
    widths = torch.tensor([s[2] for s in shapes], device=dev)
    inv_scale = 1.0 / torch.tensor(featmap_strides, dtype=torch.float32,
                                   device=dev)
    rois = rois.float()
    bidx = rois[:, 0].long().clamp(0, B - 1)
    Hl, Wl = heights[lvl], widths[lvl]
    base = offsets[lvl] + bidx * Hl * Wl
    scaled = rois[:, 1:5] * inv_scale[lvl][:, None]
    ys, xs = _sample_coords(scaled, _as_pair(output_size),
                            max(int(sampling_ratio), 1), aligned)
    return base, Hl, Wl, ys, xs


def corner_plan(shapes, rois, lvl, output_size, featmap_strides,
                sampling_ratio=2, aligned=True, roi_valid=None):
    """The four bilinear corners of every sample under the RoIAlign
    border rule, each RoI at the level ``lvl`` gives it, for levels of
    ``shapes``.

    Returns the corners' rows of the :func:`flatten_levels` buffer and
    their weights, four ``(R, oh*sr, ow*sr)`` tensors each (``i00``,
    ``i00 + 1``, ``i00 + Wl``, ``i00 + Wl + 1``); invalid RoIs get zero
    weights."""
    base, Hl, Wl, ys, xs = _level_samples(
        shapes, rois, lvl, output_size, featmap_strides, sampling_ratio,
        aligned)
    ys, xs = ys[:, :, None], xs[:, None, :]             # (R, ny, 1), (R, 1, nx)
    y0, x0, weights = _bilinear_params(ys, xs, Hl.float()[:, None, None],
                                       Wl.float()[:, None, None])
    if roi_valid is not None:
        gate = roi_valid.to(rois.device)[:, None, None]
        weights = tuple(w * gate for w in weights)
        base = torch.where(roi_valid.to(rois.device), base, 0)
    Wrow = Wl[:, None, None]
    i00 = base[:, None, None] + y0 * Wrow + x0           # (R, ny, nx)
    return (i00, i00 + 1, i00 + Wrow, i00 + Wrow + 1), weights


def window_corner_plan(shapes, rois, lvl, output_size, featmap_strides,
                       sampling_ratio, aligned, window_start, window,
                       weight_dtype=None):
    """The corners of the JAX package's windowed strip formulations
    (``pallas_roi_align.py``, ``roi_align_blocked.py``), whose border rule
    is not RoIAlign's:

    - a sample outside ``[-1, Hl]`` in y keeps full weight on its clamped
      row (``ly = 0``) where RoIAlign counts it zero;
    - a sample outside ``[-1, Wl]`` in x counts zero;
    - each RoI's x window starts at ``window_start(x0min, Wl)``, ``x0min``
      the least low corner of all its x samples (in range or not), and an
      x corner ``window`` or more cells past that start counts zero.

    ``weight_dtype`` rounds the x weights to that type (the blocked
    formulation contracts a one-hot matrix in the feature dtype).  Returns
    corners and weights as :func:`corner_plan` does, with no validity
    gate."""
    base, Hl, Wl, ys, xs = _level_samples(
        shapes, rois, lvl, output_size, featmap_strides, sampling_ratio,
        aligned)
    Hf, Wf = Hl.float()[:, None], Wl.float()[:, None]
    yc = torch.minimum(ys.clamp(min=0.0), Hf - 1.0)
    y0 = torch.minimum(torch.floor(yc), (Hf - 2.0).clamp(min=0.0))
    ly = torch.where((ys < -1.0) | (ys > Hf), 0.0, yc - y0)
    xc = torch.minimum(xs.clamp(min=0.0), Wf - 1.0)
    x0 = torch.minimum(torch.floor(xc), (Wf - 2.0).clamp(min=0.0))
    lx = xc - x0
    out_x = (xs < -1.0) | (xs > Wf)
    e0 = x0 - window_start(x0.amin(dim=1), Wl)[:, None]
    hx = torch.where(out_x | (e0 >= window), 0.0, 1.0 - lx)
    wx = torch.where(out_x | (e0 + 1 >= window), 0.0, lx)
    if weight_dtype is not None:
        hx, wx = hx.to(weight_dtype).float(), wx.to(weight_dtype).float()
    hy, ly = (1.0 - ly)[:, :, None], ly[:, :, None]
    hx, wx = hx[:, None, :], wx[:, None, :]
    Wrow = Wl[:, None, None]
    y0 = y0.long()[:, :, None]
    y1 = torch.minimum(y0 + 1, Hl[:, None, None] - 1)
    x0 = x0.long()[:, None, :]
    i0 = base[:, None, None] + y0 * Wrow + x0
    i1 = base[:, None, None] + y1 * Wrow + x0
    return (i0, i0 + 1, i1, i1 + 1), (hy * hx, hy * wx, ly * hx, ly * wx)


def pool_corners(flat, corners, weights, output_size, sampling_ratio):
    """``sum(weight * flat[corner])`` over each sample's corners, averaged
    over each ``sr x sr`` bin: ``(R, oh, ow, C)`` float32.  Corners with
    zero weight past the last row of ``flat`` read the last row."""
    oh, ow = _as_pair(output_size)
    sr = max(int(sampling_ratio), 1)
    R, C = corners[0].shape[0], flat.shape[1]
    last = flat.shape[0] - 1
    out = flat.new_empty((R, oh, ow, C))
    for s in range(0, R, _CHUNK):
        e = min(s + _CHUNK, R)
        acc = None
        for idx, w in zip(corners, weights):
            rows = flat[idx[s:e].clamp(max=last).reshape(-1)]
            term = rows * w[s:e].reshape(-1, 1)
            acc = term if acc is None else acc.add_(term)
        acc = acc.reshape(e - s, oh, sr, ow, sr, C)
        out[s:e] = acc.sum(dim=(2, 4)) / acc.new_tensor(float(sr * sr))
    return out


def scatter_corners(grad_out, num_rows, corners, weights, sampling_ratio,
                    dtype):
    """The transpose of :func:`pool_corners`: each output gradient,
    divided by ``sr*sr`` and times each corner's weight, added into a
    ``(num_rows, C)`` buffer of ``dtype`` with ``index_add_``.  The
    products are taken in float32 and rounded to ``dtype`` before the
    sum, which runs in ``dtype`` (the JAX package's scatter backward,
    ``bonai_tpu/ops/roi_align.py::_bilinear_gather_bwd``)."""
    R, oh, ow, C = grad_out.shape
    sr = max(int(sampling_ratio), 1)
    dflat = grad_out.new_zeros((num_rows, C), dtype=dtype)
    last = num_rows - 1
    for s in range(0, R, _CHUNK):
        e = min(s + _CHUNK, R)
        g = grad_out[s:e].float() / grad_out.new_tensor(float(sr * sr),
                                                        dtype=torch.float32)
        g = g[:, :, None, :, None, :].expand(e - s, oh, sr, ow, sr, C)
        g = g.reshape(-1, C)
        for idx, w in zip(corners, weights):
            dflat.index_add_(0, idx[s:e].clamp(max=last).reshape(-1),
                             (g * w[s:e].reshape(-1, 1)).to(dtype))
    return dflat


def roi_align_at_levels(levels, rois, lvl, output_size, featmap_strides,
                        sampling_ratio=2, aligned=True, roi_valid=None):
    """RoIAlign of each RoI at the pyramid level ``lvl`` gives it.

    Args:
      levels: list of ``(B, Hl, Wl, C)`` NHWC maps, one per stride.
      rois: ``(R, 5)`` ``[batch_idx, x1, y1, x2, y2]`` in image coords.
      lvl: ``(R,)`` integer level per RoI.
      roi_valid: optional ``(R,)`` bool; invalid rows come out as zeros.

    Returns ``(R, oh, ow, C)`` in the levels' dtype (sums in float32).
    """
    levels = list(levels[:len(featmap_strides)])
    corners, weights = corner_plan([f.shape for f in levels], rois, lvl,
                                   output_size, featmap_strides,
                                   sampling_ratio, aligned, roi_valid)
    return pool_corners(flatten_levels(levels), corners, weights,
                        output_size, sampling_ratio).to(levels[0].dtype)


def multilevel_roi_align(levels, rois, output_size, featmap_strides,
                         sampling_ratio=2, aligned=True, finest_scale=56,
                         roi_valid=None):
    """Multi-level RoIAlign with the gather level rule (the counterpart
    of ``bonai_tpu.ops.roi_align.multilevel_roi_align``).  Returns
    ``(R, oh, ow, C)``."""
    lvl = map_roi_levels(rois[:, 1:5].float(), len(featmap_strides),
                         finest_scale)
    return roi_align_at_levels(levels, rois, lvl, output_size,
                               featmap_strides, sampling_ratio, aligned,
                               roi_valid)
