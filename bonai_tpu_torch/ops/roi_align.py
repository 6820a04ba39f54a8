"""Multi-level RoIAlign over an FPN pyramid, in plain PyTorch.

Counterpart of ``bonai_tpu/ops/roi_align.py``: ``aligned=True`` and a
fixed ``sampling_ratio`` (2 in the detector: the config's 0 becomes 2, as
in the JAX package; this is not mmcv's adaptive grid).  Every bilinear
corner is a row gather from the pyramid flattened to ``(P, C)``, and the
sums run in float32.

This module is the plain version that the detector uses off the card and
that the CUDA kernel of ``roi_align_block`` is held against.  The level
rule is an argument of :func:`roi_align_at_levels`: the gather rule
(:func:`map_roi_levels`) here, the block rule in ``roi_align_block``.
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
    clamped to the pyramid (mmdet ``SingleRoIExtractor``)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    scale = torch.sqrt((w * h).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _as_pair(output_size):
    if isinstance(output_size, int):
        return (output_size, output_size)
    return tuple(output_size)


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
    oh, ow = _as_pair(output_size)
    sr = max(int(sampling_ratio), 1)
    levels = list(levels[:len(featmap_strides)])
    B, C = levels[0].shape[0], levels[0].shape[-1]
    dev = rois.device
    flat = torch.cat([f.reshape(-1, C) for f in levels]).float()
    sizes = [B * f.shape[1] * f.shape[2] for f in levels]
    offsets = torch.tensor([0] + sizes[:-1], device=dev).cumsum(0)
    heights = torch.tensor([f.shape[1] for f in levels], device=dev)
    widths = torch.tensor([f.shape[2] for f in levels], device=dev)
    inv_scale = 1.0 / torch.tensor(featmap_strides, dtype=torch.float32,
                                   device=dev)
    R = rois.shape[0]
    rois = rois.float()
    bidx = rois[:, 0].long().clamp(0, B - 1)
    Hl, Wl = heights[lvl], widths[lvl]
    base = offsets[lvl] + bidx * Hl * Wl
    scaled = rois[:, 1:5] * inv_scale[lvl][:, None]
    ys, xs = _sample_coords(scaled, (oh, ow), sr, aligned)
    ys, xs = ys[:, :, None], xs[:, None, :]             # (R, ny, 1), (R, 1, nx)
    Hf = Hl.float()[:, None, None]
    Wf = Wl.float()[:, None, None]
    y0, x0, weights = _bilinear_params(ys, xs, Hf, Wf)
    if roi_valid is not None:
        gate = roi_valid.to(dev)[:, None, None]
        weights = tuple(w * gate for w in weights)
        base = torch.where(roi_valid.to(dev), base, 0)
    Wrow = Wl[:, None, None]
    i00 = base[:, None, None] + y0 * Wrow + x0           # (R, ny, nx)
    corners = (i00, i00 + 1, i00 + Wrow, i00 + Wrow + 1)
    last = flat.shape[0] - 1
    out = flat.new_empty((R, oh, ow, C))
    for s in range(0, R, _CHUNK):
        e = min(s + _CHUNK, R)
        acc = None
        for idx, w in zip(corners, weights):
            # zero-weight corners past a level's last row may index past
            # the buffer; clamp them onto a real row
            rows = flat[idx[s:e].clamp(max=last).reshape(-1)]
            term = rows * w[s:e].reshape(-1, 1)
            acc = term if acc is None else acc.add_(term)
        acc = acc.reshape(e - s, oh, sr, ow, sr, C)
        out[s:e] = acc.sum(dim=(2, 4)) / acc.new_tensor(float(sr * sr))
    return out.to(levels[0].dtype)


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
