"""Box and offset geometry (counterpart of ``bonai_tpu/core/boxes.py``):
IoU, the delta-xywh box coder, the delta-xy offset coder and clipping, on
batched tensors."""

from __future__ import annotations

import math

import torch


def bbox_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def bbox_overlaps(boxes1, boxes2, eps=1e-6):
    """Pairwise IoU of ``(..., M, 4)`` and ``(..., N, 4)`` -> ``(..., M, N)``.
    Degenerate and zero-padded boxes overlap nothing."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(boxes1)[..., :, None] + bbox_area(boxes2)[..., None, :] \
        - inter
    return inter / union.clamp(min=eps)


def delta2bbox(rois, deltas, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16 / 1000):
    """Decode ``(..., 4*K)`` deltas on ``(..., 4)`` boxes.  ``max_shape``
    is ``(h, w)``; each may be a tensor broadcasting against the boxes."""
    num_classes = deltas.shape[-1] // 4
    d = deltas.reshape(deltas.shape[:-1] + (num_classes, 4))
    d = d * d.new_tensor(stds) + d.new_tensor(means)
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                         gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes.reshape(deltas.shape)


def delta2offset(rois, deltas, means=(0., 0.), stds=(0.5, 0.5),
                 max_shape=None):
    """Decode roof->footprint offsets relative to the box size;
    ``max_shape`` ``(h, w)`` bounds each component's magnitude."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    gx = (rois[..., 2] - rois[..., 0]) * d[..., 0]
    gy = (rois[..., 3] - rois[..., 1]) * d[..., 1]
    if max_shape is not None:
        h, w = max_shape
        gx = torch.maximum(torch.minimum(gx, w), -w)
        gy = torch.maximum(torch.minimum(gy, h), -h)
    return torch.stack([gx, gy], dim=-1)


def clip_boxes(boxes, img_shape):
    """Clip ``(..., 4)`` boxes to ``img_shape = (h, w)``; ``h``/``w`` are
    numbers or tensors broadcasting against ``boxes[..., 0]``."""
    h, w = img_shape
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
