"""Box and offset geometry (counterpart of ``bonai_tpu/core/boxes.py``):
IoU, the delta-xywh box coder, the delta-xy offset coder, offset rotation
and clipping, on batched tensors.  Each keeps the JAX function's order of
operations: the assigner compares IoUs for exact equality."""

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


def _div(a, b):
    """``a / b`` for a tuple ``b`` of coder constants, as a true division
    by a tensor (CUDA turns division by a Python number into a
    multiplication by its reciprocal)."""
    return a / a.new_tensor(b)


def bbox2delta(proposals, gt, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               eps=1e-7, legacy=False):
    """Encode ``gt`` boxes as deltas of ``proposals`` (both ``(..., 4)``);
    ``eps`` keeps zero-size padded boxes finite.  ``legacy``: mmdetection
    v1.x's ``+1`` sizes (``LegacyDeltaXYWHBBoxCoder``)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    if legacy:
        pw, ph, gw, gh = pw + 1.0, ph + 1.0, gw + 1.0, gh + 1.0
    pw = pw.clamp(min=eps)
    ph = ph.clamp(min=eps)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw.clamp(min=eps) / pw),
                          torch.log(gh.clamp(min=eps) / ph)], dim=-1)
    return _div(deltas - deltas.new_tensor(means), stds)


def delta2bbox(rois, deltas, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16 / 1000, legacy=False):
    """Decode ``(..., 4*K)`` deltas on ``(..., 4)`` boxes.  ``max_shape``
    is ``(h, w)``; each may be a tensor broadcasting against the boxes.
    ``legacy``: mmdetection v1.x's ``+1`` sizes and ``0.5`` corners."""
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
    if legacy:
        pw, ph = pw + 1.0, ph + 1.0
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                         gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if legacy:
        boxes = boxes + boxes.new_tensor([0.5, 0.5, -0.5, -0.5])
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes.reshape(deltas.shape)


def offset2delta(proposals, gt_offsets, means=(0., 0.), stds=(0.5, 0.5),
                 eps=1e-7):
    """Encode roof->footprint offsets ``(..., 2)`` relative to the
    proposal size."""
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)
    deltas = torch.stack([gt_offsets[..., 0] / pw, gt_offsets[..., 1] / ph],
                         dim=-1)
    return _div(deltas - deltas.new_tensor(means), stds)


def offset_rotate(offsets, angle_deg):
    """Rotate ``(..., 2)`` offset vectors by ``angle_deg`` (the LOFT FOA
    branch turn): ``(x cos a + y sin a, -x sin a + y cos a)``."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    x, y = offsets[..., 0], offsets[..., 1]
    return torch.stack([x * c + y * s, -x * s + y * c], dim=-1)


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
