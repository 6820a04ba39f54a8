"""Max-IoU and ATSS assignment on padded, batched boxes (counterparts of
``bonai_tpu/core/assigners.py::max_iou_assign`` and ``atss_assign``).

GT boxes come padded to a fixed count with a validity mask; every leading
dimension is a batch dimension.  The low-quality match compares IoUs for
exact equality, so the IoU is computed in the JAX package's order
(``core/boxes.py::bbox_overlaps``).
"""

from __future__ import annotations

import torch

from .boxes import bbox_overlaps


def max_iou_assign(boxes, gt_bboxes, gt_valid, pos_iou_thr, neg_iou_thr,
                   min_pos_iou=0., match_low_quality=True, box_valid=None,
                   overlaps=None):
    """Assign each box to -1 (ignore), 0 (negative) or ``i + 1`` (GT ``i``).

    Args:
      boxes: ``(..., N, 4)`` candidates (anchors or proposals).
      gt_bboxes: ``(..., G, 4)`` padded GT boxes; ``gt_valid`` ``(..., G)``.
      box_valid: optional ``(..., N)`` bool; invalid boxes are ignored.
      overlaps: optional precomputed ``(..., N, G)`` IoUs (Guided
        Anchoring's best over each cell's approximate anchors).

    Returns ``assigned`` ``(..., N)`` int64 and ``max_overlaps``
    ``(..., N)``.  With no valid GT every box is negative.
    """
    if overlaps is None:
        overlaps = bbox_overlaps(boxes, gt_bboxes)
    overlaps = torch.where(gt_valid[..., None, :], overlaps,
                           overlaps.new_tensor(-1.0))
    max_overlaps = overlaps.amax(dim=-1)
    argmax = overlaps.argmax(dim=-1)           # first maximum, as jnp.argmax
    assigned = torch.full_like(argmax, -1)
    assigned = torch.where(max_overlaps < neg_iou_thr, 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax + 1, assigned)
    if match_low_quality:
        # every valid GT claims the boxes that tie its best IoU; later GTs
        # overwrite earlier ones
        gt_max = overlaps.amax(dim=-2, keepdim=True)        # (..., 1, G)
        claim = ((overlaps == gt_max) & gt_valid[..., None, :]
                 & (gt_max >= min_pos_iou) & (gt_max > 0))
        gt_ids = torch.arange(1, gt_bboxes.shape[-2] + 1,
                              device=boxes.device)
        claimed = torch.where(claim, gt_ids, 0).amax(dim=-1)
        assigned = torch.where(claimed > 0, claimed, assigned)
    if box_valid is not None:
        assigned = torch.where(box_valid, assigned, -1)
        max_overlaps = torch.where(box_valid, max_overlaps,
                                   max_overlaps.new_tensor(-1.0))
    return assigned, max_overlaps


def atss_assign(anchors, num_level_anchors, gt_bboxes, gt_valid, topk=9):
    """Adaptive Training Sample Selection of a batch.

    Per GT and pyramid level the ``topk`` anchors whose centres lie
    nearest the GT's centre are candidates (exact ties to the lower
    anchor index, as ``jax.lax.top_k`` breaks them: one stable sort); a
    GT's IoU threshold is the mean plus the standard deviation (``ddof =
    1``) of its candidates' IoUs; a candidate at or above it whose centre
    lies inside the GT (by more than 0.01 px) is positive; an anchor
    positive for several GTs takes the one of highest IoU (the first of
    equals).

    Args:
      anchors: ``(A, 4)``, the levels' anchors concatenated;
        ``num_level_anchors`` their counts a level.
      gt_bboxes: ``(B, G, 4)`` padded GT boxes; ``gt_valid`` ``(B, G)``.

    Returns ``assigned`` ``(B, A)`` int64 (0 negative, ``i + 1`` GT ``i``)
    and the IoU of the assigned GT (0 for negatives).
    """
    overlaps = bbox_overlaps(anchors, gt_bboxes)               # (B, A, G)
    valid = gt_valid[:, None, :]
    overlaps = torch.where(valid, overlaps, overlaps.new_tensor(-1.0))
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    dist = torch.sqrt((acx[:, None] - gcx[:, None, :]) ** 2
                      + (acy[:, None] - gcy[:, None, :]) ** 2)
    cand = torch.zeros_like(overlaps, dtype=torch.bool)
    start = 0
    for n in num_level_anchors:
        k = min(int(topk), int(n))
        d = dist[:, start:start + n].transpose(1, 2)           # (B, G, n)
        idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
        cand[:, start:start + n] = torch.zeros_like(d, dtype=torch.bool) \
            .scatter_(2, idx, True).transpose(1, 2)
        start += n
    cand = cand & valid
    zero = overlaps.new_tensor(0.0)
    k_eff = cand.sum(dim=1).float().clamp(min=1.0)             # (B, G)
    mean = torch.where(cand, overlaps, zero).sum(dim=1) / k_eff
    var = torch.where(cand, (overlaps - mean[:, None]) ** 2, zero).sum(
        dim=1) / (k_eff - 1.0).clamp(min=1.0)
    thr = mean + torch.sqrt(var)
    x1, y1, x2, y2 = (gt_bboxes[:, None, :, i] for i in range(4))
    inside = torch.minimum(
        torch.minimum(acx[:, None] - x1, x2 - acx[:, None]),
        torch.minimum(acy[:, None] - y1, y2 - acy[:, None])) > 0.01
    is_pos = cand & (overlaps >= thr[:, None]) & inside
    ov = torch.where(is_pos, overlaps, overlaps.new_tensor(-1e8))
    max_ov, arg = ov.max(dim=-1)                # the first maximum
    assigned = torch.where(max_ov > -1e7, arg + 1, 0)
    return assigned, torch.where(assigned > 0, max_ov, zero)
