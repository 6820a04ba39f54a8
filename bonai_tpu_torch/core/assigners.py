"""Max-IoU assignment on padded, batched boxes (counterpart of
``bonai_tpu/core/assigners.py::max_iou_assign``).

GT boxes come padded to a fixed count with a validity mask; every leading
dimension is a batch dimension.  The low-quality match compares IoUs for
exact equality, so the IoU is computed in the JAX package's order
(``core/boxes.py::bbox_overlaps``).
"""

from __future__ import annotations

import torch

from .boxes import bbox_overlaps


def max_iou_assign(boxes, gt_bboxes, gt_valid, pos_iou_thr, neg_iou_thr,
                   min_pos_iou=0., match_low_quality=True, box_valid=None):
    """Assign each box to -1 (ignore), 0 (negative) or ``i + 1`` (GT ``i``).

    Args:
      boxes: ``(..., N, 4)`` candidates (anchors or proposals).
      gt_bboxes: ``(..., G, 4)`` padded GT boxes; ``gt_valid`` ``(..., G)``.
      box_valid: optional ``(..., N)`` bool; invalid boxes are ignored.

    Returns ``assigned`` ``(..., N)`` int64 and ``max_overlaps``
    ``(..., N)``.  With no valid GT every box is negative.
    """
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
