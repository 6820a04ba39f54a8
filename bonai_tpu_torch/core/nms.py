"""NMS, soft-NMS and multi-class NMS on batched, fixed-shape tensors
(counterpart of ``bonai_tpu/core/nms.py``).

Every function takes a leading batch of independent problems, so one loop
serves all images (and, in the RPN, all pyramid levels) at once:

- ``nms`` is blocked greedy suppression: score-sorted boxes are taken in
  tiles of 256; a tile is first suppressed by the boxes kept before it
  (one IoU matrix), then an in-tile fixpoint iteration reproduces the
  sequential greedy result exactly.  The host waits on the device once per
  fixpoint trip, a few trips per tile.
- ``batched_nms`` keeps boxes of different levels or classes apart by
  shifting each group's coordinates, then runs ``nms``.
- ``soft_nms`` picks the top score and decays its neighbours, slot by
  slot.  A row stops once no score reaches ``min_score`` (the early exit);
  the loop checks that every 16 slots, and slots past a row's exit leave
  its outputs unchanged.

Padded entries carry ``valid=False`` (or score ``NEG_INF`` / 0).

``nms`` and ``soft_nms`` run as the custom ops ``bonai_tpu_torch::nms``
and ``bonai_tpu_torch::soft_nms``, whose bodies are the functions below
and whose fake implementations give their fixed output shapes: the host
decisions inside (the tile test, the fixpoint test, soft-NMS's early
exit) then stay out of a graph that ``torch.export`` traces.  Their inputs
are detached: neither output carries a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from .boxes import bbox_overlaps

NEG_INF = -1e10
_SOFT_NMS_CHECK_EVERY = 16


def _sort_desc(scores):
    """Descending order with ties in index order (``jax.lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def nms(boxes, scores, iou_threshold, valid=None, tile_size=256):
    """Greedy hard NMS over ``(..., N, 4)`` boxes and ``(..., N)`` scores
    (the op ``bonai_tpu_torch::nms``).  Returns a bool keep mask
    ``(..., N)``; ``valid=False`` entries are never kept and never
    suppress."""
    return _nms_op(boxes.detach(), scores.detach(), float(iou_threshold),
                   None if valid is None else valid.detach(),
                   int(tile_size))


def _nms(boxes, scores, iou_threshold, valid, tile_size):
    """The body of :func:`nms`."""
    batch_shape = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    nb = scores.shape[0]
    if valid is not None:
        scores = torch.where(valid.reshape(-1, n), scores,
                             torch.full_like(scores, NEG_INF))
    _, order = _sort_desc(scores)
    sboxes = boxes.gather(1, order[..., None].expand(nb, n, 4))
    alive_valid = scores.gather(1, order) > NEG_INF / 2
    upper = torch.ones(tile_size, tile_size, dtype=torch.bool,
                       device=boxes.device).triu(1)   # row j suppresses k > j
    keep = torch.zeros(nb, n, dtype=torch.bool, device=boxes.device)
    for start in range(0, n, tile_size):
        end = min(start + tile_size, n)
        tile_valid = alive_valid[:, start:end]
        if not bool(tile_valid.any()):
            break                      # sorted: every later box is invalid
        tile = sboxes[:, start:end]
        alive0 = tile_valid
        if start > 0:
            iou_prev = bbox_overlaps(tile, sboxes[:, :start])
            supp = ((iou_prev > iou_threshold)
                    & keep[:, None, :start]).any(dim=-1)
            alive0 = alive0 & ~supp
        t = end - start
        supp_mat = (bbox_overlaps(tile, tile) > iou_threshold) \
            & upper[:t, :t]
        alive = alive0
        for _ in range(t):
            new = alive0 & ~(supp_mat & alive[:, :, None]).any(dim=1)
            if torch.equal(new, alive):
                break
            alive = new
        keep[:, start:end] = alive
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(batch_shape + (n,))


@torch.library.custom_op("bonai_tpu_torch::nms", mutates_args=())
def _nms_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
            valid: Optional[torch.Tensor], tile_size: int) -> torch.Tensor:
    return _nms(boxes, scores, iou_threshold, valid, tile_size)


@_nms_op.register_fake
def _(boxes, scores, iou_threshold, valid, tile_size):
    return torch.empty_like(scores, dtype=torch.bool)


def batched_nms(boxes, scores, idxs, iou_threshold, valid=None,
                tile_size=256):
    """:func:`nms` in which boxes of different ``idxs`` (``(..., N)``: a
    level or a class) never suppress each other: each problem's boxes are
    shifted by ``idxs`` times one more than its largest coordinate."""
    max_coord = boxes.flatten(-2).amax(-1) + 1.0
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord[..., None])[..., None]
    return nms(shifted, scores, iou_threshold, valid=valid,
               tile_size=tile_size)


def soft_nms(boxes, scores, iou_threshold=0.3, sigma=0.5, min_score=1e-3,
             method="linear", max_out=None, valid=None):
    """Soft-NMS (mmcv 1.0.5 semantics) over ``(..., N, 4)`` boxes (the op
    ``bonai_tpu_torch::soft_nms``).

    Returns ``(new_scores, keep_rank)``: decayed scores of the selected
    boxes (0 for dropped or padded ones) in input order, and the selection
    order (-1 for unselected).
    """
    return _soft_nms_op(boxes.detach(), scores.detach(),
                        float(iou_threshold), float(sigma), float(min_score),
                        str(method), None if max_out is None else int(max_out),
                        None if valid is None else valid.detach())


def _soft_nms(boxes, scores, iou_threshold, sigma, min_score, method,
              max_out, valid):
    """The body of :func:`soft_nms`.

    Returns ``(new_scores, keep_rank)``: decayed scores of the selected
    boxes (0 for dropped or padded ones) in input order, and the selection
    order (-1 for unselected).
    """
    batch_shape = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    cur = scores.reshape(-1, n).clone()
    nb = cur.shape[0]
    max_out = n if max_out is None else max_out
    if valid is not None:
        cur = torch.where(valid.reshape(-1, n), cur, torch.zeros_like(cur))
    out = torch.zeros_like(cur)
    rank = torch.full((nb, n), -1, dtype=torch.int32, device=cur.device)
    if n == 0:
        return out.reshape(scores.shape), rank.reshape(scores.shape)
    iou = bbox_overlaps(boxes, boxes)                       # (nb, n, n)
    rows = torch.arange(nb, device=cur.device)
    zero = torch.zeros((), dtype=cur.dtype, device=cur.device)
    t = 0
    while t < max_out:
        for _ in range(min(_SOFT_NMS_CHECK_EVERY, max_out - t)):
            top, idx = cur.max(dim=1)       # first index among ties
            active = top >= min_score
            out[rows, idx] = torch.where(active, top, out[rows, idx])
            rank[rows, idx] = torch.where(
                active, torch.full_like(rank[rows, idx], t), rank[rows, idx])
            iou_row = iou[rows, idx]                         # (nb, n)
            if method == "linear":
                decay = torch.where(iou_row > iou_threshold, 1.0 - iou_row,
                                    torch.ones_like(iou_row))
            elif method == "gaussian":
                decay = torch.exp(-(iou_row * iou_row) / sigma)
            else:                                            # 'naive'
                decay = (iou_row <= iou_threshold).to(cur.dtype)
            new = cur * decay
            new[rows, idx] = 0.0
            new = torch.where(new < min_score, zero, new)
            cur = torch.where(active[:, None], new, cur)
            t += 1
        if not bool((cur.max(dim=1).values >= min_score).any()):
            break
    return (out.reshape(batch_shape + (n,)),
            rank.reshape(batch_shape + (n,)))


@torch.library.custom_op("bonai_tpu_torch::soft_nms", mutates_args=())
def _soft_nms_op(boxes: torch.Tensor, scores: torch.Tensor,
                 iou_threshold: float, sigma: float, min_score: float,
                 method: str, max_out: Optional[int],
                 valid: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return _soft_nms(boxes, scores, iou_threshold, sigma, min_score, method,
                     max_out, valid)


@_soft_nms_op.register_fake
def _(boxes, scores, iou_threshold, sigma, min_score, method, max_out,
      valid):
    return (torch.empty_like(scores),
            torch.empty_like(scores, dtype=torch.int32))


def multiclass_nms(multi_bboxes, multi_scores, score_thr, nms_cfg,
                   max_per_img, valid=None):
    """Per-class thresholded NMS over ``(B, N, C+1)`` scores (background
    last) and ``(B, N, 4)`` or ``(B, N, 4*C)`` boxes.

    Returns fixed-shape ``(B, max_per_img, 4)`` boxes, ``(B, max_per_img)``
    scores, int32 labels and a bool valid mask, sorted by score.
    """
    nb, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[-1] - 1
    class_agnostic = multi_bboxes.shape[-1] == 4
    nms_cfg = dict(nms_cfg)
    nms_type = nms_cfg.pop("type", "nms")
    iou_thr = nms_cfg.pop("iou_threshold", nms_cfg.pop("iou_thr", 0.5))
    all_boxes, all_scores, all_labels, all_keep = [], [], [], []
    for c in range(num_classes):
        cls_scores = multi_scores[..., c]
        cls_boxes = multi_bboxes if class_agnostic \
            else multi_bboxes[..., c * 4:(c + 1) * 4]
        cls_valid = cls_scores > score_thr
        if valid is not None:
            cls_valid = cls_valid & valid
        if nms_type == "soft_nms":
            new_scores, _ = soft_nms(
                cls_boxes, torch.where(cls_valid, cls_scores,
                                       torch.zeros_like(cls_scores)),
                iou_threshold=iou_thr, max_out=min(n, max_per_img),
                **{k: v for k, v in nms_cfg.items()
                   if k in ("sigma", "min_score", "method")})
            keep = new_scores > 0
            cls_scores = new_scores
        else:
            keep = nms(cls_boxes, cls_scores, iou_thr, valid=cls_valid)
        all_boxes.append(cls_boxes)
        all_scores.append(cls_scores)
        all_labels.append(torch.full((nb, n), c, dtype=torch.int32,
                                     device=multi_scores.device))
        all_keep.append(keep)
    boxes = torch.cat(all_boxes, dim=1)
    keep = torch.cat(all_keep, dim=1)
    scores = torch.where(keep, torch.cat(all_scores, dim=1),
                         torch.zeros_like(keep, dtype=multi_scores.dtype))
    labels = torch.cat(all_labels, dim=1)
    k = min(max_per_img, scores.shape[1])
    top_scores, top_idx = _sort_desc(scores)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    out_boxes = boxes.gather(1, top_idx[..., None].expand(nb, k, 4))
    out_labels = labels.gather(1, top_idx)
    if k < max_per_img:
        pad = max_per_img - k
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        out_labels = torch.nn.functional.pad(out_labels, (0, pad))
    return out_boxes, top_scores, out_labels, top_scores > 0
