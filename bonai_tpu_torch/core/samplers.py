"""Fixed-size random positive/negative sampling (counterparts of
``bonai_tpu/core/samplers.py::random_sample`` and, for Libra R-CNN,
``iou_balanced_neg_sample``).

The sample is a top-k over random keys, so its size is static: positives
are the top ``num * pos_fraction`` candidates by ``1 + u_pos``, negatives
fill the rest of the ``num`` slots by ``u_neg``, chosen positives rank
first.  The uniforms are an explicit input: :func:`generator_draws` makes
them from a ``torch.Generator``, and a test can hand in the numbers that
``jax.random`` draws instead.  In a data-parallel run each rank draws from
a generator of its own (``apis/train.py::build_trainer`` seeds rank ``r``'s
from ``parallel.rank_seed(seed, r)``), as the JAX mesh step folds each
shard's key with its axis index.
"""

from __future__ import annotations

import torch

UNIFORM_LOW = 1e-4          # the JAX sampler's ``minval``


def generator_draws(generator=None):
    """A draw source, from ``generator`` (which must live on ``device``):

    - ``draw(shape, device, n=2)``, the samplers': ``n`` uniforms on
      ``[1e-4, 1)`` of ``shape`` (``(u_pos, u_neg)`` for
      :func:`random_sample`, ``(u_pos, u_neg, u_fill)`` for
      :func:`iou_balanced_neg_sample`);
    - ``draw.offsets(shape, device, amplitude)``, Grid R-CNN's jitter:
      uniforms on ``[-amplitude, amplitude)`` of ``shape`` ``(B, P, 4)``;
    - ``draw.points(shapes, device)``, PointRend's training points: one
      tensor of uniforms on ``[0, 1)`` for each shape.

    A test hands in a source of the same calls that returns the numbers
    ``jax.random`` draws instead."""
    def draw(shape, device, n=2):
        u = torch.rand((n, *shape), generator=generator, device=device)
        u = UNIFORM_LOW + (1.0 - UNIFORM_LOW) * u
        return tuple(u)

    def offsets(shape, device, amplitude):
        u = torch.rand(shape, generator=generator, device=device)
        return (2.0 * u - 1.0) * amplitude

    def points(shapes, device):
        return tuple(torch.rand(s, generator=generator, device=device)
                     for s in shapes)
    draw.offsets, draw.points = offsets, points
    return draw


def _top_k(x, k):
    """``jax.lax.top_k`` along the last dimension: ties keep index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _chosen(sel, mask):
    return torch.zeros_like(mask).scatter_(-1, sel, True) & mask


def random_sample(assigned, num, pos_fraction, u_pos, u_neg, neg_pos_ub=-1,
                  _pos_cap=None):
    """Sample ``num`` slots from an assignment ``(..., N)``.

    ``u_pos``/``u_neg`` are ``(..., N)`` uniforms on ``[1e-4, 1)``.  With
    fewer candidates than ``num`` every candidate is ranked and the outputs
    are padded to ``num`` (the positive cap stays ``num * pos_fraction``).

    Returns a dict of ``(..., num)`` tensors: ``inds`` (candidate index;
    padded slots point at 0), ``is_pos``, ``valid`` and ``pos_gt_inds``
    (0-based matched GT of a positive slot).
    """
    n = assigned.shape[-1]
    if num > n:
        return _pad_to(random_sample(
            assigned, n, pos_fraction, u_pos, u_neg, neg_pos_ub,
            _pos_cap=min(int(num * pos_fraction), n)), num)
    num_expected_pos = (int(num * pos_fraction) if _pos_cap is None
                        else _pos_cap)
    is_pos = assigned > 0
    is_neg = assigned == 0
    zero = u_pos.new_tensor(0.0)
    _, pos_sel = _top_k(torch.where(is_pos, 1.0 + u_pos, zero),
                        num_expected_pos)
    chosen_pos = _chosen(pos_sel, is_pos)
    max_neg = neg_pos_ub * num_expected_pos if neg_pos_ub > 0 else num
    _, neg_sel = _top_k(torch.where(is_neg, u_neg, zero), min(max_neg, num))
    chosen_neg = _chosen(neg_sel, is_neg)
    final_key = torch.where(chosen_pos, 2.0 + u_pos,
                            torch.where(chosen_neg, u_neg, zero))
    key_vals, inds = _top_k(final_key, num)
    valid = key_vals > 0.0
    return {"inds": inds, "is_pos": (key_vals > 2.0) & valid, "valid": valid,
            "pos_gt_inds": (assigned.gather(-1, inds) - 1).clamp(min=0)}


def _pad_to(inner, num):
    return {k: torch.cat([v, v.new_zeros((*v.shape[:-1],
                                          num - v.shape[-1]))], dim=-1)
            for k, v in inner.items()}


def iou_balanced_neg_sample(assigned, max_overlaps, num, pos_fraction, u_pos,
                            u_neg, u_fill, floor_thr=-1, floor_fraction=0.0,
                            num_bins=3):
    """Libra R-CNN's IoU-balanced negative sampling of an assignment
    ``(..., N)`` with the candidates' max IoU ``max_overlaps``.

    Positives are drawn as in :func:`random_sample`.  The negatives'
    quota (``num`` less the positives' cap) is split: ``floor_fraction``
    of it from the negatives under ``floor_thr`` (with ``floor_thr >=
    0``), the rest in ``per_bin = max(quota // num_bins, 1)`` draws from
    each of ``num_bins`` equal IoU intervals between the base (``floor_thr``,
    -1 by default) and the largest negative IoU.  Shortfall is refilled
    from every negative by ``u_fill``: quota positives rank above quota
    negatives above the refill band.  The three uniforms are ``(...,
    N)``; with fewer candidates than ``num`` every candidate is ranked
    and the outputs are padded to ``num``.  Returns the dict of
    :func:`random_sample`."""
    n = assigned.shape[-1]
    if num > n:
        return _pad_to(iou_balanced_neg_sample(
            assigned, max_overlaps, n, pos_fraction, u_pos, u_neg, u_fill,
            floor_thr, floor_fraction, num_bins), num)
    num_expected_pos = int(num * pos_fraction)
    is_pos = assigned > 0
    is_neg = assigned == 0
    zero = u_pos.new_tensor(0.0)
    _, pos_sel = _top_k(torch.where(is_pos, 1.0 + u_pos, zero),
                        min(num_expected_pos, n))
    chosen_pos = _chosen(pos_sel, is_pos)
    chosen_neg = _iou_balanced_neg_mask(
        u_neg, is_neg, max_overlaps, num - num_expected_pos, floor_thr,
        floor_fraction, num_bins)
    pos_band = torch.where(chosen_pos, 3.0 + u_pos, zero)
    neg_band = torch.where(chosen_neg, 1.0 + u_neg,
                           torch.where(is_neg, u_fill, zero))
    key_vals, inds = _top_k(torch.maximum(pos_band, neg_band), num)
    valid = key_vals > 0.0
    return {"inds": inds, "is_pos": (key_vals > 2.0) & valid, "valid": valid,
            "pos_gt_inds": (assigned.gather(-1, inds) - 1).clamp(min=0)}


def _iou_balanced_neg_mask(u_neg, is_neg, max_overlaps, num_expected_neg,
                           floor_thr, floor_fraction, num_bins):
    """The negatives :func:`iou_balanced_neg_sample` draws by quota."""
    n = is_neg.shape[-1]
    if floor_thr >= 0:
        in_floor = is_neg & ((max_overlaps < floor_thr) if floor_thr > 0
                             else (max_overlaps <= 0.0))
        num_floor = int(num_expected_neg * floor_fraction)
    else:
        in_floor = torch.zeros_like(is_neg)
        num_floor = 0
    in_iou_set = is_neg & ~in_floor
    base = float(floor_thr)          # the reference keeps -1 as the base
    num_iou = num_expected_neg - num_floor
    neg_iou = torch.where(is_neg, max_overlaps,
                          max_overlaps.new_tensor(-float("inf")))
    max_iou = torch.where(in_iou_set, neg_iou, neg_iou.new_tensor(base)) \
        .max(dim=-1, keepdim=True).values.clamp(min=base + 1e-6)
    interval = (max_iou - base) / num_bins
    per_bin = max(num_iou // num_bins, 1)
    zero = u_neg.new_tensor(0.0)
    chosen = torch.zeros_like(is_neg)
    for i in range(num_bins):
        lo = base + i * interval
        hi = base + (i + 1) * interval
        in_bin = in_iou_set & (max_overlaps >= lo)
        if i != num_bins - 1:
            in_bin &= max_overlaps < hi
        _, sel = _top_k(torch.where(in_bin, u_neg, zero), min(per_bin, n))
        chosen |= _chosen(sel, in_bin)
    if num_floor > 0:
        _, sel = _top_k(torch.where(in_floor, u_neg, zero),
                        min(num_floor, n))
        chosen |= _chosen(sel, in_floor)
    return chosen
