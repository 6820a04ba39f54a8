"""Fixed-size positive/negative sampling (counterparts of
``bonai_tpu/core/samplers.py``: ``random_sample``; for Libra R-CNN
``iou_balanced_neg_sample``, ``instance_balanced_pos_sample`` and
``combined_sample``; the loss- and score-ranked ``ohem_sample`` and
``score_hlr_neg_sample``, whose keys come from the box head).

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
      :func:`random_sample`, :func:`instance_balanced_pos_sample` and
      :func:`score_hlr_neg_sample`, ``(u_pos, u_neg, u_fill)`` for
      :func:`iou_balanced_neg_sample` and :func:`combined_sample`);
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
    chosen_pos = _random_mask(u_pos, is_pos, num_expected_pos)
    max_neg = neg_pos_ub * num_expected_pos if neg_pos_ub > 0 else num
    _, neg_sel = _top_k(torch.where(is_neg, u_neg, zero), min(max_neg, num))
    chosen_neg = _chosen(neg_sel, is_neg)
    return _banded(assigned, torch.where(chosen_pos, 2.0 + u_pos, zero),
                   torch.where(chosen_neg, u_neg, zero), num)


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
    chosen_pos = _random_mask(u_pos, is_pos, num_expected_pos)
    chosen_neg = _iou_balanced_neg_mask(
        u_neg, is_neg, max_overlaps, num - num_expected_pos, floor_thr,
        floor_fraction, num_bins)
    return _banded(assigned, torch.where(chosen_pos, 3.0 + u_pos, zero),
                   torch.where(chosen_neg, 1.0 + u_neg,
                               torch.where(is_neg, u_fill, zero)), num)


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


def within_group_rank(group_ids, order_key):
    """Rank of each element within its group when sorted by ``group_ids``
    then ``order_key`` (both ``(..., N)``, ranked along the last
    dimension): one stable sort of the float32 key ``2 * group +
    order_key`` and a segmented count, as
    ``bonai_tpu/core/samplers.py::_within_group_rank`` ranks them (equal
    keys keep their index order, as ``jnp.argsort`` does)."""
    n = group_ids.shape[-1]
    key = group_ids.float() * 2.0 + order_key
    order = torch.sort(key, dim=-1, stable=True).indices
    g = group_ids.gather(-1, order)
    arange = torch.arange(n, device=key.device).expand_as(g)
    changed = torch.ones_like(g, dtype=torch.bool)
    changed[..., 1:] = g[..., 1:] != g[..., :-1]
    starts = torch.cummax(torch.where(changed, arange, 0), dim=-1).values
    return torch.zeros_like(order).scatter_(-1, order, arange - starts)


def _banded(assigned, pos_band, neg_band, num):
    """The ``num`` slots of the largest of the banded keys (0: never
    chosen; negatives below 2, positives above): the sampler's dict."""
    key_vals, inds = _top_k(torch.maximum(pos_band, neg_band), num)
    valid = key_vals > 0.0
    return {"inds": inds, "is_pos": (key_vals > 2.0) & valid, "valid": valid,
            "pos_gt_inds": (assigned.gather(-1, inds) - 1).clamp(min=0)}


def _random_mask(u, mask, k):
    """``k`` members of ``mask`` drawn by ``1 + u``."""
    _, sel = _top_k(torch.where(mask, 1.0 + u, u.new_tensor(0.0)),
                    min(k, mask.shape[-1]))
    return _chosen(sel, mask)


def _instance_balanced_pos_mask(u_pos, is_pos, assigned, num_expected_pos):
    """The positives of the instance-balanced quota: ``round(expected /
    num_gts) + 1`` drawn from each matched GT (by ``u_pos`` within the
    GT), the rest refilled from the other positives, ``expected`` in all."""
    n = is_pos.shape[-1]
    gids = torch.where(is_pos, assigned, 0).long()
    rank = within_group_rank(gids, u_pos)
    present = torch.zeros((*gids.shape[:-1], n + 1), dtype=torch.bool,
                          device=gids.device).scatter_(-1, gids, True)
    num_gts = present[..., 1:].sum(-1, keepdim=True).clamp(min=1)
    num_per_gt = torch.round(num_expected_pos / num_gts).long() + 1
    in_quota = is_pos & (rank < num_per_gt)
    zero = u_pos.new_tensor(0.0)
    _, sel = _top_k(torch.where(in_quota, 5.0 + u_pos,
                                torch.where(is_pos, 3.0 + u_pos, zero)),
                    min(num_expected_pos, n))
    return _chosen(sel, is_pos)


def instance_balanced_pos_sample(assigned, num, pos_fraction, u_pos, u_neg):
    """Libra R-CNN's ``InstanceBalancedPosSampler`` of an assignment
    ``(..., N)``: the positives balanced over the GTs they match
    (:func:`_instance_balanced_pos_mask`), the negatives drawn by
    ``u_neg``.  With fewer candidates than ``num`` the candidates are
    sampled as ``num = N`` (the positive cap ``N * pos_fraction``, as the
    JAX sampler) and the outputs padded.  Returns the dict of
    :func:`random_sample`."""
    n = assigned.shape[-1]
    if num > n:
        return _pad_to(instance_balanced_pos_sample(
            assigned, n, pos_fraction, u_pos, u_neg), num)
    is_pos, is_neg = assigned > 0, assigned == 0
    zero = u_pos.new_tensor(0.0)
    chosen_pos = _instance_balanced_pos_mask(u_pos, is_pos, assigned,
                                             int(num * pos_fraction))
    return _banded(assigned, torch.where(chosen_pos, 3.0 + u_pos, zero),
                   torch.where(is_neg, u_neg, zero), num)


def combined_sample(assigned, max_overlaps, num, pos_fraction, u_pos, u_neg,
                    u_fill, pos_cfg=None, neg_cfg=None):
    """``CombinedSampler``: a positive sampler (``RandomSampler`` or
    ``InstanceBalancedPosSampler``) and a negative one (``RandomSampler``
    or ``IoUBalancedNegSampler``, its ``floor_thr``, ``floor_fraction``
    and ``num_bins``) fill their quotas; negatives short of theirs are
    refilled by ``u_fill``.  Returns the dict of :func:`random_sample`."""
    n = assigned.shape[-1]
    if num > n:
        return _pad_to(combined_sample(
            assigned, max_overlaps, n, pos_fraction, u_pos, u_neg, u_fill,
            pos_cfg, neg_cfg), num)
    pos_cfg, neg_cfg = dict(pos_cfg or {}), dict(neg_cfg or {})
    num_expected_pos = int(num * pos_fraction)
    is_pos, is_neg = assigned > 0, assigned == 0
    zero = u_pos.new_tensor(0.0)
    if pos_cfg.get("type", "RandomSampler") == "InstanceBalancedPosSampler":
        chosen_pos = _instance_balanced_pos_mask(u_pos, is_pos, assigned,
                                                 num_expected_pos)
    else:
        chosen_pos = _random_mask(u_pos, is_pos, num_expected_pos)
    if neg_cfg.get("type", "RandomSampler") == "IoUBalancedNegSampler":
        chosen_neg = _iou_balanced_neg_mask(
            u_neg, is_neg, max_overlaps, num - num_expected_pos,
            neg_cfg.get("floor_thr", -1), neg_cfg.get("floor_fraction", 0.0),
            neg_cfg.get("num_bins", 3))
    else:
        chosen_neg = _random_mask(u_neg, is_neg, num - num_expected_pos)
    return _banded(assigned, torch.where(chosen_pos, 3.0 + u_pos, zero),
                   torch.where(chosen_neg, 1.0 + u_neg,
                               torch.where(is_neg, u_fill, zero)), num)


def ohem_sample(loss, assigned, num, pos_fraction, neg_pos_ub=-1,
                _pos_cap=None):
    """Online hard example mining: :func:`random_sample` with the
    candidates' classification ``loss`` ``(..., N)`` (no gradient) in
    place of the uniforms, squashed to ``(loss + 1e-6) / (1 + loss +
    1e-6)`` as the JAX sampler ranks it: the hardest positives up to the
    cap, the hardest negatives after them."""
    key = (loss + 1e-6) / (1.0 + loss + 1e-6)
    return random_sample(assigned, num, pos_fraction, key, key, neg_pos_ub,
                         _pos_cap)


def score_hlr_neg_sample(assigned, max_fg_score, num, pos_fraction, u_pos,
                         u_neg, score_thr=0.05, bias=0.0, k=0.5):
    """PISA's ``ScoreHLRSampler`` as the JAX package computes it: the
    positives drawn by ``u_pos``; the negatives whose largest foreground
    score ``max_fg_score`` ``(..., N)`` passes ``score_thr``, hardest
    first, then random ones by ``u_neg``; and ``neg_label_weights``, the
    ISR-N weight ``(bias + (1 - bias) (1 - rank / up_bound)) ** k`` of each
    sampled negative (``rank`` its score's among the valid negatives,
    ``up_bound`` the larger of the negative quota and their count; a
    randomly drawn one takes the smallest weight of those ranked), 1 for
    the other slots.  The reference's hierarchical rank within NMS groups
    is the global score rank here, as in the JAX sampler."""
    n = assigned.shape[-1]
    if num > n:
        inner = score_hlr_neg_sample(assigned, max_fg_score, n, pos_fraction,
                                     u_pos, u_neg, score_thr, bias, k)
        w = inner.pop("neg_label_weights")
        out = _pad_to(inner, num)
        out["neg_label_weights"] = torch.cat(
            [w, w.new_ones((*w.shape[:-1], num - n))], dim=-1)
        return out
    num_expected_neg = num - int(num * pos_fraction)
    is_pos, is_neg = assigned > 0, assigned == 0
    zero = u_pos.new_tensor(0.0)
    chosen_pos = _random_mask(u_pos, is_pos, int(num * pos_fraction))
    hlr_valid = is_neg & (max_fg_score > score_thr)
    s = max_fg_score.clamp(0.0, 1.0) * (1 - 1e-3)
    chosen_hlr = _random_mask(s, hlr_valid, num_expected_neg)
    out = _banded(assigned, torch.where(chosen_pos, 3.0 + u_pos, zero),
                  torch.where(chosen_hlr, 1.0 + s,
                              torch.where(is_neg, u_neg, zero)), num)
    # each valid negative's rank: the count of valid scores above its own
    ranked = torch.sort(torch.where(hlr_valid, s, s.new_tensor(
        float("inf"))), dim=-1).values
    num_valid = hlr_valid.sum(-1, keepdim=True)
    mine = torch.where(hlr_valid, s, s.new_tensor(-1.0))
    rank = (num_valid - torch.searchsorted(ranked, mine, right=True)).float()
    up_bound = num_valid.float().clamp(min=float(num_expected_neg))
    w = (bias + (1.0 - bias) * ((up_bound - rank) / up_bound)) ** k
    min_w = torch.where(chosen_hlr, w, w.new_tensor(float("inf"))).min(
        -1, keepdim=True).values
    min_w = torch.where(chosen_hlr.any(-1, keepdim=True), min_w,
                        min_w.new_tensor(1.0))
    w = torch.where(chosen_hlr, w, min_w)
    out["neg_label_weights"] = torch.where(
        out["valid"] & ~out["is_pos"], w.gather(-1, out["inds"]),
        w.new_tensor(1.0))
    return out
