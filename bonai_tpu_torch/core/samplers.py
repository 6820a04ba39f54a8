"""Fixed-size random positive/negative sampling (counterpart of
``bonai_tpu/core/samplers.py::random_sample``).

The sample is a top-k over random keys, so its size is static: positives
are the top ``num * pos_fraction`` candidates by ``1 + u_pos``, negatives
fill the rest of the ``num`` slots by ``u_neg``, chosen positives rank
first.  The uniforms are an explicit input: :func:`generator_draws` makes
them from a ``torch.Generator``, and a test can hand in the numbers that
``jax.random`` draws instead.
"""

from __future__ import annotations

import torch

UNIFORM_LOW = 1e-4          # the JAX sampler's ``minval``


def generator_draws(generator=None):
    """A draw source for :func:`random_sample`: ``draw(shape, device)``
    returns ``(u_pos, u_neg)``, each uniform on ``[1e-4, 1)``, from
    ``generator`` (which must live on ``device``)."""
    def draw(shape, device):
        u = torch.rand((2, *shape), generator=generator, device=device)
        u = UNIFORM_LOW + (1.0 - UNIFORM_LOW) * u
        return u[0], u[1]
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
        inner = random_sample(assigned, n, pos_fraction, u_pos, u_neg,
                              neg_pos_ub,
                              _pos_cap=min(int(num * pos_fraction), n))
        return {k: torch.cat([v, v.new_zeros((*v.shape[:-1], num - n))],
                             dim=-1) for k, v in inner.items()}
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
