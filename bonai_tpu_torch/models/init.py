"""Seeded weight initialisers drawing from an explicit ``torch.Generator``
(the roles of the JAX package's flax initialisers: kaiming fan-out for
convs, xavier for box FCs, small normals for the output layers)."""

from __future__ import annotations

import math

import torch


def normal_(t, std, gen):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def uniform_(t, bound, gen):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


def _fans(w):
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def kaiming_fan_out_(w, gen):
    """He normal over the fan-out (ResNet and mask-head convs)."""
    normal_(w, math.sqrt(2.0 / _fans(w)[1]), gen)


def xavier_uniform_(w, gen):
    fan_in, fan_out = _fans(w)
    uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def fan_in_uniform_(w, gen):
    """kaiming_uniform(a=1) over the fan-in (offset-head FCs)."""
    uniform_(w, math.sqrt(3.0 / _fans(w)[0]), gen)


def lecun_normal_(w, gen):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``, drawn by the inverse
    CDF."""
    std = math.sqrt(1.0 / _fans(w)[0]) / .87962566103423978
    lo = 0.5 * (1.0 + math.erf(-math.sqrt(2.0)))        # Phi(-2)
    u = torch.rand(w.shape, generator=gen) * (1.0 - 2.0 * lo) + lo
    with torch.no_grad():
        w.copy_(torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std)


def zeros_(t):
    with torch.no_grad():
        t.zero_()
