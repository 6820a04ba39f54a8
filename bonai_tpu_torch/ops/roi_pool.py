"""RoIPool and deformable RoI pooling (counterpart of
``bonai_tpu/ops/roi_pool.py``: ``roi_pool``, ``deform_roi_pool``,
``multilevel_deform_roi_pool`` and ``DeformRoIPoolPack``).

The JAX package's formulation is kept, not mmcv's kernels:

- ``roi_pool`` takes each bin's max over a static ``samples x samples``
  grid of nearest cells of the RoI rounded to whole cells, where mmcv's
  RoIPool takes the max over the bin's whole dynamic extent;
- ``deform_roi_pool`` averages ``sampling_ratio^2`` bilinear samples per
  bin (zero outside the map), each bin's grid shifted by its offset times
  ``gamma`` times the RoI's width and height;
- ``multilevel_deform_roi_pool`` pools every RoI from every level and
  keeps the level the FPN rule gives it (``+1e-6`` inside the log, the
  area clipped at 1e-6).

Maps are NHWC ``(B, H, W, C)``, RoIs ``(R, 5)`` ``[batch_idx, x1, y1, x2,
y2]``.  All of it is plain PyTorch, as it is plain XLA in the JAX package:
no TPU kernel computes it.
"""

from __future__ import annotations

import torch
from torch import nn


def _bin_grid(rois, out_size, samples, quantise):
    """Each bin's sample coordinates along x and y, ``(R, S, samples)``
    each."""
    x1, y1, x2, y2 = (rois[:, i] for i in range(1, 5))
    if quantise:
        x1, y1, x2, y2 = (torch.round(v) for v in (x1, y1, x2, y2))
        w = (x2 - x1 + 1).clamp(min=1.0)
        h = (y2 - y1 + 1).clamp(min=1.0)
    else:
        w = (x2 - x1).clamp(min=1e-6)
        h = (y2 - y1).clamp(min=1e-6)
    s = out_size
    cell = (torch.arange(s, device=rois.device, dtype=rois.dtype) + 0.5) / s
    sub = (torch.arange(samples, device=rois.device, dtype=rois.dtype)
           + 0.5) / samples / s
    frac = cell[None, :, None] - 0.5 / s + sub[None, None, :]   # (1, S, k)
    return (x1[:, None, None] + w[:, None, None] * frac,
            y1[:, None, None] + h[:, None, None] * frac)


def _scaled(rois, spatial_scale):
    return torch.cat([rois[:, :1], rois[:, 1:] * spatial_scale], dim=1)


def roi_pool(feat, rois, out_size=7, spatial_scale=1.0, samples=4):
    """Quantised max RoI pooling: ``(R, S, S, C)``, each bin the max of a
    ``samples^2`` nearest grid."""
    b, h, w, c = feat.shape
    gx, gy = _bin_grid(_scaled(rois.float(), spatial_scale), out_size,
                       samples, quantise=True)
    xi = gx.floor().clamp(0, w - 1).long()
    yi = gy.floor().clamp(0, h - 1).long()
    bidx = rois[:, 0].long()
    idx = ((bidx[:, None, None, None, None] * h + yi[:, :, :, None, None])
           * w + xi[:, None, None, :, :])              # (R, Sy, ky, Sx, kx)
    vals = feat.reshape(b * h * w, c)[idx]
    return vals.amax(dim=(2, 4))


def deform_roi_pool(feat, rois, offsets, out_size=7, spatial_scale=1.0,
                    gamma=0.1, sampling_ratio=2):
    """Deformable RoI pooling of ``feat``: ``offsets`` ``(R, S, S, 2)``
    (dx, dy) move each bin's samples by ``offset * gamma * (roi_w,
    roi_h)``; returns the float32 ``(R, S, S, C)`` bin means."""
    b, h, w, c = feat.shape
    scaled = _scaled(rois.float(), spatial_scale)
    rw = (scaled[:, 3] - scaled[:, 1]).clamp(min=1e-6)
    rh = (scaled[:, 4] - scaled[:, 2]).clamp(min=1e-6)
    gx, gy = _bin_grid(scaled, out_size, sampling_ratio, quantise=False)
    offsets = offsets.float()
    ox = offsets[..., 0] * gamma * rw[:, None, None]             # (R, Sy, Sx)
    oy = offsets[..., 1] * gamma * rh[:, None, None]
    # the (R, Sy, ky, Sx, kx) lattice, each (Sy, Sx) bin moved by its offset
    fx = gx[:, None, None, :, :] + ox[:, :, None, :, None] - 0.5
    fy = gy[:, :, :, None, None] + oy[:, :, None, :, None] - 0.5
    x0, y0 = fx.floor(), fy.floor()
    ax, ay = fx - x0, fy - y0
    x0, y0 = x0.long(), y0.long()
    bidx = rois[:, 0].long()[:, None, None, None, None]
    flat = feat.reshape(b * h * w, c)
    out = 0.0
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = (bidx * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
            out = out + flat[idx].float() * (wy * wx * inside)[..., None]
    return out.mean(dim=(2, 4))


def multilevel_deform_roi_pool(feats, rois, pool_one, strides, roi_valid=None,
                               finest_scale=56):
    """``pool_one(feat, rois, spatial_scale)`` of every RoI at every level
    ``feats``, each RoI's kept from level ``floor(log2(sqrt(max(w h,
    1e-6)) / finest_scale + 1e-6))`` (clamped to the levels); invalid RoIs
    give zeros.  The result is in the levels' dtype (the box head's input
    dtype: the JAX head casts the float32 pooling to its compute dtype)."""
    w = rois[:, 3] - rois[:, 1]
    h = rois[:, 4] - rois[:, 2]
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6)).clamp(
        0, len(feats) - 1).long()
    out = 0.0
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        pooled = pool_one(feat, rois, 1.0 / stride)
        out = out + pooled * (lvl == i)[:, None, None, None]
    if roi_valid is not None:
        out = out * roi_valid[:, None, None, None]
    return out.to(feats[0].dtype)


class DeformRoIPoolPack(nn.Module):
    """mmcv's ``DeformRoIPoolPack`` (and with ``modulated``,
    ``ModulatedDeformRoIPoolPack``) as the JAX package computes it: a
    zero-offset :func:`deform_roi_pool` feeds ``offset_fc`` (two ReLU FCs
    of ``deform_fc_channels``, then ``2 * S * S`` offsets) and, modulated,
    ``mask_fc`` (one ReLU FC, then ``S * S`` masks through a float32
    sigmoid) for the
    second, deformable pass.

    The FCs hold mmcv's layout, so an mmdet checkpoint loads as it is:
    the first FCs read the first pass flattened as ``(C, S, S)`` and the
    offsets come out as ``(2, S, S)``.  The JAX package flattens ``(S, S,
    C)`` and reads ``(S, S, 2)``; the forward pass permutes the first
    pass and the offsets, and ``utils/weights.py::state_dict_from_jax``
    the JAX kernels, so the numbers are the JAX package's.  The last FC
    of each stack starts at zero, as in both references: the pack starts
    as plain average pooling."""

    def __init__(self, output_size=7, output_channels=256,
                 deform_fc_channels=1024, gamma=0.1, modulated=False):
        super().__init__()
        s = self.output_size = int(output_size)
        self.gamma = gamma
        flat = s * s * output_channels
        self.offset_fc = nn.Sequential(
            nn.Linear(flat, deform_fc_channels), nn.ReLU(),
            nn.Linear(deform_fc_channels, deform_fc_channels), nn.ReLU(),
            nn.Linear(deform_fc_channels, 2 * s * s))
        if modulated:
            self.mask_fc = nn.Sequential(
                nn.Linear(flat, deform_fc_channels), nn.ReLU(),
                nn.Linear(deform_fc_channels, s * s))

    def init_weights(self, gen):
        from ..models.init import xavier_uniform_, zeros_
        stacks = [self.offset_fc] + ([self.mask_fc]
                                     if hasattr(self, "mask_fc") else [])
        for stack in stacks:
            fcs = [m for m in stack if isinstance(m, nn.Linear)]
            for fc in fcs[:-1]:
                xavier_uniform_(fc.weight, gen)
                zeros_(fc.bias)
            zeros_(fcs[-1].weight)
            zeros_(fcs[-1].bias)

    def forward(self, feat, rois, spatial_scale):
        """``(R, S, S, C)`` float32 pooled features of ``rois`` on the NHWC
        map ``feat`` at ``spatial_scale``."""
        s, r = self.output_size, rois.shape[0]
        first = deform_roi_pool(feat, rois, rois.new_zeros((r, s, s, 2)), s,
                                spatial_scale, self.gamma)
        # the FCs' dtype (bfloat16 serving; float32 weights under autocast,
        # which casts itself)
        flat = first.permute(0, 3, 1, 2).reshape(r, -1).to(
            self.offset_fc[0].weight.dtype)
        off = self.offset_fc(flat).float().reshape(r, 2, s, s)
        out = deform_roi_pool(feat, rois, off.permute(0, 2, 3, 1), s,
                              spatial_scale, self.gamma)
        if hasattr(self, "mask_fc"):
            out = out * torch.sigmoid(self.mask_fc(flat).float()).reshape(
                r, s, s, 1)
        return out
