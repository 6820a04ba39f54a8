"""CornerNet's head, targets and decode (counterpart of
``bonai_tpu/models/dense_heads/corner_head.py``: ``gaussian_radius``,
``_paint_gaussians``, ``corner_targets``, ``BiCornerPool``, ``CornerHead``,
``local_maximum`` and ``decode_corners``, batched over images here).

A level's corner branch: ``BiCornerPool`` (two 3x3 conv-norm-ReLUs, each
through a corner pool, ``ops/layers.py::corner_pool``; their sum through
a 3x3 conv-norm; a 1x1 conv-norm of the input added, a ReLU, a 3x3
conv-norm-ReLU), then per output a 3x3 conv-ReLU and a 1x1 conv: heat
(bias ``-log(0.9 / 0.1)``), offset and embedding maps, float32.  The norms
are the JAX package's per-channel GroupNorm (epsilon 1e-6), where
mmdetection has BatchNorm (ROADMAP.md queue C).

Targets paint each GT's corner gaussians (radius from
:func:`gaussian_radius`, floored) as a max over the GTs, set the exact
corner cells to 1 and the sub-cell offsets there (the last GT wins a
shared cell); decoding keeps the 3x3 local maxima, the top ``k`` corners
a side, pairs them ``k x k`` (-1 where the embeddings differ by more than
``distance_threshold`` or the box is inverted) and keeps the top
``num_dets`` pairs.  Every top-k gives exact ties to the lower index, as
``jax.lax.top_k`` does: many pair scores are exactly -1.

Keys are mmdetection v2.3's: ``bbox_head.{tl,br}_pool.<l>.
{direction1_conv,direction2_conv,aftpool_conv,conv1,conv2}.{conv,bn}``
and ``bbox_head.{tl,br}_{heat,off,emb}.<l>.{0,1}.conv``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.layers import corner_pool
from ..init import kaiming_fan_out_, zeros_
from ..necks.fpn import ConvModule
from ..necks.nasfcos_fpn import channel_norm

HEAT_BIAS = -math.log((1 - 0.1) / 0.1)


def gaussian_radius(h, w, min_overlap=0.3):
    """Each GT's gaussian radius: the least of the three roots of
    mmdetection's ``gaussian_radius``."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt((b1 * b1 - 4 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt((b2 * b2 - 16 * c2).clamp(min=0.0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (-b3 + torch.sqrt((b3 * b3 - 4 * a3 * c3).clamp(min=0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def paint_gaussians(cx, cy, radius, valid, height, width):
    """``(B, G)`` corner cells, radii and validity -> ``(B, H, W)``: the
    max over the GTs of each one's gaussian (sigma a sixth of its
    diameter) cut to its ``(2r + 1)^2`` window."""
    ys = torch.arange(height, dtype=torch.float32,
                      device=cx.device)[None, None, :, None]
    xs = torch.arange(width, dtype=torch.float32,
                      device=cx.device)[None, None, None, :]
    dx = xs - cx[..., None, None]
    dy = ys - cy[..., None, None]
    r = radius[..., None, None]
    sigma = (2 * radius + 1) / 6.0
    g = torch.exp(-(dx * dx + dy * dy)
                  / (2.0 * sigma * sigma)[..., None, None])
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    g = g * inside * valid[..., None, None]
    return g.amax(dim=1)


def corner_targets(gt_bboxes, gt_valid, feat_h, feat_w, img_h, img_w,
                   min_overlap=0.3):
    """The corner targets of a batch (``(B, G, 4)`` padded GTs on an
    ``img_h x img_w`` input, one class): ``tl_heat``/``br_heat`` ``(B, H,
    W)``, ``tl_off``/``br_off`` ``(B, H, W, 2)`` and the corner cells
    ``tl_pos``/``br_pos`` ``(B, G, 2)`` (row, column)."""
    b, g = gt_valid.shape
    hw = feat_h * feat_w
    wr = feat_w / img_w
    hr = feat_h / img_h
    gt = gt_bboxes.float()
    sx1, sy1 = gt[..., 0] * wr, gt[..., 1] * hr
    sx2, sy2 = gt[..., 2] * wr, gt[..., 3] * hr
    lx = sx1.clamp(max=feat_w - 1).to(torch.int32)
    ty = sy1.clamp(max=feat_h - 1).to(torch.int32)
    rx = sx2.clamp(max=feat_w - 1).to(torch.int32)
    by = sy2.clamp(max=feat_h - 1).to(torch.int32)
    radius = torch.floor(gaussian_radius(torch.ceil(sy2 - sy1),
                                         torch.ceil(sx2 - sx1),
                                         min_overlap)).clamp(min=0.0)
    v = gt_valid.float()
    out = {}
    for side, x, y, fx, fy in (("tl", lx, ty, sx1, sy1),
                               ("br", rx, by, sx2, sy2)):
        heat = paint_gaussians(x.float(), y.float(), radius, v, feat_h,
                               feat_w)
        idx = (y * feat_w + x).long()
        exact = torch.zeros(b, hw, device=v.device).scatter_reduce(
            1, idx, v, "amax")
        out[f"{side}_heat"] = torch.maximum(heat, exact.reshape(
            b, feat_h, feat_w))
        # the offsets at the exact corner cells, the last valid GT of a
        # shared cell winning (the JAX scatter's order)
        upd = torch.stack([fx - x, fy - y], -1) * v[..., None]
        win = torch.where(gt_valid, idx, hw)
        last = torch.full((b, hw + 1), -1, dtype=torch.long,
                          device=v.device).scatter_reduce(
            1, win, torch.arange(g, device=v.device).expand(b, g), "amax")
        owner = last[:, :hw]
        off = torch.where((owner >= 0)[..., None], upd.gather(
            1, owner.clamp(min=0)[..., None].expand(b, hw, 2)),
            upd.new_zeros(()))
        out[f"{side}_off"] = off.reshape(b, feat_h, feat_w, 2)
        out[f"{side}_pos"] = torch.stack([y, x], -1).long()
    return out


class ConvNorm(nn.Module):
    """A conv without bias, the per-channel norm, an optional ReLU:
    ``.conv``, ``.bn``."""

    def __init__(self, cin, cout, k, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.bn = channel_norm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class BiCornerPool(nn.Module):
    def __init__(self, in_channels, directions, feat_channels=128,
                 out_channels=128):
        super().__init__()
        self.directions = tuple(directions)
        self.direction1_conv = ConvNorm(in_channels, feat_channels, 3)
        self.direction2_conv = ConvNorm(in_channels, feat_channels, 3)
        self.aftpool_conv = ConvNorm(feat_channels, out_channels, 3,
                                     relu=False)
        self.conv1 = ConvNorm(in_channels, out_channels, 1, relu=False)
        self.conv2 = ConvNorm(out_channels, out_channels, 3)

    def forward(self, x):
        d1 = corner_pool(self.direction1_conv(x), self.directions[0])
        d2 = corner_pool(self.direction2_conv(x), self.directions[1])
        return self.conv2(F.relu(self.aftpool_conv(d1 + d2)
                                 + self.conv1(x)))


class _Branch(nn.Sequential):
    """A 3x3 conv-ReLU and a 1x1 conv: ``.0.conv``, ``.1.conv``."""

    def __init__(self, channels, out_channels):
        super().__init__(ConvModule(channels, channels, 3),
                         ConvModule(channels, out_channels, 1))

    def forward(self, x):
        return self[1](F.relu(self[0](x))).float()


class CornerHead(nn.Module):
    """Per level (the last ``num_feat_levels`` backbone outputs) a dict of
    ``tl_heat``, ``br_heat``, ``tl_off``, ``br_off`` and, with
    ``corner_emb_channels``, ``tl_emb``, ``br_emb``: float32 NCHW maps."""

    def __init__(self, num_classes=1, in_channels=256, num_feat_levels=2,
                 corner_emb_channels=1):
        super().__init__()
        self.num_feat_levels = num_feat_levels
        outs = {"heat": num_classes, "off": 2}
        if corner_emb_channels > 0:
            outs["emb"] = corner_emb_channels
        self.outputs = tuple(outs)
        for side, dirs in (("tl", ("top", "left")),
                           ("br", ("bottom", "right"))):
            self.add_module(f"{side}_pool", nn.ModuleList(
                [BiCornerPool(in_channels, dirs, out_channels=in_channels)
                 for _ in range(num_feat_levels)]))
            for kind, c in outs.items():
                self.add_module(f"{side}_{kind}", nn.ModuleList(
                    [_Branch(in_channels, c)
                     for _ in range(num_feat_levels)]))

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
                if m.bias is not None:
                    zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                zeros_(m.bias)
        for side in ("tl", "br"):
            for branch in getattr(self, f"{side}_heat"):
                nn.init.constant_(branch[1].conv.bias, HEAT_BIAS)

    def level(self, x, i):
        """The outputs of level ``i`` on its feature map ``x``."""
        out = {}
        for side in ("tl", "br"):
            pooled = getattr(self, f"{side}_pool")[i](x)
            for kind in self.outputs:
                out[f"{side}_{kind}"] = getattr(self, f"{side}_{kind}")[i](
                    pooled)
        return out

    def forward(self, feats):
        return [self.level(x, i)
                for i, x in enumerate(feats[-self.num_feat_levels:])]


def local_maximum(heat, kernel=3):
    """Keep the ``(B, H, W)`` values that equal their window's max."""
    hmax = F.max_pool2d(heat[:, None], kernel, 1, (kernel - 1) // 2)[:, 0]
    return torch.where(hmax == heat, heat, heat.new_zeros(()))


def _top_k(x, k):
    """The ``k`` largest of each row, exact ties to the lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def decode_corners(out, img_h, img_w, k=100, kernel=3,
                   distance_threshold=0.5, num_dets=1000):
    """A level's outputs (NCHW) -> ``(B, num_dets, 4)`` boxes and ``(B,
    num_dets)`` scores (one class)."""
    b, _, h, w = out["tl_heat"].shape
    tl_scores, tl_inds = _top_k(local_maximum(torch.sigmoid(
        out["tl_heat"][:, 0]), kernel).reshape(b, -1), k)
    br_scores, br_inds = _top_k(local_maximum(torch.sigmoid(
        out["br_heat"][:, 0]), kernel).reshape(b, -1), k)

    def at(name, inds):
        m = out[name]
        return m.reshape(b, m.shape[1], -1).gather(
            2, inds[:, None].expand(b, m.shape[1], inds.shape[1]))

    tl_o, br_o = at("tl_off", tl_inds), at("br_off", br_inds)
    tl_x = (tl_inds % w).float() + tl_o[:, 0]
    tl_y = (tl_inds // w).float() + tl_o[:, 1]
    br_x = (br_inds % w).float() + br_o[:, 0]
    br_y = (br_inds // w).float() + br_o[:, 1]
    sx, sy = img_w / w, img_h / h
    zero = tl_x.new_zeros(())
    x1 = torch.maximum(tl_x[:, :, None] * sx, zero)
    y1 = torch.maximum(tl_y[:, :, None] * sy, zero)
    x2 = torch.maximum(br_x[:, None, :] * sx, zero)
    y2 = torch.maximum(br_y[:, None, :] * sy, zero)
    scores = (tl_scores[:, :, None] + br_scores[:, None, :]) / 2.0
    neg = scores.new_tensor(-1.0)
    if "tl_emb" in out:
        dists = (at("tl_emb", tl_inds)[:, 0, :, None]
                 - at("br_emb", br_inds)[:, 0, None, :]).abs()
        scores = torch.where(dists > distance_threshold, neg, scores)
    scores = torch.where((x2 <= x1) | (y2 <= y1), neg, scores)
    top_s, top_i = _top_k(scores.reshape(b, -1), num_dets)
    boxes = torch.stack(torch.broadcast_tensors(x1, y1, x2, y2),
                        -1).reshape(b, -1, 4)
    return boxes.gather(1, top_i[..., None].expand(b, num_dets, 4)), top_s
