"""PointRend's coarse mask head, point head and point sampling
(counterpart of ``bonai_tpu/models/roi_heads/point_head.py``:
``CoarseMaskHead``, ``MaskPointHead``, ``bilinear_point_sample``,
``rel_roi_to_img_points``, ``fine_grained_point_feats``,
``point_targets_from_instance_masks``, ``uncertainty_points_train``,
``uncertainty_points_test``).

Points are bilinear four-corner gathers with zero padding, in the frame
of ``F.grid_sample(align_corners=False)`` (a point at ``p`` of a map of
size ``s`` samples pixel coordinate ``p * s - 0.5``), as in the JAX
package: no Pallas kernel there, plain PyTorch here.  The most uncertain
points are the top-k of ``-|logit|`` with ``jax.lax.top_k``'s tie rule
(the lower index first), which a stable descending sort gives: at the
heads' initial weights every coarse logit of a RoI is equal.

Keys are mmdetection v2.3's: the coarse head's ``convs.<i>.conv``,
``downsample_conv.conv``, ``fcs.<i>``, ``fc_logits``; the point head's
``fcs.<i>.conv`` and ``fc_logits``, 1x1 ``Conv1d`` weights ``(out, in,
1)`` applied to rows of points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_, normal_, xavier_uniform_, zeros_
from ..necks.fpn import ConvModule


def _top_k(x, k):
    """Indices of the ``k`` largest along the last dimension, ties in
    index order (``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _gather_bilinear(flat, base, height, width, x, y):
    """``sum_corners w * flat[base + yi * width + xi]`` over the four
    corners of continuous pixel coordinates ``x``, ``y`` ``(N, P)``, zero
    outside the ``height x width`` map whose first row in ``flat`` ``(rows,
    C)`` is ``base`` ``(N, 1)``.  Returns float32 ``(N, P, C)``."""
    x0, y0 = torch.floor(x), torch.floor(y)
    ax, ay = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    out = 0.0
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            xi, yi = x0 + dx, y0 + dy
            inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
            idx = base + yi.clamp(0, height - 1) * width \
                + xi.clamp(0, width - 1)
            out = out + flat[idx].float() * (wy * wx * inb)[..., None]
    return out


def bilinear_point_sample(maps, coords):
    """Each of ``maps`` ``(N, H, W[, C])`` sampled at its continuous pixel
    coordinates ``coords`` ``(N, P, 2)`` (x, y), zero outside: ``(N, P[,
    C])`` float32 (the JAX function, vmapped over ``N``)."""
    squeeze = maps.dim() == 3
    if squeeze:
        maps = maps[..., None]
    n, h, w, c = maps.shape
    base = torch.arange(n, device=maps.device)[:, None] * (h * w)
    out = _gather_bilinear(maps.reshape(n * h * w, c), base, h, w,
                           coords[..., 0], coords[..., 1])
    return out[..., 0] if squeeze else out


def rel_roi_to_img_points(rois, rel_pts):
    """Points ``(N, P, 2)`` relative to their RoIs ``(N, 5)`` ``[b, x1, y1,
    x2, y2]`` -> image coordinates."""
    x1, y1 = rois[:, 1, None], rois[:, 2, None]
    w = rois[:, 3, None] - x1
    h = rois[:, 4, None] - y1
    return torch.stack([x1 + rel_pts[..., 0] * w, y1 + rel_pts[..., 1] * h],
                       -1)


def fine_grained_point_feats(feat, rois, rel_pts, stride):
    """The FPN level ``feat`` ``(B, H, W, C)`` of ``stride`` sampled at
    RoI-relative points ``rel_pts`` ``(N, P, 2)`` of ``rois`` ``(N, 5)``
    (reference ``point_rend_roi_head.py:73-96``): float32 ``(N, P, C)``."""
    b, h, w, c = feat.shape
    img_pts = rel_roi_to_img_points(rois, rel_pts)
    base = rois[:, 0].long()[:, None] * (h * w)
    return _gather_bilinear(feat.reshape(b * h * w, c), base, h, w,
                            img_pts[..., 0] / stride - 0.5,
                            img_pts[..., 1] / stride - 0.5)


def coarse_point_sample(coarse, rel_pts):
    """Each RoI's coarse logits ``(N, K, h, w)`` at its RoI-relative points
    ``(N, P, 2)``: float32 ``(N, P, K)``."""
    _, _, h, w = coarse.shape
    return bilinear_point_sample(
        coarse.permute(0, 2, 3, 1),
        torch.stack([rel_pts[..., 0] * w - 0.5, rel_pts[..., 1] * h - 0.5],
                    -1))


def point_targets_from_instance_masks(rois, rel_pts, matched_boxes,
                                      matched_masks):
    """The GT value ``(N, P)`` at each point (reference
    ``mask_point_head.py:147-162``): the instance-local masks ``(N, M,
    M)`` of the matched GT boxes ``(N, 4)`` sampled bilinearly."""
    m = matched_masks.shape[-1]
    img_pts = rel_roi_to_img_points(rois, rel_pts)
    gx1 = matched_boxes[:, 0, None]
    gy1 = matched_boxes[:, 1, None]
    gw = (matched_boxes[:, 2, None] - gx1).clamp(min=1e-6)
    gh = (matched_boxes[:, 3, None] - gy1).clamp(min=1e-6)
    u = (img_pts[..., 0] - gx1) / gw * m - 0.5
    v = (img_pts[..., 1] - gy1) / gh * m - 0.5
    return bilinear_point_sample(matched_masks, torch.stack([u, v], -1))


def uncertainty_points_train(pts, fresh, coarse_logits, num_points,
                             importance_sample_ratio=0.75):
    """Training points ``(N, num_points, 2)`` (reference
    ``get_roi_rel_points_train``): of the oversampled random points ``pts``
    ``(N, n_samp, 2)``, the ``importance_sample_ratio * num_points`` most
    uncertain (``-|logit|`` of the coarse fg logits ``(N, h, w)`` there),
    then the fresh random points ``fresh`` ``(N, n_rand, 2)``.  ``pts``
    and ``fresh`` are uniforms on ``[0, 1)`` from the draw source."""
    _, h, w = coarse_logits.shape
    n_unc = int(importance_sample_ratio * num_points)
    logit = bilinear_point_sample(
        coarse_logits, torch.stack([pts[..., 0] * w - 0.5,
                                    pts[..., 1] * h - 0.5], -1))
    idx = _top_k(-logit.abs(), n_unc)
    chosen = pts.gather(1, idx[..., None].expand(-1, -1, 2))
    if num_points > n_unc:
        chosen = torch.cat([chosen, fresh], 1)
    return chosen


def uncertainty_points_test(logits, num_points):
    """The most uncertain cells of ``logits`` ``(N, h, w)`` (reference
    ``get_roi_rel_points_test``): their flat indices ``(N, K)`` and their
    centres' RoI-relative coordinates ``(N, K, 2)``, K = min(num_points,
    h * w)."""
    n, h, w = logits.shape
    idx = _top_k(-logits.reshape(n, h * w).abs(), min(num_points, h * w))
    xs = (idx % w).float()
    ys = (idx // w).float()
    return idx, torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)


class CoarseMaskHead(nn.Module):
    """``num_convs`` 3x3 convs, a 2x2 stride-2 conv, FCs and the logits of
    a ``roi_feat_size / 2`` square mask (reference
    ``coarse_mask_head.py:10-91`` at its default ``downsample_factor``,
    the only one the configs use)."""

    def __init__(self, num_convs=0, num_fcs=2, in_channels=256,
                 conv_out_channels=256, fc_out_channels=1024, num_classes=1,
                 roi_feat_size=14):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3) for i in range(num_convs)])
        self.downsample_conv = ConvModule(
            conv_out_channels if num_convs else in_channels,
            conv_out_channels, 2, stride=2, padding=0)
        self.num_classes = num_classes
        self.output_size = roi_feat_size // 2
        self.fcs = nn.ModuleList([
            nn.Linear(conv_out_channels * self.output_size ** 2 if i == 0
                      else fc_out_channels, fc_out_channels)
            for i in range(num_fcs)])
        self.fc_logits = nn.Linear(fc_out_channels,
                                   num_classes * self.output_size ** 2)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
                zeros_(m.bias)
        for fc in self.fcs:
            xavier_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        nn.init.constant_(self.fc_logits.weight, 0.001)
        zeros_(self.fc_logits.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, K, S/2, S/2)``
        mask logits; the FC input flattened in (C, H, W) order."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.downsample_conv(x)).flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        s = self.output_size
        return self.fc_logits(x).float().view(-1, self.num_classes, s, s)


class PointConv(nn.Module):
    """mmcv ``ConvModule`` of a 1x1 ``Conv1d``: ``.conv``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)


def _pointwise(conv, x):
    """A 1x1 ``Conv1d`` on rows of points ``(..., C)``."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class MaskPointHead(nn.Module):
    """The point MLP (reference ``mask_point_head.py:12-105``): ``num_fcs``
    pointwise layers with ReLU over the fine-grained features and the
    coarse logits at each point, the coarse logits joined again after each
    layer (``coarse_pred_each_layer``), then the logits."""

    def __init__(self, num_fcs=3, in_channels=256, fc_channels=256,
                 num_classes=1, coarse_pred_each_layer=True):
        super().__init__()
        self.coarse_pred_each_layer = coarse_pred_each_layer
        cin = in_channels + num_classes
        self.fcs = nn.ModuleList()
        for _ in range(num_fcs):
            self.fcs.append(PointConv(cin, fc_channels))
            cin = fc_channels + (num_classes if coarse_pred_each_layer
                                 else 0)
        self.fc_logits = nn.Conv1d(cin, num_classes, 1)

    def init_weights(self, gen):
        for fc in self.fcs:
            kaiming_fan_out_(fc.conv.weight, gen)
            zeros_(fc.conv.bias)
        normal_(self.fc_logits.weight, 0.001, gen)
        zeros_(self.fc_logits.bias)

    def forward(self, fine, coarse):
        """``fine`` ``(N, P, Cf)`` and ``coarse`` ``(N, P, K)`` point
        features -> float32 ``(N, P, K)`` point logits."""
        dtype = self.fc_logits.weight.dtype
        coarse = coarse.to(dtype)
        x = torch.cat([fine.to(dtype), coarse], -1)
        for fc in self.fcs:
            x = F.relu(_pointwise(fc.conv, x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse.to(x.dtype)], -1)
        return _pointwise(self.fc_logits, x).float()
