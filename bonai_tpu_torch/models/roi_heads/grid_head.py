"""Grid R-CNN's grid head and its plain functions (counterpart of
``bonai_tpu/models/roi_heads/grid_head.py``: ``GridHead``,
``jitter_boxes``, ``grid_targets``, ``grid_decode_boxes``, and the port's
own copies of ``sub_regions_np`` and ``grid_factors_np``).

The head's layout and keys are mmdetection v2.3's
(``mask_heads/grid_head.py``): ``convs.<i>.{conv,gn}``,
``forder_trans.<i>.<j>`` and ``sorder_trans.<i>.<j>`` (a 5x5 depthwise
conv ``.0`` and a 1x1 conv ``.1`` per edge of the 4-neighbour graph of
the grid, in the x-major point order), and the grouped ``deconv1``,
``norm1``, ``deconv2`` (one group per grid point), which the fused and the
unfused paths share.  Each fusion order runs its edges as one depthwise
and one grouped 1x1 convolution over the edges' source slices, with the
per-edge weights concatenated: the same function as one module an edge.
The GroupNorms take flax's epsilon, 1e-6 (mmdetection's torch default is
1e-5: ROADMAP.md queue C), and the convs before them keep their bias, as
in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_, normal_, zeros_

GN_EPS = 1e-6                   # flax's GroupNorm epsilon
CONV_GN_GROUPS = 36


def sub_regions_np(grid_points, whole_map_size):
    """Each point's half-size sub-window origin ``(G, 2)`` (x, y)
    (reference ``calc_sub_regions``; x_idx = i // gs, y_idx = i % gs)."""
    gs = int(np.sqrt(grid_points))
    half = whole_map_size // 4 * 2

    def origin(idx):
        if idx == 0:
            return 0
        if idx == gs - 1:
            return half
        return max(int((idx / (gs - 1) - 0.25) * whole_map_size), 0)
    return np.asarray([(origin(i // gs), origin(i % gs))
                       for i in range(grid_points)], np.int32)


def grid_factors_np(grid_points):
    """Each point's interpolation factors ``(G, 2)`` (fx, fy) between the
    GT box's corners (reference ``get_targets``)."""
    gs = int(np.sqrt(grid_points))
    return np.asarray([(1 - (j // gs) / (gs - 1), 1 - (j % gs) / (gs - 1))
                       for j in range(grid_points)], np.float32)


def _neighbors(gs):
    """The 4-neighbours of each point of the ``gs x gs`` grid, x-major."""
    out = []
    for i in range(gs):
        for j in range(gs):
            n = []
            if i > 0:
                n.append((i - 1) * gs + j)
            if j > 0:
                n.append(i * gs + j - 1)
            if j < gs - 1:
                n.append(i * gs + j + 1)
            if i < gs - 1:
                n.append((i + 1) * gs + j)
            out.append(n)
    return out


class ConvGN(nn.Module):
    """mmcv ``ConvModule`` of a biased conv, a GroupNorm and a ReLU:
    ``.conv`` and ``.gn``."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding=1)
        self.gn = nn.GroupNorm(CONV_GN_GROUPS, cout, eps=GN_EPS)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


def _transition(c):
    return nn.Sequential(nn.Conv2d(c, c, 5, padding=2, groups=c),
                         nn.Conv2d(c, c, 1))


class GridHead(nn.Module):
    """``num_convs`` 3x3 conv-GN-ReLUs (the first at stride 2), the
    first- and second-order fusion of the point features over the grid's
    edges, and the shared grouped deconvs (4x4, stride 2, twice) to one
    heatmap per point."""

    def __init__(self, grid_points=9, num_convs=8, roi_feat_size=14,
                 in_channels=256, point_feat_channels=64):
        super().__init__()
        gs = math.isqrt(grid_points)
        if gs * gs != grid_points:
            raise ValueError(f"grid_points={grid_points} is not a square")
        self.grid_points = grid_points
        self.whole_map_size = roi_feat_size * 4
        c = point_feat_channels
        cout = grid_points * c
        self.convs = nn.Sequential(*(
            ConvGN(in_channels if i == 0 else cout, cout, 2 if i == 0 else 1)
            for i in range(num_convs)))
        neighbors = _neighbors(gs)
        self.forder_trans = nn.ModuleList(
            nn.ModuleList(_transition(c) for _ in ns) for ns in neighbors)
        self.sorder_trans = nn.ModuleList(
            nn.ModuleList(_transition(c) for _ in ns) for ns in neighbors)
        self.deconv1 = nn.ConvTranspose2d(cout, cout, 4, 2, 1,
                                          groups=grid_points)
        self.norm1 = nn.GroupNorm(grid_points, cout, eps=GN_EPS)
        self.deconv2 = nn.ConvTranspose2d(cout, grid_points, 4, 2, 1,
                                          groups=grid_points)
        # edge e runs from point src[e] into point dst[e]; ``fuse`` sums
        # each point's incoming edges
        src, dst = zip(*((n, i) for i, ns in enumerate(neighbors)
                         for n in ns))
        fuse = torch.zeros(grid_points, len(src))
        fuse[list(dst), list(range(len(src)))] = 1.0
        self.register_buffer("edge_src", torch.tensor(src), persistent=False)
        self.register_buffer("edge_fuse", fuse, persistent=False)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
                zeros_(m.bias)
            elif isinstance(m, nn.ConvTranspose2d):
                normal_(m.weight, 0.001, gen)
                zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                zeros_(m.bias)
        nn.init.constant_(self.deconv2.bias, -math.log(0.99 / 0.01))

    def _fuse(self, trans, src):
        """Each point's sum over its incoming edges of the edge's
        transition of the source point's features; ``src`` ``(N, G, c, h,
        w)``."""
        edges = [t for ts in trans for t in ts]
        n, _, c, h, w = src.shape
        e = len(edges)
        y = src[:, self.edge_src].reshape(n, e * c, h, w)
        y = F.conv2d(y, torch.cat([t[0].weight for t in edges]),
                     torch.cat([t[0].bias for t in edges]), padding=2,
                     groups=e * c)
        y = F.conv2d(y, torch.cat([t[1].weight for t in edges]),
                     torch.cat([t[1].bias for t in edges]), groups=e)
        return torch.einsum("pe,nechw->npchw", self.edge_fuse.to(y.dtype),
                            y.view(n, e, c, h, w))

    def _deconv(self, x):
        return self.deconv2(F.relu(self.norm1(self.deconv1(x))))

    def forward(self, x, unfused=False):
        """``(N, S, S, Cin)`` RoI features -> float32 heatmap logits
        ``{"fused", "unfused"}``, each ``(N, G, 4S/2, 4S/2)``; ``unfused``
        (training) runs the deconvs on the unfused features too, else it
        is the fused map."""
        x = self.convs(x.permute(0, 3, 1, 2))
        n, _, h, w = x.shape
        parts = x.view(n, self.grid_points, -1, h, w)
        x_fo = parts + self._fuse(self.forder_trans, parts)
        x_so = parts + self._fuse(self.sorder_trans, x_fo)
        fused = self._deconv(x_so.reshape(n, -1, h, w)).float()
        return {"fused": fused,
                "unfused": self._deconv(x).float() if unfused else fused}


def jitter_boxes(offsets, boxes, img_shape):
    """Grid R-CNN's random jitter of the positive boxes ``(B, P, 4)``
    (reference ``grid_roi_head.py:38-62``): ``offsets`` ``(B, P, 4)``,
    uniforms on ``[-0.15, 0.15)`` from the draw source, move each centre by
    its width and height times the first two and scale them by one plus
    the last two; the boxes are clipped to ``[0, w - 1] x [0, h - 1]`` of
    their image's ``img_shape`` ``(B, 2)``."""
    cxcy = (boxes[..., 2:4] + boxes[..., :2]) * 0.5
    wh = (boxes[..., 2:4] - boxes[..., :2]).abs()
    new_c = cxcy + wh * offsets[..., :2]
    new_wh = wh * (1 + offsets[..., 2:])
    out = torch.cat([new_c - new_wh * 0.5, new_c + new_wh * 0.5], -1)
    img_shape = img_shape.to(out.dtype)
    h, w = img_shape[:, 0, None] - 1, img_shape[:, 1, None] - 1
    return torch.stack([torch.minimum(out[..., k].clamp(min=0), hw)
                        for k, hw in enumerate((w, h, w, h))], -1)


def grid_targets(pos_boxes, gt_boxes, grid_points, whole_map_size,
                 pos_radius=1):
    """The heatmap targets ``(P, G, half, half)`` of boxes ``(P, 4)`` and
    their GTs ``(P, 4)`` (reference ``get_targets``): a disc of
    ``pos_radius`` around each grid point of the GT box, in the 2x
    expanded box's frame, cut to the point's half-size sub-window; all
    zero where the expanded box is at most ``sqrt(G)`` px wide or high."""
    dev = pos_boxes.device
    half = whole_map_size // 4 * 2
    sub = torch.from_numpy(sub_regions_np(grid_points, whole_map_size)).to(dev)
    fac = torch.from_numpy(grid_factors_np(grid_points)).to(dev)
    w = pos_boxes[:, 2] - pos_boxes[:, 0]
    h = pos_boxes[:, 3] - pos_boxes[:, 1]
    ex1 = pos_boxes[:, 0] - w * 0.5
    ey1 = pos_boxes[:, 1] - h * 0.5
    ew, eh = 2 * w, 2 * h
    gx = fac[None, :, 0] * gt_boxes[:, 0, None] \
        + (1 - fac[None, :, 0]) * gt_boxes[:, 2, None]          # (P, G)
    gy = fac[None, :, 1] * gt_boxes[:, 1, None] \
        + (1 - fac[None, :, 1]) * gt_boxes[:, 3, None]
    cx = torch.floor((gx - ex1[:, None]) / ew[:, None].clamp(min=1e-6)
                     * whole_map_size)
    cy = torch.floor((gy - ey1[:, None]) / eh[:, None].clamp(min=1e-6)
                     * whole_map_size)
    cells = torch.arange(half, dtype=torch.float32, device=dev)
    xs = cells[None, None, :] + sub[None, :, 0, None]           # (1, G, half)
    ys = cells[None, None, :] + sub[None, :, 1, None]
    dx2 = (xs - cx[..., None]) ** 2                             # (P, G, half)
    dy2 = (ys - cy[..., None]) ** 2
    disc = (dy2[..., :, None] + dx2[..., None, :]) <= pos_radius ** 2
    gs = math.isqrt(grid_points)
    ok = (ew > gs) & (eh > gs)
    return disc.float() * ok[:, None, None, None]


def grid_decode_boxes(det_boxes, heatmap, grid_points, whole_map_size,
                      img_shape):
    """Grid-point voting (reference ``get_bboxes``): boxes ``(M, 4)`` from
    their heatmap logits ``(M, G, half, half)``.  Each point is its map's
    argmax (the first on ties); each side of the box is the mean of its
    border points weighted by their probabilities, clipped to ``[0, w] x
    [0, h]`` of each box's ``img_shape`` ``(M, 2)``."""
    gs = math.isqrt(grid_points)
    half = whole_map_size // 4 * 2
    sub = torch.from_numpy(sub_regions_np(grid_points, whole_map_size)).to(
        det_boxes.device)
    prob = torch.sigmoid(heatmap.float()).reshape(heatmap.shape[0],
                                                  grid_points, half * half)
    best = prob.argmax(dim=2)                                   # (M, G)
    score = prob.gather(2, best[..., None])[..., 0]
    xs = (best % half).float() + sub[None, :, 0]
    ys = (best // half).float() + sub[None, :, 1]
    w = (det_boxes[:, 2] - det_boxes[:, 0])[:, None]
    h = (det_boxes[:, 3] - det_boxes[:, 1])[:, None]
    # (pos + 0.5) / half * w maps the half-size window onto the 2x
    # expanded box's span
    abs_x = (xs + 0.5) / half * w + (det_boxes[:, 0, None] - w * 0.5)
    abs_y = (ys + 0.5) / half * h + (det_boxes[:, 1, None] - h * 0.5)

    def vote(vals, idx):
        s = score[:, idx]
        return (vals[:, idx] * s).sum(1) / s.sum(1).clamp(min=1e-6)
    x1 = vote(abs_x, list(range(gs)))
    y1 = vote(abs_y, [i * gs for i in range(gs)])
    x2 = vote(abs_x, [grid_points - gs + i for i in range(gs)])
    y2 = vote(abs_y, [(i + 1) * gs - 1 for i in range(gs)])
    img_shape = img_shape.float()
    hh, ww = img_shape[:, 0], img_shape[:, 1]
    return torch.stack([torch.minimum(v.clamp(min=0), lim) for v, lim in
                        ((x1, ww), (y1, hh), (x2, ww), (y2, hh))], -1)
