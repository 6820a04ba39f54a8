"""Weight-standardised convolution and attention blocks (counterparts of
``bonai_tpu/ops/layers.py``): ``conv_ws_2d`` and ``ConvWS2d`` (mmcv's
names; the gn+ws configs' ``conv_cfg=dict(type='ConvWS')``), the
non-local block of Libra R-CNN's balanced feature pyramid and of the
ResNet plugins (``NonLocal2d``; mmcv's as ``BFP`` builds it: embedded
Gaussian, no scale), GCNet's global-context block (``ContextBlock``) and
the empirical-attention block (``GeneralizedAttention``), in plain
PyTorch on NCHW maps; and CornerNet's corner pooling (``corner_pool``).

Module names are mmcv's (``g``, ``theta``, ``phi``, ``conv_out``, each a
``ConvModule`` holding ``.conv``; ``conv_mask``, ``channel_add_conv.
{0,1,3}``; ``query_conv``, ``key_conv``, ``value_conv``,
``appr_geom_fc_x|y``, ``appr_bias``, ``geom_bias``, ``proj_conv``), so
mmdet keys load as they are, but for the JAX attention block's second
query conv (``geom_query_conv``, which mmcv does not have) and its
position projections shared by the heads (see
:class:`GeneralizedAttention`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.init import lecun_normal_, normal_, zeros_
from ..models.necks.fpn import ConvModule


def conv_ws_2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
               groups=1, eps=1e-5):
    """A convolution whose kernel is z-scored per output channel over
    ``(in / groups, kh, kw)`` first: ``(w - mean) / (std + eps)``, with the
    population std (ddof 0, ``jnp.std``'s in the JAX package; mmcv's
    ``conv_ws_2d`` takes the unbiased one, ROADMAP.md queue C).  The
    standardisation runs in float32 (float64 for a float64 weight) and
    its result is cast to the weight's dtype."""
    w = weight.to(torch.promote_types(weight.dtype, torch.float32))
    flat = w.flatten(1)
    mean = flat.mean(1).reshape(-1, 1, 1, 1)
    std = flat.std(1, correction=0).reshape(-1, 1, 1, 1)
    w = ((w - mean) / (std + eps)).to(weight.dtype)
    return F.conv2d(x, w, bias, stride, padding, dilation, groups)


class ConvWS2d(nn.Conv2d):
    """``nn.Conv2d`` (its ``weight``/``bias`` keys) through
    :func:`conv_ws_2d`."""

    def __init__(self, *args, eps=1e-5, **kwargs):
        super().__init__(*args, **kwargs)
        self.eps = eps

    def forward(self, x):
        return conv_ws_2d(x, self.weight, self.bias, self.stride,
                          self.padding, self.dilation, self.groups, self.eps)


class NonLocal2d(nn.Module):
    """``x + conv_out(softmax(theta(x)^T phi(x)) g(x))`` over the
    positions of an NCHW map, with ``in_channels // reduction`` inner
    channels.  The pairwise softmax runs in float32.  ``conv_out`` starts
    at zero, so the block starts as the identity."""

    def __init__(self, in_channels, reduction=2):
        super().__init__()
        inter = max(in_channels // reduction, 1)
        self.g = ConvModule(in_channels, inter, 1)
        self.theta = ConvModule(in_channels, inter, 1)
        self.phi = ConvModule(in_channels, inter, 1)
        self.conv_out = ConvModule(inter, in_channels, 1)

    def init_weights(self, gen):
        for m in (self.g, self.theta, self.phi):
            normal_(m.conv.weight, 0.01, gen)
            zeros_(m.conv.bias)
        zeros_(self.conv_out.conv.weight)
        zeros_(self.conv_out.conv.bias)

    def forward(self, x):
        b, _, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)       # (b, n, c)
        phi = self.phi(x).flatten(2)                           # (b, c, n)
        g = self.g(x).flatten(2).transpose(1, 2)               # (b, n, c)
        attn = torch.softmax(torch.bmm(theta, phi).float(), dim=-1)
        y = torch.bmm(attn.to(g.dtype), g)
        return x + self.conv_out(y.transpose(1, 2).reshape(b, -1, h, w))


class ContextBlock(nn.Module):
    """GCNet's global-context block (mmcv's ``ContextBlock``): a softmax
    attention pooling (``'att'``, float32 softmax; or ``'avg'``) to one
    ``(B, C, 1, 1)`` context, then ``channel_mul`` (``x * sigmoid(t)``)
    and ``channel_add`` (``x + t``) transforms ``t``: 1x1 conv to
    ``int(C * ratio)`` planes, LayerNorm over them, ReLU, 1x1 conv back.
    The LayerNorm's epsilon is flax's 1e-6 (mmcv's is torch's 1e-5); the
    last convs start at zero, so the block starts as the identity."""

    def __init__(self, in_channels, ratio=1. / 16, pooling_type="att",
                 fusion_types=("channel_add",)):
        super().__init__()
        if pooling_type not in ("att", "avg") or not set(fusion_types) <= {
                "channel_add", "channel_mul"}:
            raise ValueError(f"ContextBlock pooling_type={pooling_type!r}, "
                             f"fusion_types={fusion_types!r}")
        planes = max(int(in_channels * ratio), 1)
        self.pooling_type = pooling_type
        if pooling_type == "att":
            self.conv_mask = nn.Conv2d(in_channels, 1, 1)
        for fusion in ("channel_add", "channel_mul"):
            if fusion in fusion_types:
                self.add_module(f"{fusion}_conv", nn.Sequential(
                    nn.Conv2d(in_channels, planes, 1),
                    nn.LayerNorm([planes, 1, 1], eps=1e-6), nn.ReLU(),
                    nn.Conv2d(planes, in_channels, 1)))

    def init_weights(self, gen):
        if self.pooling_type == "att":
            normal_(self.conv_mask.weight, 0.01, gen)
            zeros_(self.conv_mask.bias)
        for fusion in ("channel_add_conv", "channel_mul_conv"):
            if hasattr(self, fusion):
                first, norm, _, last = getattr(self, fusion)
                lecun_normal_(first.weight, gen)
                zeros_(first.bias)
                nn.init.ones_(norm.weight)
                zeros_(norm.bias)
                zeros_(last.weight)
                zeros_(last.bias)

    def forward(self, x):
        b, c = x.shape[:2]
        if self.pooling_type == "att":
            logits = self.conv_mask(x).reshape(b, 1, -1)
            attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            context = torch.bmm(attn, x.reshape(b, c, -1).transpose(1, 2))
            context = context.reshape(b, c, 1, 1)
        else:
            context = x.mean((2, 3), keepdim=True)
        out = x
        if hasattr(self, "channel_mul_conv"):
            out = out * torch.sigmoid(self.channel_mul_conv(context))
        if hasattr(self, "channel_add_conv"):
            out = out + self.channel_add_conv(context)
        return out


class GeneralizedAttention(nn.Module):
    """The empirical-attention block as the JAX package computes it
    (``bonai_tpu/ops/layers.py::GeneralizedAttention``).  Of the four
    terms of ``attention_type``: [0] query-key content, [1] query and
    relative position, [2] a key-content bias, [3] a relative-position
    bias.  Keys and values read ``x[::kv_stride, ::kv_stride]``, queries
    ``x[::q_stride, ::q_stride]`` (ceil lengths); ``num_heads`` heads of
    ``C // num_heads`` channels.  Relative positions embed as sinusoids
    of frequencies ``100 ** (2 f / feat_dim)``, projected to the head
    width by ``appr_geom_fc_y`` / ``_x``, one projection shared by the
    heads; the query term of position reads its own query conv
    (``geom_query_conv``).  The energy goes through a float32 softmax
    over ``/ sqrt(C // num_heads)``; ``proj_conv`` starts at zero, with
    no ``gamma``, so the block starts as the identity; with
    ``q_stride > 1`` its output is resized bilinearly to ``x``'s size.

    This is not mmcv's function (ROADMAP.md queue C): mmcv has one query
    conv, per-head position projections divided by ``sqrt(2)``,
    wavelength 1000, no ``sqrt`` scaling and a ``gamma``.  Like the JAX
    block, it ignores ``spatial_range`` (dense attention)."""

    def __init__(self, in_channels, spatial_range=-1, num_heads=9,
                 position_embedding_dim=-1, position_magnitude=1,
                 kv_stride=2, q_stride=1, attention_type="1111"):
        super().__init__()
        self.terms = [t == "1" for t in attention_type]
        if len(self.terms) != 4 or not any(self.terms):
            raise ValueError(f"attention_type={attention_type!r}")
        self.heads = num_heads
        self.dk = in_channels // num_heads
        self.kv_stride, self.q_stride = kv_stride, q_stride
        self.position_magnitude = position_magnitude
        pe_dim = position_embedding_dim if position_embedding_dim > 0 \
            else in_channels
        self.feat_dim = pe_dim // 2
        qkv = num_heads * self.dk
        t = self.terms

        def conv1x1():
            return nn.Conv2d(in_channels, qkv, 1, bias=False)
        if t[0] or t[1]:
            self.query_conv = conv1x1()
        if t[0] or t[2]:
            self.key_conv = conv1x1()
        if t[1] or t[3]:
            embed = 2 * (self.feat_dim // 2)
            self.appr_geom_fc_x = nn.Linear(embed, self.dk, bias=False)
            self.appr_geom_fc_y = nn.Linear(embed, self.dk, bias=False)
        if t[1]:
            self.geom_query_conv = conv1x1()
        if t[2]:
            self.appr_bias = nn.Parameter(torch.zeros(qkv))
        if t[3]:
            self.geom_bias = nn.Parameter(torch.zeros(qkv))
        self.value_conv = conv1x1()
        self.proj_conv = nn.Conv2d(qkv, in_channels, 1)

    def init_weights(self, gen):
        for name, p in self.named_parameters():
            if name.startswith("proj_conv."):
                zeros_(p)
            else:
                normal_(p, 0.01, gen)

    def _embed(self, q_len, k_len, device):
        """``(q_len, k_len, 2 * (feat_dim // 2))`` sinusoids of the
        query-to-key offsets along one axis."""
        rel = (torch.arange(q_len, device=device, dtype=torch.float32)[
            :, None] * self.q_stride - torch.arange(
            k_len, device=device, dtype=torch.float32)[None, :]
            * self.kv_stride) / self.position_magnitude
        freq = torch.arange(self.feat_dim // 2, device=device,
                            dtype=torch.float32)
        ang = rel[..., None] / 100.0 ** (2.0 * freq / self.feat_dim)
        return torch.cat([torch.sin(ang), torch.cos(ang)], -1)

    def _split(self, t):
        """``(B, heads * dk, h, w)`` -> ``(B, heads, h * w, dk)``."""
        return t.reshape(t.shape[0], self.heads, self.dk, -1).transpose(2, 3)

    def forward(self, x):
        b, c, h, w = x.shape
        t, heads, dk = self.terms, self.heads, self.dk
        xq = x[:, :, ::self.q_stride, ::self.q_stride]
        xk = x[:, :, ::self.kv_stride, ::self.kv_stride]
        qh, qw = xq.shape[2:]
        kh, kw = xk.shape[2:]
        if t[0] or t[2]:
            k = self._split(self.key_conv(xk))            # (B, Hd, Nk, dk)
        energy = None
        if t[0]:
            energy = self._split(self.query_conv(xq)) @ k.transpose(2, 3)
        if t[2]:
            bias = (self.appr_bias.reshape(1, heads, 1, dk).to(k.dtype)
                    @ k.transpose(2, 3))                 # (B, Hd, 1, Nk)
            energy = bias if energy is None else energy + bias
        if t[1] or t[3]:
            ey = self.appr_geom_fc_y(self._embed(qh, kh, x.device).to(
                self.appr_geom_fc_y.weight.dtype))        # (qh, kh, dk)
            ex = self.appr_geom_fc_x(self._embed(qw, kw, x.device).to(
                self.appr_geom_fc_x.weight.dtype))        # (qw, kw, dk)
            # the y terms (.., qh, qw, kh, 1) and the x terms (.., qh, qw,
            # 1, kw) broadcast once, into the energy's sum
            pos_y = pos_x = 0.0
            if t[1]:
                qg = self._split(self.geom_query_conv(xq)).reshape(
                    b, heads, qh, qw, dk)
                pos_y = torch.einsum("bhyxd,ykd->bhyxk", qg, ey)[..., None]
                pos_x = torch.einsum("bhyxd,xkd->bhyxk", qg,
                                     ex)[..., None, :]
            if t[3]:
                gb = self.geom_bias.reshape(heads, dk)
                pos_y = pos_y + torch.einsum("hd,ykd->hyk", gb, ey)[
                    None, :, :, None, :, None]
                pos_x = pos_x + torch.einsum("hd,xkd->hxk", gb, ex)[
                    None, :, None, :, None, :]
            q_dims = (qh, qw) if energy is not None and energy.shape[2] > 1 \
                else (1, 1)
            e = pos_y + (0.0 if energy is None
                         else energy.reshape(b, heads, *q_dims, kh, kw))
            full = torch.broadcast_shapes(e.shape, pos_x.shape)
            e = e.add_(pos_x) if e.shape == full else e + pos_x
            energy = e.reshape(e.shape[0], heads, qh * qw, kh * kw)
        attn = torch.softmax(energy.float() / math.sqrt(dk), dim=-1)
        attn = attn.expand(b, heads, qh * qw, kh * kw)
        v = self._split(self.value_conv(xk))
        out = attn.to(v.dtype) @ v                         # (B, Hd, Nq, dk)
        out = self.proj_conv(out.transpose(2, 3).reshape(b, heads * dk,
                                                         qh, qw))
        if self.q_stride > 1:
            out = F.interpolate(out, size=(h, w), mode="bilinear",
                                align_corners=False)
        return x + out


def corner_pool(x, direction):
    """CornerNet's corner pooling on an ``(B, C, H, W)`` map (JAX
    ``corner_pool``, an ``associative_scan`` of ``max``): a running max
    along H (``'top'``: ``out[i] = max(x[i:])``, ``'bottom'``:
    ``max(x[:i + 1])``) or W (``'left'``, ``'right'``), as
    ``torch.cummax``, flipped for ``'top'`` and ``'left'``.  Exact."""
    if direction not in ("top", "bottom", "left", "right"):
        raise ValueError(f"corner_pool direction {direction!r}")
    dim = 2 if direction in ("top", "bottom") else 3
    if direction in ("top", "left"):
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values
