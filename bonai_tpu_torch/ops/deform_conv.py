"""Deformable convolution v1 and v2 (counterpart of
``bonai_tpu/ops/deform_conv.py``: ``deform_conv2d``, ``_deform_sample``,
``_deform_contract``, ``DeformConv2d``, ``ModulatedDeformConv2d``,
``DeformConv2dPack``),
in plain PyTorch.

The layer samples the input at ``K*K`` offset positions per output cell
(bilinear), then contracts the samples with the kernel as one matmul over
``K*K*Cin``.  Offsets follow mmcv's layout: per deform group, per kernel
point in row-major order, a ``(dy, dx)`` pair; v2's mask logits follow
them, one per group and point, and enter as their sigmoid.

Border rule (the JAX package's, not mmcv's): a sample inside ``(-1, h)``
by ``(-1, w)`` is first clipped into ``[0, h-1] x [0, w-1]`` and then
interpolated, so a sample at ``y = -0.5`` reads row 0 at full weight
(mmcv's ``dmcn_im2col_bilinear`` gives it 0.5; ROADMAP.md queue C).  The
clip is ``minimum(maximum(.))`` over tensor bounds, whose gradient at a
bound is 0.5, as ``jnp.clip``'s: a zero-offset layer's samples lie on the
bounds along the map's edges.  Corner reads clip their flat index, as
``jnp.take(..., mode="clip")`` (their weight is 0 there, on 1-wide maps).

Memory: the samples ``(B, Ho, Wo, K*K, Cin)`` are the layer's one large
tensor.  The sampling is an autograd function that keeps only its inputs
and recomputes its four corner reads in the backward one at a time, so
the backward holds one dense corner read at once, never four; the matmul
keeps the samples (in the input's dtype) for the kernel's gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.init import kaiming_fan_out_, zeros_


def _plan(offset, mask, h, w, kh, kw, stride, padding, dilation, groups,
          n_pix):
    """The four corner rows and weights of every sample.

    ``offset`` ``(B, G*2*K*K, Ho, Wo)``, ``mask`` ``(B, G*K*K, Ho, Wo)``
    logits or ``None``.  Returns ``rows`` (4 tensors of row indices into
    the ``(B*H*W*G, Cin/G)`` input) and ``coefs`` (4 float32 tensors: the
    bilinear weight times the in-range test times the mask), each
    ``(B, Ho, Wo, K*K, G)``; ``coefs`` carry the gradient of ``offset``
    and ``mask``."""
    b, _, ho, wo = offset.shape
    kk = kh * kw
    dev = offset.device
    off = offset.float().reshape(b, groups, kk, 2, ho, wo).permute(
        0, 4, 5, 2, 1, 3)                                  # (B,Ho,Wo,KK,G,2)
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    base_y = (torch.arange(ho, device=dev) * stride - padding).float()[
        :, None, None, None] + (ky.reshape(-1) * dilation).float()[:, None]
    base_x = (torch.arange(wo, device=dev) * stride - padding).float()[
        :, None, None] + (kx.reshape(-1) * dilation).float()[:, None]
    ys = base_y + off[..., 0]                              # (B,Ho,Wo,KK,G)
    xs = base_x + off[..., 1]
    valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    zero = ys.new_zeros(())
    # minimum(maximum(.)) over tensor bounds: jnp.clip's 0.5 gradient at
    # a bound (torch.clamp gives 1)
    yc = torch.minimum(torch.maximum(ys, zero), ys.new_tensor(h - 1.0))
    xc = torch.minimum(torch.maximum(xs, zero), xs.new_tensor(w - 1.0))
    y0 = yc.detach().floor().clamp(0, max(h - 2, 0)).long()
    x0 = xc.detach().floor().clamp(0, max(w - 2, 0)).long()
    ly, lx = yc - y0, xc - x0
    coef = valid.float()
    if mask is not None:
        coef = coef * torch.sigmoid(mask.float().reshape(
            b, groups, kk, ho, wo).permute(0, 3, 4, 2, 1))
    weights = ((1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx)
    pix = (torch.arange(b, device=dev)[:, None, None, None, None] * h
           + y0) * w + x0
    g = torch.arange(groups, device=dev)
    rows = [(pix + d).clamp(0, n_pix - 1) * groups + g
            for d in (0, 1, w, w + 1)]
    return rows, [wt * coef for wt in weights]


def _sample_forward(xf, rows, coefs, out_dtype):
    """``sum_c xf[rows_c] * coefs_c``, accumulated in float32."""
    acc = None
    for r, c in zip(rows, coefs):
        term = xf[r.reshape(-1)].float() * c.reshape(-1, 1)
        acc = term if acc is None else acc.add_(term)
    return acc.to(out_dtype)


def _sample_backward(xf, rows, coefs, grad):
    """The input's gradient (float32, ``xf``'s shape) and each corner's
    ``sum over channels of grad * xf[rows_c]`` (float32, one per
    sample), one corner read at a time."""
    grad = grad.reshape(-1, xf.shape[1]).float()
    gx = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
    dots = []
    for r, c in zip(rows, coefs):
        r = r.reshape(-1)
        dots.append((grad * xf[r].float()).sum(1).reshape(c.shape))
        gx.index_add_(0, r, grad * c.detach().reshape(-1, 1))
    return gx, dots


class _DeformSample(torch.autograd.Function):
    """Offset-guided bilinear sampling: ``x`` ``(B, H, W, G, Cin/G)``
    (contiguous NHWC) -> ``(B, Ho, Wo, K*K, G, Cin/G)`` in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, offset, mask, geometry):
        b, h, w, groups, cg = x.shape
        xf = x.reshape(-1, cg)
        with torch.no_grad():
            rows, coefs = _plan(offset, mask, h, w, *geometry, groups,
                                b * h * w)
        ctx.save_for_backward(x, offset, mask)
        ctx.geometry = geometry
        out = _sample_forward(xf, rows, coefs, x.dtype)
        return out.reshape(*coefs[0].shape[:4], groups, cg)

    @staticmethod
    def backward(ctx, grad):
        x, offset, mask = ctx.saved_tensors
        b, h, w, groups, cg = x.shape
        xf = x.reshape(-1, cg)
        with torch.enable_grad():
            off = offset.detach().requires_grad_()
            msk = None if mask is None else mask.detach().requires_grad_()
            rows, coefs = _plan(off, msk, h, w, *ctx.geometry, groups,
                                b * h * w)
        gx, dots = _sample_backward(xf, rows, coefs, grad)
        g_off = g_mask = None
        wants = [off] + ([msk] if msk is not None else [])
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            # the coefficients' gradients: sum_c dots_c * d coef_c
            with torch.enable_grad():
                total = sum((c * d).sum() for c, d in zip(coefs, dots))
            got = torch.autograd.grad(total, wants)
            g_off = got[0].to(offset.dtype)
            if msk is not None:
                g_mask = got[1].to(mask.dtype)
        g_x = gx.reshape(x.shape).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        return g_x, g_off, g_mask, None


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=1,
                  dilation=1, mask=None, deform_groups=1):
    """Deformable convolution (v1; v2 with ``mask``).

    Args:
      x: ``(B, Cin, H, W)``.
      offset: ``(B, G*2*K*K, Ho, Wo)``, mmcv's layout (see the module
        docstring).
      weight: ``(Cout, Cin, kh, kw)``.
      mask: ``(B, G*K*K, Ho, Wo)`` modulation logits (the sigmoid applies
        here, as in the JAX function), or ``None``.
    Returns ``(B, Cout, Ho, Wo)`` in ``x``'s dtype (channels-last memory
    on the card).
    """
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    xs = x.permute(0, 2, 3, 1).reshape(b, h, w, deform_groups,
                                       cin // deform_groups)
    vals = _DeformSample.apply(xs.contiguous(), offset, mask,
                               (kh, kw, stride, padding, dilation))
    _, ho, wo = vals.shape[:3]
    kmat = weight.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    out = vals.reshape(b * ho * wo, kh * kw * cin) @ kmat.to(vals.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    out = out.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)
    # contiguous NCHW on the CPU (see TwoStageDetector.extract_feat)
    return out if out.is_cuda else out.contiguous()


class DeformConv2d(nn.Module):
    """DCNv1 whose offsets the caller gives (mmcv's ``DeformConv2d``
    without a bias): ``weight`` ``(Cout, Cin, K, K)``, stride 1, the
    padding that keeps the map's size."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))

    def forward(self, x, offset):
        return deform_conv2d(x, offset, self.weight,
                             padding=(self.weight.shape[-1] - 1) // 2)


class DeformConv2dPack(nn.Module):
    """DCNv1 with its own offset conv (mmcv's ``DeformConv2dPack``, dcn
    type ``'DCN'``): ``conv_offset``, zero at the start, predicts the
    ``G*2*K*K`` offsets, so the layer starts as a plain convolution.
    mmcv's keys: ``weight`` ``(Cout, Cin, K, K)``, ``bias`` with
    ``bias=True`` (NAS-FCOS's head), ``conv_offset.{weight,bias}``."""

    mask_parts = 0

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, deform_groups=1, bias=False):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deform_groups = deform_groups
        kk = kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.conv_offset = nn.Conv2d(
            in_channels, (2 + self.mask_parts) * kk * deform_groups,
            kernel_size, stride, padding, dilation)

    def init_weights(self, gen):
        kaiming_fan_out_(self.weight, gen)
        zeros_(self.conv_offset.weight)
        zeros_(self.conv_offset.bias)
        if self.bias is not None:
            zeros_(self.bias)

    def forward(self, x):
        pred = self.conv_offset(x)
        n = 2 * self.weight.shape[2] * self.weight.shape[3] \
            * self.deform_groups
        return deform_conv2d(
            x, pred[:, :n], self.weight, self.bias, self.stride,
            self.padding, self.dilation,
            pred[:, n:] if self.mask_parts else None, self.deform_groups)


class ModulatedDeformConv2dPack(DeformConv2dPack):
    """DCNv2 (mmcv's ``ModulatedDeformConv2dPack``, dcn type ``'DCNv2'``):
    ``conv_offset`` predicts ``G*3*K*K`` channels, the offsets and then
    the mask logits."""

    mask_parts = 1
