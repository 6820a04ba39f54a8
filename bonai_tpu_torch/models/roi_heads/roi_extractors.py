"""The parameters of an R-CNN RoI extractor (counterpart of the modules
``bonai_tpu/models/detectors/two_stage.py::_setup_extractor`` builds): the
GRoIE plugins of a ``GenericRoIExtractor`` (``pre_cfg``, ``post_cfg``) and
the deformable RoI pooling pack of a ``DeformRoIPoolPack`` layer.  The
detector keeps one under mmdet's ``roi_head.<role>_roi_extractor``; its
``_roi_align_cfg`` routes the RoIs through it."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...ops.layers import GeneralizedAttention
from ...ops.roi_pool import DeformRoIPoolPack
from ..init import kaiming_fan_out_, zeros_

DEFORM_POOLS = ("DeformRoIPoolPack", "DeformRoIPoolingPack",
                "ModulatedDeformRoIPoolPack", "ModulatedDeformRoIPoolingPack")


class GroieConvModule(nn.Module):
    """GRoIE's ``ConvModule`` plugin as the JAX package's
    ``GroieConvModule``: a ``kernel`` x ``kernel`` conv with a bias,
    padded ``kernel // 2`` (the config's ``padding`` is not read), then a
    ReLU; mmcv's ``.conv``."""

    def __init__(self, in_channels, out_channels=256, kernel=3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel,
                              padding=kernel // 2)

    def init_weights(self, gen):
        kaiming_fan_out_(self.conv.weight, gen)
        zeros_(self.conv.bias)

    def forward(self, x):
        """NHWC -> NHWC."""
        return F.relu(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def _plugin_kwargs(cfg, what):
    cfg = dict(cfg)
    cfg.pop("in_channels", None)
    ptype = cfg.pop("type", "GeneralizedAttention" if what == "post_cfg"
                    else "ConvModule")
    return ptype, cfg


class RoIExtractor(nn.Module):
    """One extractor's parameters: ``pre_module`` and ``post_module``
    (GRoIE: a :class:`GroieConvModule` on every level's pooled RoIs, one
    module shared by the levels, and a :class:`GroieConvModule` or the
    JAX package's ``GeneralizedAttention`` on their fusion), or
    ``roi_layers.0``, one :class:`~bonai_tpu_torch.ops.roi_pool.
    DeformRoIPoolPack` that every pyramid level shares, as in the JAX
    package (mmcv builds one pack a level: ROADMAP.md queue C)."""

    def __init__(self, cfg):
        super().__init__()
        layer = dict(cfg.get("roi_layer") or {})
        if layer.get("type") in DEFORM_POOLS:
            kw = dict(layer)
            ltype = kw.pop("type")
            extra = sorted(set(kw) - {"output_size", "output_channels",
                                      "deform_fc_channels", "gamma"})
            if extra:
                raise NotImplementedError(
                    f"{ltype} options {extra} are not ported to "
                    f"bonai_tpu_torch (the JAX pack reads none; ROADMAP.md "
                    f"item A7)")
            self.roi_layers = nn.ModuleList([DeformRoIPoolPack(
                **kw, modulated=ltype.startswith("Modulated"))])
            return
        channels = cfg.get("out_channels", 256)
        if cfg.get("pre_cfg"):
            ptype, kw = _plugin_kwargs(cfg["pre_cfg"], "pre_cfg")
            if ptype != "ConvModule":
                raise NotImplementedError(
                    f"GRoIE pre module {ptype} is not ported to "
                    f"bonai_tpu_torch (the JAX package takes ConvModule; "
                    f"ROADMAP.md item A7)")
            self.pre_module = GroieConvModule(
                dict(cfg["pre_cfg"]).get("in_channels", channels),
                kw.get("out_channels", 256), kw.get("kernel_size", 3))
            channels = kw.get("out_channels", 256)
        if cfg.get("post_cfg"):
            if cfg.get("aggregation", "sum") == "concat":
                channels *= len(cfg.get("featmap_strides", [4, 8, 16, 32]))
            ptype, kw = _plugin_kwargs(cfg["post_cfg"], "post_cfg")
            cin = dict(cfg["post_cfg"]).get("in_channels", channels)
            if ptype == "GeneralizedAttention":
                self.post_module = GeneralizedAttention(cin, **kw)
            elif ptype == "ConvModule":
                self.post_module = GroieConvModule(
                    cin, kw.get("out_channels", 256),
                    kw.get("kernel_size", 3))
            else:
                raise NotImplementedError(
                    f"GRoIE post module {ptype} is not ported to "
                    f"bonai_tpu_torch (the JAX package takes "
                    f"GeneralizedAttention and ConvModule; ROADMAP.md item "
                    f"A7)")

    def pre(self, x):
        return self.pre_module(x) if hasattr(self, "pre_module") else x

    def post(self, x):
        """The post module on NHWC RoI features."""
        if not hasattr(self, "post_module"):
            return x
        if isinstance(self.post_module, GeneralizedAttention):
            return self.post_module(x.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1)
        return self.post_module(x)
