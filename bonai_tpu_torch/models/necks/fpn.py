"""Feature Pyramid Network (counterpart of ``bonai_tpu/models/necks/fpn.py``
``conv_module`` and ``FPN``): 1x1 laterals from backbone level
``start_level`` on, nearest 2x top-down adds, 3x3 output convs, and the
levels past the inputs' either by ``max_pool2d(x, 1, stride=2)`` (kernel 1:
plain stride-2 subsampling) or, with ``add_extra_convs``, by stride-2 3x3
convs (mmdet's ``fpn_convs.<n>`` after the output convs).  The first extra
conv reads the last backbone level (``'input'``), the last output
(``'output'``) or the last lateral (``'lateral'``); with
``relu_before_extra_convs`` the later ones read their input through a
ReLU.  With ``norm_cfg`` every conv is followed by its norm (but the
laterals with ``no_norm_on_lateral``) and has no bias; ``conv_cfg`` may
make them ``ConvWS``."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..backbones import resnet
from ..init import kaiming_fan_out_, xavier_uniform_, zeros_


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without activation (JAX ``conv_module``): a
    conv, biased unless a norm of ``norm_cfg`` follows it
    (``resnet.build_norm``: ``.gn`` or ``.bn``), of ``conv_cfg``'s type
    (``resnet.build_conv``), so mmdet keys
    (``neck.lateral_convs.0.conv.weight``, ``neck.fpn_convs.0.gn.bias``)
    load as they are."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None,
                 norm_cfg=None, conv_cfg=None):
        super().__init__()
        self.conv = resnet.build_conv(conv_cfg, cin, cout, kernel, stride,
                                      padding, bias=norm_cfg is None)
        self.norm_name = None
        if norm_cfg is not None:
            self.norm_name, norm = resnet.build_norm(norm_cfg, cout)
            self.add_module(self.norm_name, norm)

    def init_weights_as_jax(self, gen):
        """The JAX ``conv_module``'s init: xavier uniform, or kaiming fan-out
        for a ``ConvWS`` conv; a zero bias."""
        if isinstance(self.conv, resnet.layers.ConvWS2d):
            kaiming_fan_out_(self.conv.weight, gen)
        else:
            xavier_uniform_(self.conv.weight, gen)
        if self.conv.bias is not None:
            zeros_(self.conv.bias)

    def forward(self, x):
        x = self.conv(x)
        return x if self.norm_name is None else getattr(
            self, self.norm_name)(x)


def extra_convs_mode(cfg):
    """The source of an FPN config's extra convs, ``None`` without them:
    mmdet's ``add_extra_convs`` (a bool, or ``'on_input'``, ``'on_output'``,
    ``'on_lateral'``) with the older ``extra_convs_on_inputs`` flag, as
    ``bonai_tpu/models/detectors/builders.py::_extra_convs_mode`` reads
    them."""
    aec = cfg.get("add_extra_convs", False)
    if isinstance(aec, str):
        return aec.replace("on_", "")
    if not aec:
        return None
    return "input" if cfg.get("extra_convs_on_inputs", True) else "output"


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=0, end_level=-1,
                 add_extra_convs=False, extra_convs_on_inputs=True,
                 relu_before_extra_convs=False, no_norm_on_lateral=False,
                 norm_cfg=None, conv_cfg=None):
        super().__init__()
        if end_level not in (-1, len(in_channels) - 1):
            raise NotImplementedError(
                "bonai_tpu_torch ports FPN over every input from start_level "
                "on (end_level=-1, as the JAX FPN reads them); other necks "
                "are ROADMAP.md item A6")
        self.start_level = start_level
        self.num_outs = num_outs
        self.extra_on = extra_convs_mode(dict(
            add_extra_convs=add_extra_convs,
            extra_convs_on_inputs=extra_convs_on_inputs))
        if self.extra_on not in (None, "input", "output", "lateral"):
            raise ValueError(f"add_extra_convs={add_extra_convs!r}")
        self.relu_before_extra_convs = relu_before_extra_convs
        used = in_channels[start_level:]
        opts = dict(norm_cfg=norm_cfg, conv_cfg=conv_cfg)
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, conv_cfg=conv_cfg,
                        norm_cfg=None if no_norm_on_lateral else norm_cfg)
             for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, **opts)
             for _ in used])
        if self.extra_on is not None:
            for i in range(num_outs - len(used)):
                cin = in_channels[-1] if i == 0 and self.extra_on == "input" \
                    else out_channels
                self.fpn_convs.append(ConvModule(cin, out_channels, 3, 2,
                                                 **opts))

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, ConvModule):
                m.init_weights_as_jax(gen)

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs,
                                              inputs[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        used = len(laterals)
        outs = [conv(x) for conv, x in zip(self.fpn_convs[:used], laterals)]
        if self.extra_on is None:
            while len(outs) < self.num_outs:
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        src = {"input": inputs[-1], "output": outs[-1],
               "lateral": laterals[-1]}[self.extra_on]
        for conv in self.fpn_convs[used:]:
            outs.append(conv(src))
            src = F.relu(outs[-1]) if self.relu_before_extra_convs \
                else outs[-1]
        return tuple(outs)
