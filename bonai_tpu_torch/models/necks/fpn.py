"""Feature Pyramid Network (counterpart of ``bonai_tpu/models/necks/fpn.py``
``FPN`` without its norm options): 1x1 laterals from backbone level
``start_level`` on, nearest 2x top-down adds, 3x3 output convs, and the
levels past the inputs' either by ``max_pool2d(x, 1, stride=2)`` (kernel 1:
plain stride-2 subsampling) or, with ``add_extra_convs``, by stride-2 3x3
convs (mmdet's ``fpn_convs.<n>`` after the output convs).  The first extra
conv reads the last backbone level (``'input'``), the last output
(``'output'``) or the last lateral (``'lateral'``); with
``relu_before_extra_convs`` the later ones read their input through a
ReLU."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..init import xavier_uniform_, zeros_


class ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: holds ``.conv`` so
    mmdet keys (``neck.lateral_convs.0.conv.weight``) load as they are."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride,
                              kernel // 2 if padding is None else padding)

    def forward(self, x):
        return self.conv(x)


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
                 relu_before_extra_convs=False):
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
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3) for _ in used])
        if self.extra_on is not None:
            for i in range(num_outs - len(used)):
                cin = in_channels[-1] if i == 0 and self.extra_on == "input" \
                    else out_channels
                self.fpn_convs.append(ConvModule(cin, out_channels, 3, 2))

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_uniform_(m.weight, gen)
                zeros_(m.bias)

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
