"""Path Aggregation FPN (counterpart of ``bonai_tpu/models/necks/fpn.py::
PAFPN``; mmdet's ``PAFPN``): the FPN's laterals, top-down adds and 3x3
convs, then a bottom-up path: each level's stride-2 3x3
``downsample_convs.<i>`` adds into the next-coarser level in order, and
the levels past the finest go through the 3x3 ``pafpn_convs.<i - 1>``.
Levels past the inputs' are stride-2 subsamples or, with
``add_extra_convs`` (``True`` or ``'on_input'``, as the JAX builder
reads them), stride-2 3x3 convs (``fpn_convs.<n>`` after the output
convs) whose first reads the last backbone level."""

from __future__ import annotations

from torch import nn

from .fpn import FPN, ConvModule


class PAFPN(FPN):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, start_level=0, add_extra_convs=False):
        if add_extra_convs not in (False, True, "on_input"):
            raise NotImplementedError(
                f"PAFPN add_extra_convs={add_extra_convs!r} is not ported to "
                f"bonai_tpu_torch (the JAX PAFPN reads its extra convs from "
                f"the input; ROADMAP.md item A6)")
        super().__init__(in_channels, out_channels, num_outs, start_level,
                         add_extra_convs=bool(add_extra_convs))
        used = len(in_channels) - start_level
        self.downsample_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, 2)
             for _ in range(used - 1)])
        self.pafpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3)
             for _ in range(used - 1)])

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs,
                                              inputs[self.start_level:])]
        used = len(laterals)
        for i in range(used - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nn.functional.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        inter = [conv(x) for conv, x in zip(self.fpn_convs[:used], laterals)]
        for i, conv in enumerate(self.downsample_convs):
            inter[i + 1] = inter[i + 1] + conv(inter[i])
        outs = [inter[0]] + [conv(x) for conv, x in zip(self.pafpn_convs,
                                                       inter[1:])]
        if self.extra_on is None:
            while len(outs) < self.num_outs:
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        src = inputs[-1]
        for conv in self.fpn_convs[used:]:
            outs.append(conv(src))
            src = outs[-1]
        return tuple(outs)
