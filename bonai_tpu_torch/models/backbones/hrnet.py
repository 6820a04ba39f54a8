"""HRNet backbone (counterpart of ``bonai_tpu/models/backbones/hrnet.py``):
parallel multi-resolution branches with repeated cross-resolution fusion;
a stem of two stride-2 3x3 convs, the bottleneck ``layer1``, then stages
2-4 of ``BasicBlock`` HR modules.  The ``extra`` dict is mmdet's
(``num_modules``, ``num_branches``, ``num_blocks``, ``num_channels`` per
stage; ``block`` is read as the JAX package reads it: ``layer1`` is made
of bottlenecks, every later stage of basic blocks).

Module names follow mmdet v2.3's HRNet, so its checkpoints load as they
are: ``conv1 bn1 conv2 bn2``, ``layer1.<i>``, ``transition<t>.<b>.0|1``
for a branch whose width changes and ``transition<t>.<b>.0.0|0.1`` for a
new, coarser branch (``t`` = stage - 1), ``stage<s>.<m>.branches.<b>.<i>``
and ``stage<s>.<m>.fuse_layers.<i>.<j>.0|1`` from a coarser branch,
``….<j>.<k>.0|1`` for the ``k``-th stride-2 conv from a finer one.

As in the JAX package, BatchNorm stays frozen whatever ``norm_eval``
says.  ``frozen_stages`` is the JAX package's: the stem's ``conv1``/``bn1``
(``>= 0``) and ``layer1`` (``>= 1``) are not trained, and the gradient
stops after ``layer1`` and after every stage up to ``frozen_stages``.  So
at ``frozen_stages=1`` the second stem conv and its BN, ``conv2``/``bn2``,
get no gradient and still train: the optimizer gives them a zero gradient
(``engine/optim.py::apply_gradients``), and weight decay and momentum
move them every step, as in the JAX step (ROADMAP.md queue C).
"""

from __future__ import annotations

import logging

import torch.nn.functional as F
from torch import nn

from ..init import kaiming_fan_out_
from .resnet import BasicBlock, Bottleneck, FrozenBatchNorm2d, _downsample

logger = logging.getLogger("bonai_tpu_torch")


def upsample_nearest(x, h, w):
    """Nearest upsample of an NCHW map by the integer factors to
    ``(h, w)``."""
    return F.interpolate(x, scale_factor=(h // x.shape[2], w // x.shape[3]),
                         mode="nearest")


def _conv_bn(cin, cout, k, stride, relu):
    """mmdet's ``Sequential(conv, BN[, ReLU])``: keys ``.0`` and ``.1``."""
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
              FrozenBatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class HRModule(nn.Module):
    """Branch blocks, then the fuse: every output branch ``i`` sums its own
    map, a 1x1 conv + BN + nearest upsample of each coarser branch, and a
    chain of stride-2 3x3 conv + BN (+ ReLU but the last) of each finer
    one, then a ReLU."""

    def __init__(self, in_channels, num_blocks, channels):
        super().__init__()
        n = len(channels)
        branches = []
        for b in range(n):
            blocks, cin = [], in_channels[b]
            for i in range(num_blocks[b]):
                ds = _downsample(cin, channels[b], 1) \
                    if i == 0 and cin != channels[b] else None
                blocks.append(BasicBlock(cin, channels[b], 1, ds))
                cin = channels[b]
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, 1,
                                        False))
                elif j < i:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j], channels[i] if k == i - j - 1
                                 else channels[j], 3, 2, k < i - j - 1)
                        for k in range(i - j)]))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            h, w = outs[i].shape[2:]
            acc = outs[i]
            for j, layer in enumerate(row):
                if j > i:
                    acc = acc + upsample_nearest(layer(outs[j]), h, w)
                elif j < i:
                    acc = acc + layer(outs[j])
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """Returns the four branches' NCHW maps, finest first."""

    def __init__(self, extra, frozen_stages=-1, norm_eval=True):
        super().__init__()
        if not norm_eval:
            logger.info("HRNet(norm_eval=False): BatchNorm stays frozen over "
                        "its stored statistics, as in the JAX package")
        self.frozen_stages = frozen_stages
        # conv2/bn2 train behind the gradient stop after layer1
        self.stops_gradient = frozen_stages >= 1
        self.behind_stop = ("conv2", "bn2") if self.stops_gradient else ()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(64)
        s1 = extra["stage1"]
        blocks, cin = [], 64
        for i in range(s1["num_blocks"][0]):
            planes = s1["num_channels"][0]
            ds = _downsample(cin, planes * 4, 1) if i == 0 else None
            blocks.append(Bottleneck(cin, planes, 1, ds))
            cin = planes * 4
        self.layer1 = nn.Sequential(*blocks)
        prev = [cin]
        for s in (2, 3, 4):
            cfg = extra[f"stage{s}"]
            channels = list(cfg["num_channels"])[:cfg["num_branches"]]
            trans = []
            for b, c in enumerate(channels):
                if b >= len(prev):      # a new, coarser branch
                    trans.append(nn.Sequential(_conv_bn(prev[-1], c, 3, 2,
                                                        True)))
                elif prev[b] != c:
                    trans.append(_conv_bn(prev[b], c, 3, 1, True))
                else:
                    trans.append(None)
            self.add_module(f"transition{s - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{s}", nn.Sequential(*[
                HRModule(channels, list(cfg["num_blocks"]), channels)
                for _ in range(cfg["num_modules"])]))
            prev = channels
        frozen = [self.conv1, self.bn1] if frozen_stages >= 0 else []
        if frozen_stages >= 1:
            frozen.append(self.layer1)
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        if self.stops_gradient:
            x = x.detach()
        xs = [x]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            xs = [xs[b] if t is None else t(xs[b] if b < len(xs) else xs[-1])
                  for b, t in enumerate(trans)]
            for module in getattr(self, f"stage{s}"):
                xs = module(xs)
            if self.frozen_stages >= s:
                xs = [v.detach() for v in xs]
        return tuple(xs)
