"""Box head (counterpart of ``bonai_tpu/models/roi_heads/bbox_head.py``
``Shared2FCBBoxHead``).  v2.3 labels: foreground 0..C-1, background C
(the last softmax column)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..init import normal_, xavier_uniform_, zeros_


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes=1, in_channels=256, fc_out_channels=1024,
                 roi_feat_size=7, reg_class_agnostic=False):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def init_weights(self, gen):
        for fc in self.shared_fcs:
            xavier_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_cls.weight, 0.01, gen)
        normal_(self.fc_reg.weight, 0.001, gen)
        zeros_(self.fc_cls.bias)
        zeros_(self.fc_reg.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, C+1)`` class
        logits and ``(N, 4*K)`` deltas; flattened in (C, H, W) order."""
        x = x.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()
