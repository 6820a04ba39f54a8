"""FCN mask head, HTC's mask head and semantic head, and Mask Scoring
R-CNN's mask-IoU head and its targets (counterparts of
``bonai_tpu/models/roi_heads/mask_head.py``: ``FCNMaskHead``,
``HTCMaskHead``, ``FusedSemanticHead``, ``MaskIoUHead``,
``mask_iou_targets``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..init import fan_in_uniform_, kaiming_fan_out_, normal_, zeros_
from ..necks.fpn import ConvModule


class FCNMaskHead(nn.Module):
    """``num_convs`` 3x3 convs (each a ``ConvModule`` of ``norm_cfg`` and
    ``conv_cfg``: mmdet's ``convs.<i>.conv``/``.gn``), a 2x deconv, 1x1
    logits."""

    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=1, norm_cfg=None, conv_cfg=None):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, norm_cfg=norm_cfg,
                       conv_cfg=conv_cfg) for i in range(num_convs)])
        self.conv_module_init = norm_cfg is not None or conv_cfg is not None
        last = conv_out_channels if num_convs else in_channels
        self.upsample = nn.ConvTranspose2d(last, conv_out_channels, 2, 2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def init_weights(self, gen):
        """Kaiming fan-out and zero biases; with a norm or conv option the
        convs take the JAX ``conv_module``'s init."""
        if self.conv_module_init:
            for conv in self.convs:
                conv.init_weights_as_jax(gen)
            rest = [self.upsample, self.conv_logits]
        else:
            rest = [m for m in self.modules()
                    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
        for m in rest:
            kaiming_fan_out_(m.weight, gen)
            zeros_(m.bias)

    def forward(self, x):
        """``(N, S, S, C)`` RoI features -> float32 ``(N, K, 2S, 2S)``
        mask logits."""
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).float()


class HTCMaskHead(FCNMaskHead):
    """HTC's mask head: with ``with_conv_res`` (every stage but the first)
    a 1x1 ``conv_res`` adds the previous stage's mask feature into the RoI
    features before the convs, without mmdet's ReLU after it, as in the
    JAX package (ROADMAP.md queue C)."""

    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=1, with_conv_res=True):
        super().__init__(num_convs, in_channels, conv_out_channels,
                         num_classes)
        if with_conv_res:
            self.conv_res = ConvModule(conv_out_channels, conv_out_channels,
                                       1)

    def forward(self, x, res_feat=None, return_logits=True):
        """``(N, S, S, C)`` RoI features and the previous stage's ``(N, C,
        S, S)`` feature or ``None`` -> the float32 ``(N, K, 2S, 2S)`` mask
        logits, or with ``return_logits=False`` this stage's feature for
        the next."""
        x = x.permute(0, 3, 1, 2)
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = F.relu(conv(x))
        if not return_logits:
            return x
        return self.conv_logits(F.relu(self.upsample(x))).float()


def resize_bilinear(x, size):
    """``(N, C, H, W)`` -> ``(N, C, *size)`` as ``jax.image.resize(...,
    'bilinear')`` resizes: half-pixel centres, and a triangle kernel
    widened by the scale along an axis that shrinks (antialiasing, which
    ``F.interpolate`` applies only when asked)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if size[0] >= x.shape[-2] and size[1] >= x.shape[-1]:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)
    # the antialiased kernel in float32 whatever the input's dtype
    return F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


class FusedSemanticHead(nn.Module):
    """HTC's semantic branch: a 1x1 ``lateral_convs.<i>`` on each of the
    first ``num_ins`` levels, resized onto level ``fusion_level`` and
    summed, ``num_convs`` 3x3 convs with ReLU, then ``conv_logits``
    (segmentation logits) and ``conv_embedding`` with ReLU (the feature
    fused into the RoI features).  As in the JAX package the laterals
    have no ReLU and resize after the conv, half-pixel and antialiased,
    where mmdet resizes the level first with ``align_corners=True``
    (ROADMAP.md queue C)."""

    def __init__(self, num_ins=5, fusion_level=1, num_convs=4,
                 in_channels=256, conv_out_channels=256, num_classes=183):
        super().__init__()
        self.fusion_level = fusion_level
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, in_channels, 1) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3) for i in range(num_convs))
        self.conv_embedding = ConvModule(conv_out_channels,
                                         conv_out_channels, 1)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_fan_out_(m.weight, gen)
                zeros_(m.bias)

    def forward(self, feats):
        """NHWC levels -> float32 ``(B, K, H, W)`` logits and the ``(B, H,
        W, C)`` embedding (an NHWC view), at level ``fusion_level``."""
        levels = [f.permute(0, 3, 1, 2) for f in feats]
        x = self.lateral_convs[self.fusion_level](levels[self.fusion_level])
        size = tuple(x.shape[-2:])
        for i, conv in enumerate(self.lateral_convs):
            if i != self.fusion_level:
                x = x + resize_bilinear(conv(levels[i]), size)
        for conv in self.convs:
            x = F.relu(conv(x))
        embedding = F.relu(self.conv_embedding(x))
        return self.conv_logits(x).float(), embedding.permute(0, 2, 3, 1)


class MaskIoUHead(nn.Module):
    """Mask Scoring R-CNN's head: the IoU of each predicted mask with its
    GT, per class, from the RoI's mask features concatenated with the 2x2
    max-pooled largest mask logit (the JAX package's input; mmdetection
    pools the sigmoid of the label's logit: ROADMAP.md queue C), through
    ``num_convs`` 3x3 convs (the last at stride 2) and ``num_fcs`` FCs.
    Keys are mmdet's (``convs.<i>.conv``, ``fcs.<i>``, ``fc_mask_iou``)."""

    def __init__(self, num_convs=4, num_fcs=2, in_channels=256,
                 conv_out_channels=256, fc_out_channels=1024, num_classes=1,
                 roi_feat_size=14):
        super().__init__()
        self.convs = nn.ModuleList()
        for i in range(num_convs):
            conv = ConvModule(in_channels + 1 if i == 0 else conv_out_channels,
                              conv_out_channels, 3)
            if i == num_convs - 1:
                conv.conv.stride = (2, 2)
            self.convs.append(conv)
        pooled = (roi_feat_size // 2) ** 2
        self.fcs = nn.ModuleList(
            nn.Linear(conv_out_channels * pooled if i == 0
                      else fc_out_channels, fc_out_channels)
            for i in range(num_fcs))
        self.fc_mask_iou = nn.Linear(fc_out_channels, num_classes)

    def init_weights(self, gen):
        for conv in self.convs:
            kaiming_fan_out_(conv.conv.weight, gen)
            zeros_(conv.conv.bias)
        for fc in self.fcs:
            fan_in_uniform_(fc.weight, gen)
            zeros_(fc.bias)
        normal_(self.fc_mask_iou.weight, 0.01, gen)
        zeros_(self.fc_mask_iou.bias)

    def forward(self, mask_feat, mask_logits):
        """``(N, S, S, C)`` mask RoI features and ``(N, K, 2S, 2S)`` mask
        logits -> float32 ``(N, K)`` predicted IoUs."""
        x = mask_feat.permute(0, 3, 1, 2)
        pred = F.max_pool2d(mask_logits.max(dim=1, keepdim=True).values, 2, 2)
        x = torch.cat([x, pred.to(x.dtype)], dim=1)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.flatten(1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x).float()


def mask_iou_targets(mask_logits, targets, pos_boxes, matched_gt_boxes,
                     matched_inst_masks, mask_thr=0.5):
    """``(P,)`` mask-IoU targets: the IoU of each binarised predicted mask
    ``(P, S, S)`` (logits) with its whole GT instance.  The overlap is
    counted on the proposal's grid against the mask ``targets`` ``(P, S,
    S)``; the GT's full area, outside the proposal too, is its
    instance-local mask's mean ``(P, M, M)`` times its box's area, in
    grid cells of the proposal ``pos_boxes`` ``(P, 4)``."""
    s = targets.shape[-1]
    with torch.autocast(mask_logits.device.type, enabled=False):
        pred = (torch.sigmoid(mask_logits.float()) > mask_thr).float()
        targets = targets.float()
        overlap = (pred * targets).sum(dim=(-1, -2))
        pred_area = pred.sum(dim=(-1, -2))
        boxes, gt = pos_boxes.float(), matched_gt_boxes.float()
        pw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6)
        ph = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6)
        cell = (pw / s) * (ph / s)
        gw = (gt[:, 2] - gt[:, 0]).clamp(min=0.0)
        gh = (gt[:, 3] - gt[:, 1]).clamp(min=0.0)
        full = matched_inst_masks.float().mean(dim=(-1, -2)) * gw * gh
        gt_cells = full / cell.clamp(min=1e-6)
        return overlap / (pred_area + gt_cells - overlap).clamp(min=1e-6)
