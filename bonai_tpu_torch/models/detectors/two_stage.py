"""Two-stage detector trunk: Faster R-CNN, Mask R-CNN, Dynamic R-CNN,
Libra R-CNN, Double-Head R-CNN, Mask Scoring R-CNN, the RPN-only detector,
Fast R-CNN, Guided-Anchoring Faster R-CNN, and the base of LOFT, Cascade
R-CNN, Grid R-CNN and PointRend (counterpart of
``bonai_tpu/models/detectors/two_stage.py``: ``boxes_to_rois``,
``assign_rcnn``, ``assign_and_sample_rcnn``, ``extract_feat``,
``_roi_align_cfg``, ``_bbox_head_forward``,
``_rpn_and_proposals``, ``forward_train``, ``_roi_forward_train``,
``_mask_forward_train``, ``simple_test``, ``_rcnn_simple_test``,
``aug_test``, ``FasterRCNN``, ``MaskRCNN``, ``DynamicRCNN``, ``RPN``,
``FastRCNN``).

The RPN may be the plain ``RPNHead``, ``SemiRPNHead`` (the plain head,
trained on the footprint boxes of footprint-only images without their
regression: ``_semi_rpn_gt``) or the Guided Anchoring RPN
(``GARPNHead``, with its ``approx_anchor_generator`` and
``loc_filter_thr``): then the proposals come from its guided anchors and
its loss adds the location and shape terms.

Training is the random- or IoU-balanced-sampling path of the JAX package,
with its box loss: L1 for an ``L1Loss`` or a ``SmoothL1Loss`` config (the
JAX package keeps both on its inline L1 path, ROADMAP.md queue C),
``BalancedL1Loss`` as configured, SmoothL1 at the batch's beta under
Dynamic R-CNN.  The mask branch is optional (``with_mask``), and with it
Mask Scoring's IoU head.  The backbone may be a ResNet (with DCN and
plugins), a Res2Net, a RegNet or an HRNet; the neck an FPN followed by
Libra's BFP (mmdet's ``neck.0``, ``neck.1``), a PAFPN or an HRFPN.  A box
head may classify only
(``with_reg=False``: no ``loss_bbox``), the mask head may be PointRend's
coarse head, and a mask extractor the single-level
``GenericRoIExtractor`` (plain RoIAlign at every listed level, fused).
PISA, hard mining and the other samplers and losses raise, naming the
ROADMAP.md item that ports them.

Public layouts are the JAX package's: images ``(B, H, W, 3)``, FPN levels
``(B, H, W, C)`` (NHWC views of channels-last NCHW maps, no copy), RoI
features ``(R, oh, ow, C)``, and detections as fixed-capacity padded
tensors with validity masks.  Submodule names are mmdet v2.3's
(``backbone``, ``neck``, ``rpn_head``, ``roi_head.bbox_head``, ...), so an
mmdet ``state_dict`` loads as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import max_iou_assign
from ...core.boxes import bbox_flip, clip_boxes, delta2bbox
from ...core.masks import mask_targets_from_instance_masks
from ...core.nms import _sort_desc, multiclass_nms, nms
from ...core.samplers import iou_balanced_neg_sample, random_sample
from ...ops.roi_align import multilevel_roi_align, roi_align_at_levels
from ...ops.roi_align_block import roi_align_block
from ...ops.roi_align_blocked import roi_align_blocked
from ...ops.roi_align_fused import roi_align_fused
from ...parallel import gather_cat
from ..backbones.hourglass import HourglassNet
from ..backbones.hrnet import HRNet
from ..backbones.resnet import RegNet, Res2Net, ResNet
from ..dense_heads.ga_rpn_head import (GARPNHead, approx_anchors,
                                       ga_proposals, ga_rpn_loss,
                                       square_anchors)
from ..dense_heads.rpn_head import RPNHead, rpn_loss, rpn_proposals
from ..losses import (balanced_l1_loss, binary_cross_entropy, cross_entropy,
                      l1_loss, mse_loss, smooth_l1_loss)
from ..necks.bfp import BFP
from ..necks.fpn import FPN
from ..necks.hrfpn import HRFPN
from ..necks.nas_fpn import NASFPN
from ..necks.pafpn import PAFPN
from ..necks.rfp import RFP
from ..roi_heads.bbox_head import (DoubleConvFCBBoxHead, Shared2FCBBoxHead,
                                   bbox_targets, scale_rois)
from ..roi_heads.mask_head import FCNMaskHead, MaskIoUHead, mask_iou_targets
from ..roi_heads.point_head import CoarseMaskHead


def boxes_to_rois(boxes, valid):
    """``(B, N, 4)`` boxes -> ``(B*N, 5)`` rois with a leading batch index,
    and the ``(B*N,)`` validity mask."""
    b, n = boxes.shape[:2]
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    idx = idx.repeat_interleave(n)[:, None]
    return torch.cat([idx, boxes.reshape(b * n, 4)], dim=1), \
        valid.reshape(b * n)


def assign_rcnn(proposals, proposal_valid, gt_bboxes, gt_valid,
                assigner_cfg):
    """Second-stage assignment of a batch with ``add_gt_as_proposals``: the
    GT boxes join the candidates ahead of the proposals (their IoU of 1
    with themselves makes them positives).  Returns the candidates
    ``(B, G+N, 4)``, their validity, assignment and max IoU."""
    cand = torch.cat([gt_bboxes, proposals], dim=1)
    cand_valid = torch.cat([gt_valid, proposal_valid], dim=1)
    assigned, max_ov = max_iou_assign(
        cand, gt_bboxes, gt_valid,
        pos_iou_thr=assigner_cfg.get("pos_iou_thr", 0.5),
        neg_iou_thr=assigner_cfg.get("neg_iou_thr", 0.5),
        min_pos_iou=assigner_cfg.get("min_pos_iou", 0.5),
        match_low_quality=assigner_cfg.get("match_low_quality", True),
        box_valid=cand_valid)
    return cand, cand_valid, assigned, max_ov


def _check_sampler(sampler_cfg):
    """The R-CNN sampler's type, ``RandomSampler`` or Libra's
    ``IoUBalancedNegSampler``; the others raise A7."""
    stype = sampler_cfg.get("type", "RandomSampler")
    if stype not in ("RandomSampler", "IoUBalancedNegSampler"):
        raise NotImplementedError(f"{stype} is not ported to bonai_tpu_torch "
                                  f"yet (ROADMAP.md item A7)")
    if not sampler_cfg.get("add_gt_as_proposals", True):
        raise NotImplementedError("add_gt_as_proposals=False is not ported "
                                  "to bonai_tpu_torch yet (ROADMAP.md item "
                                  "A7)")
    return stype


def assign_and_sample_rcnn(draw, proposals, proposal_valid, gt_bboxes,
                           gt_valid, assigner_cfg, sampler_cfg,
                           dyn_iou_topk=None):
    """Assign and sample the second-stage candidates of a batch, randomly
    (``draw`` called for two streams) or IoU-balanced (three).  Returns the
    sampler's result (``(B, num)`` each) and the sampled boxes ``(B, num,
    4)``.

    With ``dyn_iou_topk`` (Dynamic R-CNN) the result also holds
    ``stat_kth_iou`` ``(B,)``: each image's ``dyn_iou_topk``-th largest
    proposal IoU, the GTs' own matches excluded (the reference records it
    before the GTs join the candidates)."""
    stype = _check_sampler(sampler_cfg)
    cand, _, assigned, max_ov = assign_rcnn(proposals, proposal_valid,
                                            gt_bboxes, gt_valid, assigner_cfg)
    num = sampler_cfg.get("num", 512)
    pos_fraction = sampler_cfg.get("pos_fraction", 0.25)
    if stype == "IoUBalancedNegSampler":
        u_pos, u_neg, u_fill = draw(assigned.shape, assigned.device, 3)
        res = iou_balanced_neg_sample(
            assigned, max_ov, num, pos_fraction, u_pos, u_neg, u_fill,
            floor_thr=sampler_cfg.get("floor_thr", -1),
            floor_fraction=sampler_cfg.get("floor_fraction", 0.0),
            num_bins=sampler_cfg.get("num_bins", 3))
    else:
        u_pos, u_neg = draw(assigned.shape, assigned.device)
        res = random_sample(assigned, num, pos_fraction, u_pos, u_neg,
                            sampler_cfg.get("neg_pos_ub", -1))
    if dyn_iou_topk is not None:
        prop_ov = torch.where(proposal_valid, max_ov[:, gt_bboxes.shape[1]:],
                              max_ov.new_tensor(0.0))
        k = min(int(dyn_iou_topk), prop_ov.shape[1])
        res["stat_kth_iou"] = torch.topk(prop_ov, k, dim=1).values[:, -1]
    sampled = cand.gather(1, res["inds"][..., None].expand(-1, -1, 4))
    return res, sampled


def dynamic_rcnn_stats(kth_iou, bbox_targets, is_pos, beta_topk):
    """Dynamic R-CNN's batch statistics (reference
    ``dynamic_roi_head.py:73-80, 118-126``): ``stat_dyn_iou``, the mean of
    the images' ``kth_iou``, and ``stat_dyn_beta``, the ``(beta_topk *
    B)``-th smallest mean ``|dx|, |dy|`` target over the positives of the
    batch's ``B`` images, or -1 without a positive.

    In a process group both are over the global batch on every rank: the
    mean over every rank's images, and the order statistic of the union of
    the ranks' positives (``B`` the global count of images)."""
    tgt_xy = bbox_targets.reshape(-1, 4)[:, :2].abs().mean(dim=1)
    masked = gather_cat(torch.where(is_pos.reshape(-1), tgt_xy,
                                    tgt_xy.new_tensor(float("inf"))))
    kth_iou = gather_cat(kth_iou)
    order = torch.sort(masked).values
    npos = torch.isfinite(order).sum()
    kth = order[(npos.clamp(max=int(beta_topk) * kth_iou.shape[0]) - 1)
                .clamp(min=0)]
    return {"stat_dyn_iou": kth_iou.mean(),
            "stat_dyn_beta": torch.where(npos > 0, kth, kth.new_tensor(-1.0))}


def _gather_rows(x, idx):
    """``x[b, idx[b, j]]`` for ``x`` ``(B, G, ...)`` and ``idx`` ``(B, P)``
    -> ``(B*P, ...)``."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bidx, idx].reshape(-1, *x.shape[2:])


def _kwargs(cfg, name, allowed, item):
    """Constructor arguments of a sub-config; a key the port does not
    implement raises, naming the ROADMAP item that ports it."""
    cfg = dict(cfg)
    cfg.pop("type", None)
    extra = sorted(set(cfg) - set(allowed))
    if extra:
        raise NotImplementedError(
            f"{name} options {extra} are not ported to bonai_tpu_torch yet "
            f"(ROADMAP.md item {item})")
    return cfg


def _require_type(cfg, expected, item):
    t = dict(cfg).get("type", expected)
    if t != expected:
        raise NotImplementedError(
            f"{t} is not ported to bonai_tpu_torch yet (ROADMAP.md item "
            f"{item})")


RESNET_KEYS = ("depth", "num_stages", "out_indices", "frozen_stages",
               "norm_eval", "style", "base_channels", "dcn", "stage_with_dcn",
               "plugins", "deep_stem", "sac", "stage_with_sac", "output_img",
               "conv_cfg")


HOURGLASS_KEYS = ("downsample_times", "num_stacks", "stage_channels",
                  "stage_blocks", "feat_channel")


def _build_backbone(cfg):
    """A ``ResNet`` or ``DetectoRS_ResNet`` (with the DCN, plugin, SAC and
    ``output_img`` options), a ``Res2Net``, a ``RegNet``, an ``HRNet`` or
    an ``HourglassNet``; other backbones and options raise A6, and
    ``SSDVGG``, which the JAX builder refuses too (SSD builds it itself),
    ``ValueError``.  RegNet and HourglassNet take the base ResNet's keys
    that a merged config carries, and ignore them, as the JAX builder
    does; so is ``input_size`` (the NAS-FPN and CornerNet configs' trace
    size) read and ignored."""
    cfg = dict(cfg)
    cfg.pop("input_size", None)
    btype = cfg.get("type", "ResNet")
    if btype == "SSDVGG":
        raise ValueError("unsupported backbone SSDVGG in the generic "
                         "builder (the SSD detector builds its own)")
    if btype == "HourglassNet":
        kw = _kwargs(cfg, "backbone", HOURGLASS_KEYS + RESNET_KEYS, "A6")
        return HourglassNet(**{k: kw[k] for k in HOURGLASS_KEYS if k in kw})
    if btype == "HRNet":
        return HRNet(**_kwargs(cfg, "backbone", (
            "extra", "frozen_stages", "norm_eval"), "A6"))
    if btype == "RegNet":
        kw = _kwargs(cfg, "backbone", (
            "arch", "out_indices", "frozen_stages", "depth", "num_stages",
            "norm_eval", "style"), "A6")
        for k in ("depth", "num_stages", "norm_eval", "style"):
            kw.pop(k, None)
        return RegNet(**kw)
    if btype == "Res2Net":
        return Res2Net(**_kwargs(cfg, "backbone", RESNET_KEYS + (
            "scales", "base_width", "avg_down"), "A6"))
    if btype != "DetectoRS_ResNet":
        _require_type(cfg, "ResNet", "A6")
    return ResNet(**_kwargs(cfg, "backbone", RESNET_KEYS, "A6"))


def _build_neck(cfg):
    """An ``FPN``, a ``PAFPN``, an ``HRFPN``, a ``NASFPN`` or DetectoRS's
    ``RFP``, or a chain of necks (``NASFCOS_FPN``, which the JAX builder
    refuses too, raises ``ValueError``):
    Libra R-CNN's ``[FPN, BFP]`` (an ``nn.Sequential``: mmdet's
    ``neck.0``, ``neck.1``); another chain raises A7, other necks A6."""
    if isinstance(cfg, (list, tuple)):
        types = [dict(c).get("type") for c in cfg]
        if len(cfg) < 2 or types[0] != "FPN" or any(
                t != "BFP" for t in types[1:]):
            raise NotImplementedError(
                f"chained necks {types} are not ported to bonai_tpu_torch "
                f"yet (ROADMAP.md item A7)")
        return nn.Sequential(_build_neck(cfg[0]), *(BFP(**_kwargs(
            c, "BFP", ("in_channels", "num_levels", "refine_level",
                       "refine_type"), "A7")) for c in cfg[1:]))
    if dict(cfg).get("type") == "HRFPN":
        return HRFPN(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs"), "A6"))
    if dict(cfg).get("type") == "RFP":
        return RFP(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs", "rfp_steps",
            "rfp_backbone", "aspp_out_channels", "aspp_dilations"), "A6"))
    if dict(cfg).get("type") == "NASFPN":
        return NASFPN(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs", "stack_times",
            "start_level", "add_extra_convs"), "A6"))
    if dict(cfg).get("type") == "NASFCOS_FPN":
        raise ValueError("unsupported neck NASFCOS_FPN in the generic "
                         "builder (the NASFCOS detector builds its own)")
    if dict(cfg).get("type") == "PAFPN":
        return PAFPN(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs", "start_level",
            "add_extra_convs"), "A6"))
    _require_type(cfg, "FPN", "A6")
    return FPN(**_kwargs(cfg, "neck", (
        "in_channels", "out_channels", "num_outs", "start_level",
        "end_level", "add_extra_convs", "extra_convs_on_inputs",
        "relu_before_extra_convs"), "A6"))


def _refuse_roi_keys(cfg, cascade=False):
    """The C4 shared head, and a cascade's Mask Scoring IoU head: a
    detector type the port builds (a C4 config is a ``FasterRCNN``) could
    carry them, so they raise."""
    unported = [k for k in ("mask_iou_head", "shared_head")
                if cfg.get(k) is not None
                and (cascade or k == "shared_head")]
    if unported:
        raise NotImplementedError(
            f"roi_head parts {unported} are not ported to bonai_tpu_torch "
            f"yet (ROADMAP.md item A7)")


def _bbox_head(cfg, reg_class_agnostic=False, cascade=False):
    """The box head of config ``cfg`` (``reg_class_agnostic``: the default
    when the config does not say), its coder's config and its
    ``loss_bbox`` config.  A ``Shared2FCBBoxHead`` or, but for a cascade's
    stage, Double-Head's ``DoubleConvFCBBoxHead``.  Its ``loss_bbox`` may
    be ``L1Loss`` or ``SmoothL1Loss`` (the JAX package computes L1 for
    both, ROADMAP.md queue C) or, but for a cascade's stage, Libra's
    ``BalancedL1Loss`` on the deltas."""
    bh = dict(cfg)
    heads, losses = ("Shared2FCBBoxHead",), ("L1Loss", "SmoothL1Loss")
    if not cascade:
        heads += ("DoubleConvFCBBoxHead",)
        losses += ("BalancedL1Loss",)
    htype = bh.get("type", "Shared2FCBBoxHead")
    if htype not in heads:
        raise NotImplementedError(f"{htype} is not ported to bonai_tpu_torch "
                                  f"yet (ROADMAP.md item A7)")
    loss = dict(bh.get("loss_bbox") or {})
    if loss.get("type", "L1Loss") not in losses:
        raise NotImplementedError(f"loss_bbox {loss['type']} is not ported "
                                  f"to bonai_tpu_torch yet (ROADMAP.md item "
                                  f"A7)")
    if bh.get("reg_decoded_bbox", False):
        raise NotImplementedError("reg_decoded_bbox=True is not ported to "
                                  "bonai_tpu_torch yet (ROADMAP.md item A7)")
    coder = dict(bh.get("bbox_coder", {}))
    _require_type(coder, "DeltaXYWHBBoxCoder", "A7")
    agnostic = bh.get("reg_class_agnostic", reg_class_agnostic)
    if htype == "DoubleConvFCBBoxHead":
        head = DoubleConvFCBBoxHead(
            bh.get("num_classes", 1), bh.get("num_convs", 4),
            bh.get("num_fcs", 2), bh.get("in_channels", 256),
            bh.get("conv_out_channels", 1024),
            bh.get("fc_out_channels", 1024), bh.get("roi_feat_size", 7),
            agnostic)
    else:
        head = Shared2FCBBoxHead(
            bh.get("num_classes", 1), bh.get("in_channels", 256),
            bh.get("fc_out_channels", 1024), bh.get("roi_feat_size", 7),
            agnostic, bh.get("with_reg", True))
    return head, coder, loss


class TwoStageDetector(nn.Module):
    """FPN two-stage trunk: ResNet (DCN, plugins), Res2Net or RegNet + FPN
    (+ BFP) or PAFPN, or HRNet + HRFPN; RPN, a box head and an optional
    mask head."""

    has_rpn = True          # Fast R-CNN: proposals come with the batch

    @property
    def takes_proposals(self):
        """Whether ``simple_test`` takes the proposals as inputs (Fast
        R-CNN's)."""
        return not self.has_rpn

    def __init__(self, backbone, neck, rpn_head, roi_head, train_cfg=None,
                 test_cfg=None, roi_align_impl=None):
        super().__init__()
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.roi_align_impl = roi_align_impl
        self.backbone = _build_backbone(backbone)
        self.neck = _build_neck(neck)
        self._anchors = {}
        if self.has_rpn:
            self._setup_rpn(dict(rpn_head))
        self.roi_head = nn.ModuleDict()
        if roi_head is not None:
            self._setup_roi_head(dict(roi_head))
            rcnn = (train_cfg or {}).get("rcnn")
            for stage in (rcnn if isinstance(rcnn, (list, tuple))
                          else [rcnn] if rcnn else []):
                _check_sampler(dict(dict(stage).get("sampler", {})))

    ga_rpn = False          # the Guided Anchoring RPN
    semi_rpn = False        # SemiRPNHead: footprint boxes where flagged

    def _setup_rpn(self, rh):
        if rh.get("type") == "GARPNHead":
            self._setup_ga_rpn(rh)
            return
        self.semi_rpn = rh.get("type") == "SemiRPNHead"
        if not self.semi_rpn:
            _require_type(rh, "RPNHead", "A6")
        ag = dict(rh.get("anchor_generator", {}))
        _require_type(ag, "AnchorGenerator", "A6")
        ag.pop("type", None)
        self.anchor_generator = AnchorGenerator(**ag)
        # the RPN decodes with unit stds whatever its bbox_coder says, as
        # the JAX package does (ROADMAP.md queue C)
        _require_type(rh.get("bbox_coder", {}), "DeltaXYWHBBoxCoder", "A6")
        self.rpn_head = RPNHead(
            rh.get("in_channels", 256), rh.get("feat_channels", 256),
            len(ag.get("ratios", [0.5, 1.0, 2.0]))
            * len(ag.get("scales", [8])))

    def _setup_ga_rpn(self, rh):
        """``GARPNHead`` and its approximate anchors' settings (the squares
        are ``octave_base_scale * stride`` on each cell, as in the JAX
        package, whatever ``square_anchor_generator`` says)."""
        ag = dict(rh.get("approx_anchor_generator", {}))
        self.ga_rpn = True
        self.ga_strides = [s if isinstance(s, (int, float)) else s[0]
                           for s in ag.get("strides", [4, 8, 16, 32, 64])]
        self.ga_octave_base_scale = ag.get("octave_base_scale", 8)
        self.ga_scales_per_octave = ag.get("scales_per_octave", 3)
        self.ga_ratios = tuple(ag.get("ratios", (0.5, 1.0, 2.0)))
        self.loc_filter_thr = rh.get("loc_filter_thr", 0.01)
        self.rpn_head = GARPNHead(rh.get("in_channels", 256),
                                  rh.get("feat_channels", 256))

    def _setup_roi_head(self, cfg):
        """The box head (Double-Head's: its reg RoIs scaled by
        ``reg_roi_scale_factor``), its extractor and loss, and the mask
        branch."""
        _refuse_roi_keys(cfg)
        self.roi_head["bbox_head"], self.bbox_coder, loss = _bbox_head(
            cfg["bbox_head"])
        self.bbox_loss_cfg = loss if loss.get("type") == "BalancedL1Loss" \
            else None
        self.reg_roi_scale_factor = cfg.get("reg_roi_scale_factor", 1.3) \
            if isinstance(self.roi_head["bbox_head"],
                          DoubleConvFCBBoxHead) else None
        self.bbox_extractor_cfg = self._extractor(cfg["bbox_roi_extractor"])
        self._setup_mask_head(cfg)

    def _setup_mask_head(self, cfg):
        """The optional mask head (FCN, or PointRend's coarse head) and its
        extractor (a Faster R-CNN config has neither), and Mask Scoring's
        IoU head."""
        if cfg.get("mask_head") is None:
            return
        mh = dict(cfg["mask_head"])
        if mh.get("type") == "CoarseMaskHead":
            self.roi_head["mask_head"] = CoarseMaskHead(
                mh.get("num_convs", 0), mh.get("num_fcs", 2),
                mh.get("in_channels", 256), mh.get("conv_out_channels", 256),
                mh.get("fc_out_channels", 1024), mh.get("num_classes", 1),
                mh.get("roi_feat_size", 14))
        else:
            _require_type(mh, "FCNMaskHead", "A7")
            self.roi_head["mask_head"] = FCNMaskHead(
                mh.get("num_convs", 4), mh.get("in_channels", 256),
                mh.get("conv_out_channels", 256), mh.get("num_classes", 1))
        self.mask_extractor_cfg = self._extractor(cfg["mask_roi_extractor"])
        if cfg.get("mask_iou_head") is None:
            return
        mi = dict(cfg["mask_iou_head"])
        _require_type(mi, "MaskIoUHead", "A7")
        self.roi_head["mask_iou_head"] = MaskIoUHead(
            mi.get("num_convs", 4), mi.get("num_fcs", 2),
            mi.get("in_channels", 256), mi.get("conv_out_channels", 256),
            mi.get("fc_out_channels", 1024), mi.get("num_classes", 1),
            dict(self.mask_extractor_cfg.get("roi_layer", {})).get(
                "output_size", 14))
        self.mask_iou_loss_weight = dict(mi.get("loss_iou") or {}).get(
            "loss_weight", 0.5)

    @property
    def with_mask(self):
        return "mask_head" in self.roi_head

    @staticmethod
    def _extractor(cfg):
        """A ``SingleRoIExtractor`` with ``RoIAlign``, or a
        ``GenericRoIExtractor`` with ``RoIAlign`` or ``SimpleRoIAlign``
        (sampled 2x2 a bin as the JAX package samples both, where mmcv's
        ``SimpleRoIAlign`` takes each bin's centre: ROADMAP.md queue C) and
        without GRoIE's ``pre_cfg``/``post_cfg``; others raise A7."""
        cfg = dict(cfg)
        layers = ("RoIAlign",)
        if cfg.get("type") == "GenericRoIExtractor":
            groie = sorted(k for k in ("pre_cfg", "post_cfg") if cfg.get(k))
            if groie:
                raise NotImplementedError(
                    f"GenericRoIExtractor options {groie} (GRoIE) are not "
                    f"ported to bonai_tpu_torch yet (ROADMAP.md item A7)")
            layers += ("SimpleRoIAlign",)
        else:
            _require_type(cfg, "SingleRoIExtractor", "A7")
        layer = dict(cfg.get("roi_layer", {})).get("type", "RoIAlign")
        if layer not in layers:
            raise NotImplementedError(f"{layer} is not ported to "
                                      f"bonai_tpu_torch yet (ROADMAP.md item "
                                      f"A7)")
        return cfg

    def init_weights(self, gen):
        """Seeded random weights from the ``torch.Generator`` ``gen``."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(gen)

    # ---------------- shared helpers ----------------
    def extract_feat(self, img):
        """``(B, H, W, 3)`` image -> tuple of NHWC FPN levels.

        On the CPU the backbone runs in contiguous NCHW: PyTorch's CPU
        (oneDNN) weight gradient of a strided 1x1 convolution over a
        channels-last input that needs no gradient (``layer2``'s
        downsample behind the frozen ``layer1``) corrupts the heap."""
        x = img.permute(0, 3, 1, 2)
        if not x.is_cuda:
            x = x.contiguous()
        feats = self.neck(self.backbone(x))
        return tuple(f.permute(0, 2, 3, 1) for f in feats)

    def _roi_align_cfg(self, extractor_cfg, feats, rois, roi_valid):
        """RoI features for one extractor config, by ``impl`` (the
        extractor's, else the detector's ``roi_align_impl``):

        - ``'block'`` on CUDA tensors: the ``roi_align_block`` kernels;
        - ``'pallas'`` on CUDA tensors: ``roi_align_fused``, the same
          kernels under the strip rule, with the extractor's
          ``roi_backward`` (``'rmw'``, the backward kernel, by default;
          or ``'scatter'``);
        - ``'block'`` and ``'pallas'`` on CPU tensors: the gather-rule
          ``multilevel_roi_align``, as the JAX package does off the TPU
          (they differ from it only for RoIs their level rules push
          coarser);
        - ``'blocked'``: ``roi_align_blocked`` on both devices, as in JAX;
        - ``'gather'`` (the default): ``multilevel_roi_align``.

        A ``GenericRoIExtractor`` pools every RoI from every listed level
        with the plain ``roi_align_at_levels`` (the JAX package runs it in
        XLA, with no Pallas kernel) and fuses the levels by its
        ``aggregation`` (``sum`` or ``concat``), whatever the route."""
        layer = dict(extractor_cfg.get("roi_layer", {}))
        out_size = layer.get("output_size", 7)
        sr = layer.get("sampling_ratio", 0) or 2    # static grid
        strides = list(extractor_cfg.get("featmap_strides", [4, 8, 16, 32]))
        if extractor_cfg.get("type") == "GenericRoIExtractor":
            lvl = torch.zeros(rois.shape[0], dtype=torch.long,
                              device=rois.device)
            outs = [roi_align_at_levels([f], rois, lvl, out_size, [s], sr,
                                        roi_valid=roi_valid)
                    for f, s in zip(feats, strides)]
            return sum(outs) if extractor_cfg.get(
                "aggregation", "sum") == "sum" else torch.cat(outs, -1)
        impl = extractor_cfg.get("impl", self.roi_align_impl or "gather")
        if impl not in ("block", "pallas", "blocked", "gather"):
            raise NotImplementedError(
                f"roi_align_impl={impl!r} is not ported to bonai_tpu_torch")
        levels = [f.contiguous() for f in feats[:len(strides)]]
        extra = {}
        if impl == "blocked":
            fn = roi_align_blocked
        elif impl == "block" and levels[0].is_cuda:
            fn = roi_align_block
        elif impl == "pallas" and levels[0].is_cuda:
            fn = roi_align_fused
            extra["backward"] = extractor_cfg.get("roi_backward", "rmw")
        else:
            fn = multilevel_roi_align
        return fn(levels, rois, out_size, strides, sampling_ratio=sr,
                  finest_scale=extractor_cfg.get("finest_scale", 56),
                  roi_valid=roi_valid, **extra)

    def _bbox_head_forward(self, head, feats, rois, roi_valid):
        """``head`` on its RoI features: one RoIAlign call, or two for
        Double-Head (the reg branch's on the RoIs scaled about their
        centres by ``reg_roi_scale_factor``, not clipped)."""
        x = self._roi_align_cfg(self.bbox_extractor_cfg, feats, rois,
                                roi_valid)
        if not isinstance(head, DoubleConvFCBBoxHead):
            return head(x)
        return head(x, self._roi_align_cfg(
            self.bbox_extractor_cfg, feats,
            scale_rois(rois, self.reg_roi_scale_factor), roi_valid))

    def _grid_anchors(self, feats):
        sizes = tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)
        key = (sizes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(feats[0].device)
                for a in self.anchor_generator.grid_anchors(sizes)]
        return self._anchors[key]

    def _ga_anchors(self, feats):
        """GA-RPN's per-level squares and the levels' concatenated
        approximate anchors ``(N, 9, 4)``, built once per size."""
        sizes = tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)
        key = ("ga", sizes, feats[0].device)
        if key not in self._anchors:
            dev = feats[0].device
            squares = square_anchors(sizes, self.ga_strides,
                                     self.ga_octave_base_scale)
            approxs = approx_anchors(sizes, self.ga_strides,
                                     self.ga_octave_base_scale,
                                     self.ga_scales_per_octave,
                                     self.ga_ratios)
            self._anchors[key] = (
                [torch.from_numpy(a).float().to(dev) for a in squares],
                torch.from_numpy(np.concatenate(approxs)).float().to(dev))
        return self._anchors[key]

    def _rpn_and_proposals(self, feats, img_shape, proposal_cfg):
        outs = self.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
        return self._proposals(outs, feats, img_shape, proposal_cfg)

    def _proposals(self, outs, feats, img_shape, proposal_cfg):
        """Proposals ``(B, K, 4)``, their scores and validity from the RPN
        head's outputs ``outs``."""
        if self.ga_rpn:
            return ga_proposals(*outs, self._ga_anchors(feats)[0],
                                img_shape, proposal_cfg,
                                self.loc_filter_thr)
        return rpn_proposals(*outs, self._grid_anchors(feats), img_shape,
                             proposal_cfg)

    def _semi_rpn_gt(self, batch, img_aux):
        """``SemiRPNHead``'s GT boxes and per-image regression weight: a
        footprint-only image (``gt_only_footprint_flag``) is supervised by
        its footprint boxes, classification only, unless the predicted
        off-nadir angle (``img_aux['angle_pred']``) is under 10 degrees,
        where footprint and roof nearly coincide.  Other RPNs, and a batch
        without footprint boxes: the GT boxes, no weight."""
        gt = batch["gt_bboxes"]
        if not self.semi_rpn or "gt_footprint_bboxes" not in batch:
            return gt, None
        flag = batch.get("gt_only_footprint_flag")
        if flag is None:
            flag = gt.new_zeros(gt.shape[0])
        flag = flag.float()
        gt = torch.where(flag[:, None, None] > 0.5,
                         batch["gt_footprint_bboxes"], gt)
        if "angle_pred" in img_aux:
            deg = img_aux["angle_pred"][:, 0].abs() * (180.0 / math.pi)
            flag = flag * (deg >= 10.0).float()
        return gt, 1.0 - flag

    def _rpn_train(self, feats, batch, draw, img_aux=None):
        """The RPN's losses of a batch and its proposals (constants of the
        step); ``draw`` is called for the RPN's sampler (GA-RPN: the shape
        sampler's, then the RPN sampler's).  ``img_aux`` holds the image
        heads' predictions (:meth:`_image_level_train`)."""
        outs = self.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
        with torch.no_grad():       # proposals are constants of the step
            proposals, _, prop_valid = self._proposals(
                outs, feats, batch["img_shape"],
                dict(self.train_cfg.get("rpn_proposal", {})))
        if self.ga_rpn:
            squares, approxs = self._ga_anchors(feats)
            losses = ga_rpn_loss(
                *outs, torch.cat(squares), approxs, batch["gt_bboxes"],
                batch["gt_valid"], draw, dict(self.train_cfg["rpn"]),
                self.ga_strides, self.ga_octave_base_scale)
        else:
            gt, reg_weight = self._semi_rpn_gt(batch, img_aux or {})
            losses = rpn_loss(*outs, torch.cat(self._grid_anchors(feats)),
                              gt, batch["gt_valid"], draw,
                              dict(self.train_cfg["rpn"]),
                              reg_weight=reg_weight)
        return losses, proposals.detach(), prop_valid

    # ---------------- training ----------------
    def forward_train(self, batch, draw):
        """The loss dict of one padded batch.

        ``batch`` holds the JAX package's batch contract as tensors on the
        model's device: ``image`` ``(B, H, W, 3)`` normalised, ``img_shape``
        ``(B, 2)``, ``gt_bboxes`` ``(B, G, 4)``, ``gt_labels``, ``gt_valid``
        ``(B, G)``, ``gt_masks`` ``(B, G, M, M)`` instance-local masks and,
        for LOFT, ``gt_offsets`` ``(B, G, 2)``.  ``draw`` is the samplers'
        draw source (:func:`~bonai_tpu_torch.core.samplers.generator_draws`),
        called for the RPN and then for the R-CNN.
        """
        feats = self.extract_feat(batch["image"])
        img_losses, img_aux = self._image_level_train(feats, batch)
        losses, proposals, prop_valid = self._rpn_train(feats, batch, draw,
                                                        img_aux)
        losses.update(img_losses)
        losses.update(self._roi_forward_train(
            feats, proposals, prop_valid, batch, draw))
        return losses

    def _image_level_train(self, feats, batch):
        """The image-level heads' losses and predictions ``(losses,
        aux)``; LOFT's angle head gives ``aux['angle_pred']``, which gates
        ``SemiRPNHead``."""
        return {}, {}

    def forward(self, batch, draw):
        """:meth:`forward_train`, so that ``DistributedDataParallel``,
        which reduces the gradients only of calls through the wrapper,
        can wrap it."""
        return self.forward_train(batch, draw)

    def _roi_forward_train(self, feats, proposals, prop_valid, batch, draw):
        """The R-CNN losses of one batch.  Under Dynamic R-CNN
        (``train_cfg.rcnn.dynamic_rcnn``) the assigner's thresholds are the
        batch's ``dyn_iou_thr`` (the config's without one), the box loss is
        SmoothL1 at the batch's ``dyn_beta`` (the config's
        ``initial_beta`` without one), and the dict holds the batch's
        ``stat_dyn_iou`` and ``stat_dyn_beta``
        (:func:`dynamic_rcnn_stats`)."""
        rcnn = dict(self.train_cfg["rcnn"])
        unported = sorted(k for k in ("isr", "carl") if rcnn.get(k))
        if unported:
            raise NotImplementedError(f"train_cfg.rcnn options {unported} "
                                      f"are not ported to bonai_tpu_torch "
                                      f"yet (ROADMAP.md item A7)")
        dyn = rcnn.get("dynamic_rcnn")
        assigner_cfg = dict(rcnn["assigner"])
        if dyn is not None and "dyn_iou_thr" in batch:
            thr = batch["dyn_iou_thr"]
            assigner_cfg.update(pos_iou_thr=thr, neg_iou_thr=thr,
                                min_pos_iou=thr)
        sampler_cfg = dict(rcnn["sampler"])
        num = sampler_cfg.get("num", 512)
        num_pos = int(num * sampler_cfg.get("pos_fraction", 0.25))
        res, sampled = assign_and_sample_rcnn(
            draw, proposals, prop_valid, batch["gt_bboxes"],
            batch["gt_valid"], assigner_cfg, sampler_cfg,
            dyn_iou_topk=None if dyn is None else dyn.get("iou_topk", 75))
        head = self.roi_head["bbox_head"]
        st = self._bbox_stage(head, self.bbox_coder, feats, sampled, res,
                              batch)
        nc = head.fc_cls.out_features - 1
        losses = {"loss_cls": st["loss_cls"]}
        if head.fc_reg is not None:             # Grid R-CNN's head has none
            losses["loss_bbox"] = self._bbox_loss(st, nc, dyn, batch)
        if dyn is not None:
            losses.update(dynamic_rcnn_stats(
                res["stat_kth_iou"], st["bbox_t"], st["labels"] < nc,
                dyn.get("beta_topk", 10)))
        # the mask and extra branches take the positive slots (the sampler
        # ranks the positives first)
        pos_boxes = sampled[:, :num_pos]
        pos_is_pos = res["is_pos"][:, :num_pos]
        pos_gt = res["pos_gt_inds"][:, :num_pos]
        losses.update(self._mask_forward_train(feats, batch, rcnn, pos_boxes,
                                               pos_is_pos, pos_gt, draw))
        losses.update(self._extra_forward_train(feats, batch, rcnn,
                                                pos_boxes, pos_is_pos,
                                                pos_gt, draw))
        return losses

    def _bbox_loss(self, st, nc, dyn, batch):
        """The box loss of a ``_bbox_stage`` result: the configured one,
        or SmoothL1 at the batch's beta under Dynamic R-CNN."""
        n_tot = st["labels"].shape[0]
        if st["bbox_pred"].shape[1] == 4:       # class-agnostic or one class
            pred4 = st["bbox_pred"][:, :4]
        else:
            pred4 = st["bbox_pred"].reshape(n_tot, nc, 4).gather(
                1, st["labels"].clamp(0, nc - 1)[:, None, None]
                .expand(-1, 1, 4))[:, 0]
        if dyn is None and self.bbox_loss_cfg is not None:
            lc = dict(self.bbox_loss_cfg)
            lc.pop("type")
            lc.pop("reduction", None)
            return balanced_l1_loss(pred4, st["bbox_t"], st["bbox_w"],
                                    avg_factor=float(n_tot), **lc)
        if dyn is None:
            return l1_loss(pred4, st["bbox_t"], st["bbox_w"],
                           avg_factor=float(n_tot))
        return smooth_l1_loss(
            pred4, st["bbox_t"],
            batch.get("dyn_beta", dyn.get("initial_beta", 1.0)),
            st["bbox_w"], avg_factor=float(n_tot))

    def _bbox_stage(self, head, coder, feats, sampled, res, batch,
                    **head_kw):
        """One box head on the sampled boxes ``(B, num, 4)`` of a batch:
        the targets of ``coder`` (flattened to ``B*num`` rows), the head's
        deltas, the classification loss and the RoIs.  ``head_kw`` go to
        :meth:`_bbox_head_forward` (HTC's semantic feature)."""
        nc = head.fc_cls.out_features - 1
        labels, label_w, bbox_t, bbox_w = bbox_targets(
            sampled, res, batch["gt_bboxes"], batch["gt_labels"], nc,
            tuple(coder.get("target_means", (0.,) * 4)),
            tuple(coder.get("target_stds", (1.,) * 4)))
        rois, roi_valid = boxes_to_rois(sampled, res["valid"])
        cls_score, bbox_pred = self._bbox_head_forward(head, feats, rois,
                                                       roi_valid, **head_kw)
        labels, label_w = labels.reshape(-1), label_w.reshape(-1)
        return {"labels": labels, "bbox_t": bbox_t.reshape(-1, 4),
                "bbox_w": bbox_w.reshape(-1, 4), "bbox_pred": bbox_pred,
                "rois": rois,
                "loss_cls": cross_entropy(
                    cls_score, labels, label_w,
                    avg_factor=(label_w > 0).sum().float().clamp(min=1.0))}

    def _mask_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                            pos_gt, draw):
        """The mask losses on the positive slots ``(B, P)``: the mask head's
        at ``train_cfg.rcnn.mask_size``, Mask Scoring's IoU loss, and
        :meth:`_mask_refine_train`'s."""
        if not self.with_mask:
            return {}
        mask_size = rcnn.get("mask_size", 28)
        rois, roi_valid = boxes_to_rois(pos_boxes, pos_is_pos)
        mask_feats = self._roi_align_cfg(self.mask_extractor_cfg, feats,
                                         rois, roi_valid)
        mask_logits = self.roi_head["mask_head"](mask_feats)
        logits = mask_logits[:, 0]
        gt_boxes = _gather_rows(batch["gt_bboxes"], pos_gt)
        gt_masks = _gather_rows(batch["gt_masks"], pos_gt)
        targets = mask_targets_from_instance_masks(
            rois[:, 1:5], gt_boxes, gt_masks, mask_size)
        w = roi_valid.float()[:, None, None]
        losses = {"loss_mask": binary_cross_entropy(
            logits, targets, w.expand_as(logits),
            avg_factor=(w.sum() * mask_size * mask_size).clamp(min=1.0))}
        if "mask_iou_head" in self.roi_head:
            # Mask Scoring: MSE on the positives with a nonzero target; the
            # IoU head's input keeps its gradient, the targets have none
            iou_pred = self.roi_head["mask_iou_head"](mask_feats,
                                                      mask_logits)[:, 0]
            iou_t = mask_iou_targets(
                logits.detach(), targets, rois[:, 1:5], gt_boxes, gt_masks,
                rcnn.get("mask_thr_binary", 0.5))
            wi = roi_valid.float() * (iou_t > 0).float()
            losses["loss_mask_iou"] = self.mask_iou_loss_weight * mse_loss(
                iou_pred, iou_t, wi, avg_factor=wi.sum().clamp(min=1.0))
        losses.update(self._mask_refine_train(feats, rcnn, rois, roi_valid,
                                              mask_logits, gt_boxes,
                                              gt_masks, draw))
        return losses

    def _mask_refine_train(self, feats, rcnn, rois, roi_valid, mask_logits,
                           gt_boxes, gt_masks, draw):
        """Losses of a refinement of the mask logits (PointRend's)."""
        return {}

    def _extra_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                             pos_gt, draw):
        return {}

    # ---------------- inference ----------------
    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor):
        """Batched inference on ``(B, H, W, 3)`` normalised, padded images
        with ``img_shape`` ``(B, 2)`` (resized h, w) and ``scale_factor``
        ``(B,)``.  Returns padded, fixed-shape results: ``det_bboxes``
        ``(B, P, 4)`` in original-image pixels, ``det_scores``,
        ``det_labels``, ``det_valid``, with a mask head ``mask_probs``
        ``(B, P, 28, 28)``, and the extra branches' outputs."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        proposals, _, prop_valid = self._rpn_and_proposals(
            feats, img_shape, dict(self.test_cfg.get("rpn", {})))
        return self._rcnn_simple_test(feats, proposals, prop_valid,
                                      img_shape, scale_factor)

    def _rcnn_simple_test(self, feats, proposals, prop_valid, img_shape,
                          scale_factor):
        rcnn = dict(self.test_cfg["rcnn"])
        b, n = proposals.shape[:2]
        rois, roi_valid = boxes_to_rois(proposals, prop_valid)
        cls_score, bbox_pred = self._bbox_head_forward(
            self.roi_head["bbox_head"], feats, rois, roi_valid)
        scores = torch.softmax(cls_score, dim=-1).reshape(b, n, -1)
        boxes = delta2bbox(proposals, bbox_pred.reshape(b, n, -1),
                           self.bbox_coder.get("target_means", (0.,) * 4),
                           self.bbox_coder.get("target_stds", (1.,) * 4))
        hw = (img_shape[:, 0, None, None].float(),
              img_shape[:, 1, None, None].float())
        boxes = clip_boxes(boxes.reshape(b, n, -1, 4), hw).reshape(b, n, -1)
        det_boxes, det_scores, det_labels, det_valid = multiclass_nms(
            boxes, scores, rcnn.get("score_thr", 0.05),
            dict(rcnn.get("nms", dict(type="nms", iou_threshold=0.5))),
            rcnn.get("max_per_img", 100), valid=prop_valid)
        return self._detections_out(feats, det_boxes, det_scores, det_labels,
                                    det_valid, img_shape, scale_factor)

    def _detections_out(self, feats, det_boxes, det_scores, det_labels,
                        det_valid, img_shape, scale_factor):
        """The detections in original-image pixels, with the mask and extra
        branches run on their scale-space boxes.  Mask Scoring's
        ``mask_scores`` are the detection scores times the predicted IoU
        of each detection's class."""
        b = det_boxes.shape[0]
        sf = scale_factor.float()[:, None, None]
        out = {"det_bboxes": det_boxes / sf, "det_scores": det_scores,
               "det_labels": det_labels, "det_valid": det_valid}
        if self.with_mask:
            rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
            mask_feats = self._roi_align_cfg(self.mask_extractor_cfg, feats,
                                             rois, roi_valid)
            logits = self.roi_head["mask_head"](mask_feats)
            probs = self._mask_probs(feats, rois, logits)
            out["mask_probs"] = probs.reshape(b, -1, *probs.shape[1:])
            if "mask_iou_head" in self.roi_head:
                iou = self.roi_head["mask_iou_head"](mask_feats, logits)
                sel = iou.gather(1, det_labels.reshape(-1, 1).long().clamp(
                    0, iou.shape[1] - 1))
                out["mask_scores"] = det_scores * sel.reshape(
                    det_scores.shape)
        out.update(self._extra_simple_test(feats, det_boxes, det_valid,
                                           img_shape, scale_factor))
        return out

    def _mask_probs(self, feats, rois, logits):
        """The mask probabilities ``(N, H, W)`` of the detections' mask
        logits ``(N, K, H, W)`` (PointRend refines them)."""
        return torch.sigmoid(logits[:, 0])

    def _extra_simple_test(self, feats, det_boxes, det_valid, img_shape,
                           scale_factor):
        return {}

    # ---------------- proposal-level test-time augmentation ----------------
    def _refuse_aug_test(self, why):
        raise ValueError(f"{type(self).__name__} has no proposal-level "
                         f"test-time augmentation: {why}")

    def _aug_test_box_head(self):
        """The box head and coder config that :meth:`aug_test` scores the
        merged proposals with."""
        return self.roi_head["bbox_head"], self.bbox_coder

    @torch.inference_mode()
    def aug_test(self, img, img_shape, scale_factor, scales=(1.0,),
                 flip_directions=(None, "horizontal")):
        """Proposal-level test-time augmentation over the views ``scales``
        x ``flip_directions`` (``None``: unflipped), the JAX package's
        ``aug_test`` (mmdetection's ``merge_aug_proposals``,
        ``merge_aug_bboxes`` and ``merge_aug_masks``):

        1. every view's proposals, mapped back to the base frame, are
           merged by plain NMS (the test RPN's ``nms_thr``) and the best
           ``max_num`` kept;
        2. the merged proposals are scored in every view, and the views'
           decoded, clipped and unflipped boxes and softmax scores are
           averaged before one ``multiclass_nms``;
        3. every view's mask probabilities of the detections, unflipped,
           are averaged, and so are the extra branches' outputs
           (``_extra_simple_test``): an output whose key ends in
           ``offsets`` has its component along the flip negated, one whose
           key holds ``probs`` keeps the unflipped views only.

        A flip mirrors the whole padded canvas of its scale; a scale view
        resizes the canvas (:func:`apis.test.resize_image`).  Every RoI
        feature goes through ``_roi_align_cfg``.  Returns the outputs of
        ``simple_test``."""
        from ...apis.test import resize_image, tta_size
        head, coder = self._aug_test_box_head()
        test_rpn = dict(self.test_cfg.get("rpn", {}))
        rcnn = dict(self.test_cfg["rcnn"])
        dtype = next(self.parameters()).dtype
        b = img.shape[0]
        pad_h, pad_w = float(img.shape[1]), float(img.shape[2])
        img_shape, scale_factor = img_shape.float(), scale_factor.float()

        views = []          # (feats, img_shape, (sy, sx), direction, (ph, pw))
        for s in scales:
            if s == 1.0:
                img_s, shape_s, sy, sx = img, img_shape, 1.0, 1.0
                ph, pw = pad_h, pad_w
            else:
                nh, nw = tta_size(pad_h, s), tta_size(pad_w, s)
                sy, sx = nh / pad_h, nw / pad_w
                img_s = resize_image(img, nh, nw)
                shape_s = img_shape * img_shape.new_tensor([sy, sx])
                ph, pw = float(nh), float(nw)
            for direction in flip_directions:
                img_v = img_s if direction is None else torch.flip(
                    img_s, [2 if direction == "horizontal" else 1])
                views.append((self.extract_feat(img_v.to(dtype)), shape_s,
                              (sy, sx), direction, (ph, pw)))
        nviews = img.new_tensor(float(len(views)))

        # (1) the views' proposals merged in the base frame
        props, scores, valid = [], [], []
        for feats, shape_v, (sy, sx), direction, (ph, pw) in views:
            p, sc, v = self._rpn_and_proposals(feats, shape_v, test_rpn)
            if direction is not None:
                p = bbox_flip(p, (ph, pw), direction)
            props.append(p / p.new_tensor([sx, sy, sx, sy]))
            scores.append(sc.float())
            valid.append(v)
        props, scores, valid = (torch.cat(x, 1)
                                for x in (props, scores, valid))
        max_num = int(test_rpn.get("max_num", 1000))
        keep = nms(props, scores, float(test_rpn.get("nms_thr", 0.7)),
                   valid=valid)
        top, idx = (t[:, :max_num] for t in _sort_desc(
            torch.where(keep, scores, torch.full_like(scores, -1.0))))
        proposals = props.gather(1, idx[..., None].expand(-1, -1, 4))
        prop_valid = top > 0

        # (2) the merged proposals scored in every view, averaged
        n = proposals.shape[1]
        sum_boxes = sum_scores = 0.0
        for feats, shape_v, (sy, sx), direction, (ph, pw) in views:
            props_v = proposals * proposals.new_tensor([sx, sy, sx, sy])
            if direction is not None:
                props_v = bbox_flip(props_v, (ph, pw), direction)
            rois, roi_valid = boxes_to_rois(props_v, prop_valid)
            cls_score, bbox_pred = self._bbox_head_forward(head, feats, rois,
                                                           roi_valid)
            sum_scores = sum_scores + torch.softmax(
                cls_score, dim=-1).reshape(b, n, -1)
            boxes_v = delta2bbox(props_v, bbox_pred.reshape(b, n, -1),
                                 coder.get("target_means", (0.,) * 4),
                                 coder.get("target_stds", (1.,) * 4))
            boxes_v = clip_boxes(boxes_v.reshape(b, n, -1, 4),
                                 (shape_v[:, 0, None, None],
                                  shape_v[:, 1, None, None]))
            if direction is not None:
                boxes_v = bbox_flip(boxes_v, (ph, pw), direction)
            sum_boxes = sum_boxes + boxes_v / boxes_v.new_tensor(
                [sx, sy, sx, sy])
        det_boxes, det_scores, det_labels, det_valid = multiclass_nms(
            (sum_boxes / nviews).reshape(b, n, -1), sum_scores / nviews,
            rcnn.get("score_thr", 0.05),
            dict(rcnn.get("nms", dict(type="nms", iou_threshold=0.5))),
            rcnn.get("max_per_img", 100), valid=prop_valid)
        out = {"det_bboxes": det_boxes / scale_factor[:, None, None],
               "det_scores": det_scores, "det_labels": det_labels,
               "det_valid": det_valid}

        # (3) every view's masks and extra outputs, averaged
        mask_sum = 0.0
        extras = {}
        for feats, shape_v, (sy, sx), direction, (ph, pw) in views:
            det_v = det_boxes * det_boxes.new_tensor([sx, sy, sx, sy])
            if direction is not None:
                det_v = bbox_flip(det_v, (ph, pw), direction)
            horizontal = direction == "horizontal"
            if self.with_mask:
                rois, roi_valid = boxes_to_rois(det_v, det_valid)
                logits = self.roi_head["mask_head"](self._roi_align_cfg(
                    self.mask_extractor_cfg, feats, rois, roi_valid))
                probs = torch.sigmoid(logits[:, 0]).reshape(
                    b, -1, *logits.shape[2:])
                if direction is not None:
                    probs = torch.flip(probs, [3 if horizontal else 2])
                mask_sum = mask_sum + probs
            sf_v = scale_factor * ((sx + sy) / 2.0)
            for key, val in self._extra_simple_test(
                    feats, det_v, det_valid, shape_v, sf_v).items():
                if direction is not None and key.endswith("offsets"):
                    val = val * val.new_tensor(
                        [-1.0, 1.0] if horizontal else [1.0, -1.0])
                elif direction is not None and "probs" in key:
                    continue        # spatial maps: the unflipped views only
                extras.setdefault(key, []).append(val)
        if self.with_mask:
            out["mask_probs"] = mask_sum / nviews
        for key, vals in extras.items():
            out[key] = sum(vals) / img.new_tensor(float(len(vals)))
        return out


class FasterRCNN(TwoStageDetector):
    """Faster R-CNN: the trunk without a mask head (reference
    ``mmdet/models/detectors/faster_rcnn.py``)."""


class MaskRCNN(TwoStageDetector):
    """Mask R-CNN: the trunk with its mask head (reference
    ``mmdet/models/detectors/mask_rcnn.py``)."""


class DynamicRCNN(TwoStageDetector):
    """Dynamic R-CNN (reference ``mmdet/models/detectors/dynamic_rcnn.py``
    and ``roi_heads/dynamic_roi_head.py``): a Faster R-CNN whose R-CNN IoU
    threshold and SmoothL1 beta follow the proposals' quality.  The step
    computes the statistics (``train_cfg.rcnn.dynamic_rcnn``); the host
    schedule in ``apis/train.py`` feeds the thresholds back."""


class RPN(TwoStageDetector):
    """The RPN-only detector (reference ``mmdet/models/detectors/rpn.py``;
    ``roi_head=None``): its proposals are its detections, scored by
    ``AR@N``.  Its RPN is the plain one (a ``GARPNHead`` raises A6)."""

    def _setup_ga_rpn(self, rh):
        raise NotImplementedError("the RPN-only detector with a GARPNHead "
                                  "is not ported to bonai_tpu_torch yet "
                                  "(ROADMAP.md item A6)")

    def aug_test(self, *args, **kwargs):
        """Refused: the JAX detector's ``aug_test`` needs a box head."""
        self._refuse_aug_test("the JAX detector's aug_test scores the "
                              "merged proposals with a box head, and the "
                              "RPN-only detector has none")

    def forward_train(self, batch, draw):
        """The RPN losses; ``draw`` is called once (the JAX detector hands
        ``rpn_loss`` its ``sampling`` key unsplit)."""
        feats = self.extract_feat(batch["image"])
        cls_scores, bbox_preds = self.rpn_head(
            [f.permute(0, 3, 1, 2) for f in feats])
        return rpn_loss(cls_scores, bbox_preds,
                        torch.cat(self._grid_anchors(feats)),
                        batch["gt_bboxes"], batch["gt_valid"], draw,
                        dict(self.train_cfg["rpn"]))

    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor):
        """The test proposals as detections: ``det_bboxes`` ``(B, P, 4)``
        in original-image pixels, their scores, labels 0, validity."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        props, scores, valid = self._rpn_and_proposals(
            feats, img_shape, dict(self.test_cfg.get("rpn", {})))
        return {"det_bboxes": props / scale_factor.float()[:, None, None],
                "det_scores": scores,
                "det_labels": torch.zeros(scores.shape, dtype=torch.int32,
                                          device=scores.device),
                "det_valid": valid}


class FastRCNN(TwoStageDetector):
    """Fast R-CNN (reference ``mmdet/models/detectors/fast_rcnn.py``): the
    second stage on proposals that come with the batch (``proposals``
    ``(B, N, 4)`` in the resized image, ``proposals_valid`` ``(B, N)``).
    It has no RPN head, whatever its config says (the JAX detector builds
    one from the BONAI config's base and never runs it)."""

    has_rpn = False

    def aug_test(self, *args, **kwargs):
        """Refused: the JAX detector's ``aug_test`` needs an RPN."""
        self._refuse_aug_test("the JAX detector's aug_test merges the "
                              "RPN's proposals, and Fast R-CNN has no RPN")

    def forward_train(self, batch, draw):
        """The R-CNN losses on the batch's proposals; ``draw`` is called for
        the R-CNN only (the JAX detector's ``sampling`` key, unsplit)."""
        feats = self.extract_feat(batch["image"])
        proposals = batch["proposals"].float()
        valid = batch.get("proposals_valid")
        if valid is None:
            valid = torch.ones(proposals.shape[:2], dtype=torch.bool,
                               device=proposals.device)
        return self._roi_forward_train(feats, proposals, valid, batch, draw)

    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor, proposals,
                    proposals_valid=None):
        """:meth:`TwoStageDetector.simple_test` on the given proposals."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        proposals = proposals.float()
        if proposals_valid is None:
            proposals_valid = torch.ones(proposals.shape[:2],
                                         dtype=torch.bool,
                                         device=proposals.device)
        return self._rcnn_simple_test(feats, proposals, proposals_valid,
                                      img_shape, scale_factor)
