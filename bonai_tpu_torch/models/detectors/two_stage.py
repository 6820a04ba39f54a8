"""Two-stage detector trunk: Faster R-CNN, Mask R-CNN, Dynamic R-CNN and
the base of LOFT and Cascade R-CNN (counterpart of
``bonai_tpu/models/detectors/two_stage.py``: ``boxes_to_rois``,
``assign_rcnn``, ``assign_and_sample_rcnn``, ``extract_feat``,
``_roi_align_cfg``, ``_rpn_and_proposals``, ``forward_train``,
``_roi_forward_train``, ``_mask_forward_train``, ``simple_test``,
``_rcnn_simple_test``, ``FasterRCNN``, ``MaskRCNN``, ``DynamicRCNN``).

Training is the random-sampling path of the JAX package, with its box
loss: L1 for an ``L1Loss`` or a ``SmoothL1Loss`` config (the JAX package
keeps both on its inline L1 path, ROADMAP.md queue C), SmoothL1 at the
batch's beta under Dynamic R-CNN.  The mask branch is optional
(``with_mask``).  PISA, hard mining and the other samplers and losses
raise, naming the ROADMAP.md item that ports them.

Public layouts are the JAX package's: images ``(B, H, W, 3)``, FPN levels
``(B, H, W, C)`` (NHWC views of channels-last NCHW maps, no copy), RoI
features ``(R, oh, ow, C)``, and detections as fixed-capacity padded
tensors with validity masks.  Submodule names are mmdet v2.3's
(``backbone``, ``neck``, ``rpn_head``, ``roi_head.bbox_head``, ...), so an
mmdet ``state_dict`` loads as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import max_iou_assign
from ...core.boxes import clip_boxes, delta2bbox
from ...core.masks import mask_targets_from_instance_masks
from ...core.nms import multiclass_nms
from ...core.samplers import random_sample
from ...ops.roi_align import multilevel_roi_align
from ...ops.roi_align_block import roi_align_block
from ...ops.roi_align_blocked import roi_align_blocked
from ...ops.roi_align_fused import roi_align_fused
from ...parallel import gather_cat
from ..backbones.hrnet import HRNet
from ..backbones.resnet import ResNet
from ..dense_heads.rpn_head import RPNHead, rpn_loss, rpn_proposals
from ..losses import (binary_cross_entropy, cross_entropy, l1_loss,
                      smooth_l1_loss)
from ..necks.fpn import FPN
from ..necks.hrfpn import HRFPN
from ..roi_heads.bbox_head import Shared2FCBBoxHead, bbox_targets
from ..roi_heads.mask_head import FCNMaskHead


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


def assign_and_sample_rcnn(draw, proposals, proposal_valid, gt_bboxes,
                           gt_valid, assigner_cfg, sampler_cfg,
                           dyn_iou_topk=None):
    """Assign and randomly sample the second-stage candidates of a batch.
    Returns the sampler's result (``(B, num)`` each) and the sampled boxes
    ``(B, num, 4)``.

    With ``dyn_iou_topk`` (Dynamic R-CNN) the result also holds
    ``stat_kth_iou`` ``(B,)``: each image's ``dyn_iou_topk``-th largest
    proposal IoU, the GTs' own matches excluded (the reference records it
    before the GTs join the candidates)."""
    stype = sampler_cfg.get("type", "RandomSampler")
    if stype != "RandomSampler":
        raise NotImplementedError(f"{stype} is not ported to bonai_tpu_torch "
                                  f"yet (ROADMAP.md item A7)")
    if not sampler_cfg.get("add_gt_as_proposals", True):
        raise NotImplementedError("add_gt_as_proposals=False is not ported "
                                  "to bonai_tpu_torch yet (ROADMAP.md item "
                                  "A7)")
    cand, _, assigned, max_ov = assign_rcnn(proposals, proposal_valid,
                                            gt_bboxes, gt_valid, assigner_cfg)
    u_pos, u_neg = draw(assigned.shape, assigned.device)
    res = random_sample(assigned, sampler_cfg.get("num", 512),
                        sampler_cfg.get("pos_fraction", 0.25), u_pos, u_neg,
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


def _build_backbone(cfg):
    """A ``ResNet`` or an ``HRNet``; other backbones raise A6."""
    if dict(cfg).get("type") == "HRNet":
        return HRNet(**_kwargs(cfg, "backbone", (
            "extra", "frozen_stages", "norm_eval"), "A6"))
    _require_type(cfg, "ResNet", "A6")
    return ResNet(**_kwargs(cfg, "backbone", (
        "depth", "num_stages", "out_indices", "frozen_stages", "norm_eval",
        "style", "base_channels"), "A6"))


def _build_neck(cfg):
    """An ``FPN`` or an ``HRFPN``.  A list of necks (Libra R-CNN's ``[FPN,
    BFP]``, which the JAX package chains) raises A7, other necks A6."""
    if isinstance(cfg, (list, tuple)):
        raise NotImplementedError(
            f"chained necks {[dict(c).get('type') for c in cfg]} are not "
            f"ported to bonai_tpu_torch yet (ROADMAP.md item A7)")
    if dict(cfg).get("type") == "HRFPN":
        return HRFPN(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs"), "A6"))
    _require_type(cfg, "FPN", "A6")
    return FPN(**_kwargs(cfg, "neck", (
        "in_channels", "out_channels", "num_outs", "start_level",
        "add_extra_convs"), "A6"))


def _refuse_roi_keys(cfg):
    """Mask Scoring's IoU head and the C4 shared head: a detector type the
    port builds (``MaskScoringRCNN`` builds as ``MaskRCNN``, a C4 config is
    a ``FasterRCNN``) could carry them, so they raise."""
    unported = [k for k in ("mask_iou_head", "shared_head")
                if cfg.get(k) is not None]
    if unported:
        raise NotImplementedError(
            f"roi_head parts {unported} are not ported to bonai_tpu_torch "
            f"yet (ROADMAP.md item A7)")


def _bbox_head(cfg, reg_class_agnostic=False):
    """A ``Shared2FCBBoxHead`` of config ``cfg`` (``reg_class_agnostic``:
    the default when the config does not say), and its coder's config.
    Its ``loss_bbox`` may be ``L1Loss`` or ``SmoothL1Loss``: the JAX
    package computes L1 for both (ROADMAP.md queue C)."""
    bh = dict(cfg)
    _require_type(bh, "Shared2FCBBoxHead", "A7")
    loss = dict(bh.get("loss_bbox") or {}).get("type", "L1Loss")
    if loss not in ("L1Loss", "SmoothL1Loss"):
        raise NotImplementedError(f"loss_bbox {loss} is not ported to "
                                  f"bonai_tpu_torch yet (ROADMAP.md item A7)")
    coder = dict(bh.get("bbox_coder", {}))
    _require_type(coder, "DeltaXYWHBBoxCoder", "A7")
    return Shared2FCBBoxHead(
        bh.get("num_classes", 1), bh.get("in_channels", 256),
        bh.get("fc_out_channels", 1024), bh.get("roi_feat_size", 7),
        bh.get("reg_class_agnostic", reg_class_agnostic)), coder


class TwoStageDetector(nn.Module):
    """FPN two-stage trunk: ResNet + FPN or HRNet + HRFPN, RPN, a box head
    and an optional mask head."""

    def __init__(self, backbone, neck, rpn_head, roi_head, train_cfg=None,
                 test_cfg=None, roi_align_impl=None):
        super().__init__()
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.roi_align_impl = roi_align_impl
        self.backbone = _build_backbone(backbone)
        self.neck = _build_neck(neck)
        rh = dict(rpn_head)
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
        self._anchors = {}
        self.roi_head = nn.ModuleDict()
        self._setup_roi_head(dict(roi_head))

    def _setup_roi_head(self, cfg):
        _refuse_roi_keys(cfg)
        self.roi_head["bbox_head"], self.bbox_coder = _bbox_head(
            cfg["bbox_head"])
        self.bbox_extractor_cfg = self._extractor(cfg["bbox_roi_extractor"])
        self._setup_mask_head(cfg)

    def _setup_mask_head(self, cfg):
        """The optional FCN mask head and its extractor (a Faster R-CNN
        config has neither)."""
        if cfg.get("mask_head") is None:
            return
        mh = dict(cfg["mask_head"])
        _require_type(mh, "FCNMaskHead", "A7")
        self.roi_head["mask_head"] = FCNMaskHead(
            mh.get("num_convs", 4), mh.get("in_channels", 256),
            mh.get("conv_out_channels", 256), mh.get("num_classes", 1))
        self.mask_extractor_cfg = self._extractor(cfg["mask_roi_extractor"])

    @property
    def with_mask(self):
        return "mask_head" in self.roi_head

    @staticmethod
    def _extractor(cfg):
        cfg = dict(cfg)
        _require_type(cfg, "SingleRoIExtractor", "A7")
        _require_type(cfg.get("roi_layer", {}), "RoIAlign", "A7")
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
        - ``'gather'`` (the default): ``multilevel_roi_align``."""
        layer = dict(extractor_cfg.get("roi_layer", {}))
        out_size = layer.get("output_size", 7)
        sr = layer.get("sampling_ratio", 0) or 2    # static grid
        strides = list(extractor_cfg.get("featmap_strides", [4, 8, 16, 32]))
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

    def _grid_anchors(self, feats):
        sizes = tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)
        key = (sizes, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(a).to(feats[0].device)
                for a in self.anchor_generator.grid_anchors(sizes)]
        return self._anchors[key]

    def _rpn_and_proposals(self, feats, img_shape, proposal_cfg):
        cls_scores, bbox_preds = self.rpn_head(
            [f.permute(0, 3, 1, 2) for f in feats])
        props, scores, valid = rpn_proposals(
            cls_scores, bbox_preds, self._grid_anchors(feats), img_shape,
            proposal_cfg)
        return props, scores, valid

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
        cls_scores, bbox_preds = self.rpn_head(
            [f.permute(0, 3, 1, 2) for f in feats])
        anchors = self._grid_anchors(feats)
        with torch.no_grad():       # proposals are constants of the step
            proposals, _, prop_valid = rpn_proposals(
                cls_scores, bbox_preds, anchors, batch["img_shape"],
                dict(self.train_cfg.get("rpn_proposal", {})))
        losses = rpn_loss(cls_scores, bbox_preds, torch.cat(anchors),
                          batch["gt_bboxes"], batch["gt_valid"], draw,
                          dict(self.train_cfg["rpn"]))
        losses.update(self._roi_forward_train(
            feats, proposals.detach(), prop_valid, batch, draw))
        return losses

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
        n_tot = st["labels"].shape[0]
        if head.fc_reg.out_features == 4:       # class-agnostic or one class
            pred4 = st["bbox_pred"][:, :4]
        else:
            pred4 = st["bbox_pred"].reshape(n_tot, nc, 4).gather(
                1, st["labels"].clamp(0, nc - 1)[:, None, None]
                .expand(-1, 1, 4))[:, 0]
        if dyn is None:
            loss_bbox = l1_loss(pred4, st["bbox_t"], st["bbox_w"],
                                avg_factor=float(n_tot))
        else:
            loss_bbox = smooth_l1_loss(
                pred4, st["bbox_t"],
                batch.get("dyn_beta", dyn.get("initial_beta", 1.0)),
                st["bbox_w"], avg_factor=float(n_tot))
        losses = {"loss_cls": st["loss_cls"], "loss_bbox": loss_bbox}
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
                                               pos_is_pos, pos_gt))
        losses.update(self._extra_forward_train(feats, batch, rcnn,
                                                pos_boxes, pos_is_pos,
                                                pos_gt))
        return losses

    def _bbox_stage(self, head, coder, feats, sampled, res, batch):
        """One box head on the sampled boxes ``(B, num, 4)`` of a batch:
        the targets of ``coder`` (flattened to ``B*num`` rows), the head's
        deltas, the classification loss and the RoIs."""
        nc = head.fc_cls.out_features - 1
        labels, label_w, bbox_t, bbox_w = bbox_targets(
            sampled, res, batch["gt_bboxes"], batch["gt_labels"], nc,
            tuple(coder.get("target_means", (0.,) * 4)),
            tuple(coder.get("target_stds", (1.,) * 4)))
        rois, roi_valid = boxes_to_rois(sampled, res["valid"])
        cls_score, bbox_pred = head(self._roi_align_cfg(
            self.bbox_extractor_cfg, feats, rois, roi_valid))
        labels, label_w = labels.reshape(-1), label_w.reshape(-1)
        return {"labels": labels, "bbox_t": bbox_t.reshape(-1, 4),
                "bbox_w": bbox_w.reshape(-1, 4), "bbox_pred": bbox_pred,
                "rois": rois,
                "loss_cls": cross_entropy(
                    cls_score, labels, label_w,
                    avg_factor=(label_w > 0).sum().float().clamp(min=1.0))}

    def _mask_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                            pos_gt):
        if not self.with_mask:
            return {}
        mask_size = rcnn.get("mask_size", 28)
        rois, roi_valid = boxes_to_rois(pos_boxes, pos_is_pos)
        logits = self.roi_head["mask_head"](self._roi_align_cfg(
            self.mask_extractor_cfg, feats, rois, roi_valid))[:, 0]
        targets = mask_targets_from_instance_masks(
            rois[:, 1:5], _gather_rows(batch["gt_bboxes"], pos_gt),
            _gather_rows(batch["gt_masks"], pos_gt), mask_size)
        w = roi_valid.float()[:, None, None]
        return {"loss_mask": binary_cross_entropy(
            logits, targets, w.expand_as(logits),
            avg_factor=(w.sum() * mask_size * mask_size).clamp(min=1.0))}

    def _extra_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                             pos_gt):
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
        cls_score, bbox_pred = self.roi_head["bbox_head"](self._roi_align_cfg(
            self.bbox_extractor_cfg, feats, rois, roi_valid))
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
        branches run on their scale-space boxes."""
        b = det_boxes.shape[0]
        sf = scale_factor.float()[:, None, None]
        out = {"det_bboxes": det_boxes / sf, "det_scores": det_scores,
               "det_labels": det_labels, "det_valid": det_valid}
        if self.with_mask:
            rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
            logits = self.roi_head["mask_head"](self._roi_align_cfg(
                self.mask_extractor_cfg, feats, rois, roi_valid))
            out["mask_probs"] = torch.sigmoid(logits[:, 0]).reshape(
                b, -1, *logits.shape[2:])
        out.update(self._extra_simple_test(feats, det_boxes, det_valid,
                                           img_shape, scale_factor))
        return out

    def _extra_simple_test(self, feats, det_boxes, det_valid, img_shape,
                           scale_factor):
        return {}


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
