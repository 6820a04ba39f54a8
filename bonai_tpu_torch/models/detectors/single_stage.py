"""The dense single-stage detectors: RetinaNet (with GHM-C/GHM-R losses or
PISA; NAS-FPN's is a RetinaNet on a ``NASFPN`` neck), FreeAnchor, ATSS,
GFL, FCOS (with ``dcn_on_last_conv``), NAS-FCOS, FSAF, FoveaBox,
RepPoints, SSD and CornerNet (counterparts of the classes of
``bonai_tpu/models/detectors/single_stage.py``).

Each is a backbone, a neck (none for SSD and CornerNet, whose backbones
feed the head) and one dense head over the levels, with the port's
detector contract: ``forward_train(batch, draw)`` (the batch contract of
the two-stage detectors; none of these samples, so ``draw`` is never
called), ``simple_test(img, img_shape, scale_factor)`` with the same
padded output dict, and mmdet v2.3 keys (``backbone``, ``neck``,
``bbox_head``).  The options the JAX detectors read are ported; others
raise, naming the ROADMAP.md item that ports them: Guided Anchoring's
``GARetinaHead``, ``RetinaSepBNHead``, ``LegacyAnchorGenerator``, other
losses, and FoveaBox's ``with_deform``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.anchors import AnchorGenerator, SSDAnchorGenerator
from ...core.nms import soft_nms
from ..dense_heads.atss_head import ATSSHead, atss_bboxes, atss_loss
from ..dense_heads.corner_head import (CornerHead, corner_targets,
                                       decode_corners)
from ..dense_heads.fcos_head import (INF, FCOSHead, fcos_bboxes, fcos_loss,
                                     fcos_points)
from ..dense_heads.fovea_head import FoveaHead, fovea_bboxes, fovea_loss
from ..dense_heads.free_anchor_head import free_anchor_loss
from ..dense_heads.fsaf_head import FSAFHead, fsaf_bboxes, fsaf_loss
from ..dense_heads.gfl_head import GFLHead, gfl_bboxes, gfl_loss
from ..dense_heads.reppoints_head import (RepPointsHead, reppoints_bboxes,
                                          reppoints_loss)
from ..dense_heads.nasfcos_head import NASFCOSHead
from ..dense_heads.retina_head import RetinaHead, retina_bboxes, retina_loss
from ..dense_heads.ssd_head import SSDHead, ssd_bboxes, ssd_loss
from ..losses import (associative_embedding_loss, gaussian_focal_loss,
                      smooth_l1_loss)
from ..necks.nasfcos_fpn import NASFCOS_FPN
from .two_stage import _build_backbone, _build_neck, _kwargs


def _unported(what):
    return NotImplementedError(f"{what} is not ported to bonai_tpu_torch "
                               f"yet (ROADMAP.md item A6)")


def _anchor_generator(bh, default):
    """The head's ``AnchorGenerator`` (``default`` when the config gives
    none); ``LegacyAnchorGenerator`` raises A6."""
    ag = dict(bh.get("anchor_generator", default))
    atype = ag.pop("type", "AnchorGenerator")
    if atype != "AnchorGenerator":
        raise _unported(atype)
    return AnchorGenerator(**ag)


RETINA_ANCHORS = dict(octave_base_scale=4, scales_per_octave=3,
                      ratios=[0.5, 1.0, 2.0], strides=[8, 16, 32, 64, 128])
ATSS_ANCHORS = dict(ratios=[1.0], octave_base_scale=8, scales_per_octave=1,
                    strides=[8, 16, 32, 64, 128])


class SingleStageDetector(nn.Module):
    """A backbone, a neck (or none) and a dense head; subclasses set up the
    head and its loss and decode, and may build their own backbone and
    neck."""

    takes_proposals = False

    def __init__(self, backbone, neck, bbox_head, train_cfg=None,
                 test_cfg=None):
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.backbone = self._build_backbone(backbone)
        self.neck = self._build_neck(neck)
        nk = dict((neck[0] if isinstance(neck, (list, tuple)) else neck)
                  or {})
        self.num_levels = nk.get("num_outs", 5)
        self._geometry = {}
        bh = dict(bbox_head)
        self.num_classes = bh.get("num_classes", 80)
        lc = dict(bh.get("loss_cls", {}))
        self.focal_gamma = lc.get("gamma", 2.0)
        self.focal_alpha = lc.get("alpha", 0.25)
        self._setup_head(bh)

    def _setup_head(self, bh):
        raise NotImplementedError

    def _build_backbone(self, cfg):
        return _build_backbone(cfg)

    def _build_neck(self, cfg):
        return _build_neck(cfg)

    def init_weights(self, gen):
        """Seeded random weights from the ``torch.Generator`` ``gen``."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(gen)

    def extract_feat(self, img):
        """``(B, H, W, 3)`` image -> tuple of NCHW FPN levels (channels-last
        on the card; contiguous NCHW on the CPU, see
        ``TwoStageDetector.extract_feat``)."""
        x = img.permute(0, 3, 1, 2)
        if not x.is_cuda:
            x = x.contiguous()
        feats = self.backbone(x)
        return feats if self.neck is None else self.neck(feats)

    def _cached(self, feats, make):
        """``make(sizes)``'s numpy arrays (anchors or points, per level) on
        the levels' device, built once per feature-map size."""
        sizes = tuple((int(f.shape[2]), int(f.shape[3])) for f in feats)
        key = (sizes, feats[0].device)
        if key not in self._geometry:
            self._geometry[key] = [torch.from_numpy(a).to(feats[0].device)
                                   for a in make(sizes)]
        return self._geometry[key]

    def _anchors(self, feats):
        return self._cached(feats, self.anchor_generator.grid_anchors)

    def forward(self, batch, draw=None):
        """:meth:`forward_train`, for ``DistributedDataParallel``."""
        return self.forward_train(batch, draw)

    def forward_train(self, batch, draw=None):
        """The loss dict of one padded batch (the two-stage detectors'
        batch contract; ``gt_masks``/``gt_offsets`` are not read)."""
        feats = self.extract_feat(batch["image"])
        return self._loss(self.bbox_head(feats), feats, batch)

    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor):
        """Batched inference on ``(B, H, W, 3)`` normalised, padded images:
        ``det_bboxes`` ``(B, P, 4)`` in original-image pixels,
        ``det_scores``, ``det_labels``, ``det_valid``."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        boxes, scores, labels, valid = self._decode(
            self.bbox_head(feats), feats, img_shape)
        return {"det_bboxes": boxes / scale_factor.float()[:, None, None],
                "det_scores": scores, "det_labels": labels,
                "det_valid": valid}

    def aug_test(self, *args, **kwargs):
        """Refused: the JAX single-stage detectors have no ``aug_test``
        (detection-level test-time augmentation runs them,
        ``apis/test.py::make_tta_step``)."""
        raise ValueError(f"{type(self).__name__} has no proposal-level "
                         f"test-time augmentation: it has no proposals "
                         f"(the JAX single-stage detectors have no "
                         f"aug_test); use mode='det'")


class RetinaNet(SingleStageDetector):
    """RetinaNet: focal + L1 losses over all anchors, GHM-C/GHM-R losses
    in their place (``configs/ghm``), and PISA's ISR-P and CARL with
    ``train_cfg.isr``/``carl`` (``configs/pisa``)."""

    def _setup_head(self, bh):
        htype = bh.get("type", "RetinaHead")
        if htype != "RetinaHead":       # GARetinaHead, RetinaSepBNHead
            raise _unported(htype)
        self.anchor_generator = _anchor_generator(bh, RETINA_ANCHORS)
        self.bbox_head = RetinaHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            len(self.anchor_generator.base_anchors[0]))
        # the JAX detector computes L1 for an L1Loss or a SmoothL1Loss
        # config (ROADMAP.md queue C)
        lc = dict(bh.get("loss_cls", {}))
        lb = dict(bh.get("loss_bbox", {}))
        if lc.get("type", "FocalLoss") not in ("FocalLoss", "GHMC"):
            raise _unported(f"loss_cls {lc['type']}")
        if lb.get("type", "L1Loss") not in ("L1Loss", "SmoothL1Loss",
                                            "GHMR"):
            raise _unported(f"loss_bbox {lb['type']}")
        self.loss_cls_cfg = lc if lc.get("type") == "GHMC" else None
        self.loss_bbox_cfg = lb if lb.get("type") == "GHMR" else None

    def _loss(self, outs, feats, batch):
        pisa = {k: self.train_cfg[k] for k in ("isr", "carl")
                if self.train_cfg.get(k)} or None
        return retina_loss(*outs, torch.cat(self._anchors(feats)),
                           batch["gt_bboxes"], batch["gt_valid"],
                           batch["gt_labels"], self.num_classes,
                           self.train_cfg, gamma=self.focal_gamma,
                           alpha=self.focal_alpha,
                           loss_cls_cfg=self.loss_cls_cfg,
                           loss_bbox_cfg=self.loss_bbox_cfg, pisa_cfg=pisa)

    def _decode(self, outs, feats, img_shape):
        return retina_bboxes(*outs, self._anchors(feats), img_shape,
                             self.num_classes, self.test_cfg)


class FreeAnchor(SingleStageDetector):
    """FreeAnchor: RetinaNet's head and anchors with the learning-to-match
    loss."""

    def _setup_head(self, bh):
        self.anchor_generator = _anchor_generator(bh, RETINA_ANCHORS)
        self.bbox_head = RetinaHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            len(self.anchor_generator.base_anchors[0]))
        bc = dict(bh.get("bbox_coder", {}))
        lb = dict(bh.get("loss_bbox", {}))
        self.loss_kw = dict(
            target_means=tuple(bc.get("target_means", (0.,) * 4)),
            target_stds=tuple(bc.get("target_stds", (1.,) * 4)),
            pre_anchor_topk=bh.get("pre_anchor_topk", 50),
            bbox_thr=bh.get("bbox_thr", 0.6), gamma=bh.get("gamma", 2.0),
            alpha=bh.get("alpha", 0.5), bbox_beta=lb.get("beta", 0.11),
            loss_bbox_weight=lb.get("loss_weight", 0.75))

    def _loss(self, outs, feats, batch):
        return free_anchor_loss(*outs, torch.cat(self._anchors(feats)),
                                batch["gt_bboxes"], batch["gt_valid"],
                                batch["gt_labels"], self.num_classes,
                                **self.loss_kw)

    def _decode(self, outs, feats, img_shape):
        cfg = dict(self.test_cfg)
        cfg.setdefault("bbox_std", self.loss_kw["target_stds"])
        return retina_bboxes(*outs, self._anchors(feats), img_shape,
                             self.num_classes, cfg)


class ATSS(SingleStageDetector):
    """ATSS: GN towers, deltas on one anchor a cell, centerness, adaptive
    sample selection."""

    def _setup_head(self, bh):
        self.anchor_generator = _anchor_generator(bh, ATSS_ANCHORS)
        self.bbox_head = ATSSHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            self.num_levels)
        bc = dict(bh.get("bbox_coder", {}))
        self.coder = (tuple(bc.get("target_means", (0.,) * 4)),
                      tuple(bc.get("target_stds", (0.1, 0.1, 0.2, 0.2))))
        self.topk = dict(self.train_cfg.get("assigner", {})).get("topk", 9)
        self.loss_bbox_weight = dict(bh.get("loss_bbox", {})).get(
            "loss_weight", 2.0)

    def _loss(self, outs, feats, batch):
        anchors = self._anchors(feats)
        return atss_loss(*outs, torch.cat(anchors),
                         [len(a) for a in anchors], batch["gt_bboxes"],
                         batch["gt_valid"], batch["gt_labels"],
                         self.num_classes, topk=self.topk,
                         target_means=self.coder[0],
                         target_stds=self.coder[1], gamma=self.focal_gamma,
                         alpha=self.focal_alpha,
                         loss_bbox_weight=self.loss_bbox_weight)

    def _decode(self, outs, feats, img_shape):
        return atss_bboxes(*outs, self._anchors(feats), img_shape,
                           self.num_classes, self.test_cfg, *self.coder)


class GFL(SingleStageDetector):
    """GFL: ATSS's towers and assignment, side distributions, QFL, GIoU
    and DFL."""

    def _setup_head(self, bh):
        self.anchor_generator = _anchor_generator(bh, ATSS_ANCHORS)
        self.strides = [s[0] for s in self.anchor_generator.strides]
        self.reg_max = bh.get("reg_max", 16)
        self.bbox_head = GFLHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            self.reg_max, self.num_levels)
        weight = {k: dict(bh.get(k, {})).get("loss_weight", w)
                  for k, w in (("loss_cls", 1.0), ("loss_bbox", 2.0),
                               ("loss_dfl", 0.25))}
        self.loss_kw = dict(
            reg_max=self.reg_max,
            topk=dict(self.train_cfg.get("assigner", {})).get("topk", 9),
            qfl_beta=dict(bh.get("loss_cls", {})).get("beta", 2.0),
            loss_cls_weight=weight["loss_cls"],
            loss_bbox_weight=weight["loss_bbox"],
            loss_dfl_weight=weight["loss_dfl"])

    def _loss(self, outs, feats, batch):
        anchors = self._anchors(feats)
        strides = torch.cat([torch.full((len(a),), float(s),
                                        device=a.device)
                             for a, s in zip(anchors, self.strides)])
        return gfl_loss(*outs, torch.cat(anchors), strides,
                        [len(a) for a in anchors], batch["gt_bboxes"],
                        batch["gt_valid"], batch["gt_labels"],
                        self.num_classes, **self.loss_kw)

    def _decode(self, outs, feats, img_shape):
        return gfl_bboxes(*outs, self._anchors(feats), self.strides,
                          img_shape, self.num_classes, self.test_cfg,
                          reg_max=self.reg_max)


class FCOS(SingleStageDetector):
    """FCOS: points instead of anchors, with its centre-sampling,
    ``norm_on_bbox``, ``centerness_on_reg`` and GIoU options."""

    def _setup_points(self, bh):
        """The points' strides, level ranges and centre sampling."""
        self.strides = tuple(bh.get("strides", (8, 16, 32, 64, 128)))
        self.regress_ranges = tuple(tuple(r) for r in bh.get(
            "regress_ranges", ((-1, 64), (64, 128), (128, 256), (256, 512),
                               (512, INF))))
        self.center_sample_radius = float(bh.get(
            "center_sample_radius", 1.5)) if bh.get("center_sampling",
                                                    False) else 0.0

    def _setup_head(self, bh):
        self._setup_points(bh)
        self.bbox_loss_mode = "giou" if dict(bh.get("loss_bbox", {})).get(
            "type") == "GIoULoss" else "iou"
        self.bbox_head = FCOSHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            self.num_levels, bh.get("centerness_on_reg", False),
            bool(bh.get("norm_on_bbox", False)), self.strides,
            use_gn="norm_cfg" not in bh or dict(
                bh.get("norm_cfg") or {}).get("type") == "GN",
            dcn_on_last_conv=bool(bh.get("dcn_on_last_conv", False)))

    def _points(self, feats):
        return self._cached(feats, lambda sizes: fcos_points(sizes,
                                                             self.strides))

    def _loss(self, outs, feats, batch):
        points = self._points(feats)
        ranges = torch.cat([torch.tensor(r, dtype=torch.float32,
                                         device=p.device).expand(len(p), 2)
                            for p, r in zip(points, self.regress_ranges)])
        strides = torch.cat([torch.full((len(p),), float(s),
                                        device=p.device)
                             for p, s in zip(points, self.strides)])
        return fcos_loss(*outs, torch.cat(points), ranges,
                         batch["gt_bboxes"], batch["gt_valid"],
                         batch["gt_labels"], self.num_classes,
                         gamma=self.focal_gamma, alpha=self.focal_alpha,
                         strides=strides,
                         center_sample_radius=self.center_sample_radius,
                         bbox_loss_mode=self.bbox_loss_mode)

    def _decode(self, outs, feats, img_shape):
        return fcos_bboxes(*outs, self._points(feats), img_shape,
                           self.num_classes, self.test_cfg)


class NASFCOS(FCOS):
    """NAS-FCOS: FCOS (IoU loss, no ``norm_on_bbox``, centre sampling as
    the config gives it) on the searched ``NASFCOS_FPN`` and the searched
    head towers, or FCOS's own towers for a ``bbox_head`` of type
    ``FCOSHead`` (the COCO ``nas_fcos_fcoshead`` configs)."""

    def _build_neck(self, cfg):
        return NASFCOS_FPN(**_kwargs(cfg, "neck", (
            "in_channels", "out_channels", "num_outs", "start_level"), "A6"))

    def _setup_head(self, bh):
        self.num_classes = bh.get("num_classes", 1)
        self._setup_points(bh)
        self.bbox_loss_mode = "iou"
        if bh.get("type") == "FCOSHead":
            self.bbox_head = FCOSHead(
                self.num_classes, bh.get("in_channels", 256),
                bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
                self.num_levels, bh.get("centerness_on_reg", False), False,
                self.strides)
        else:
            self.bbox_head = NASFCOSHead(
                self.num_classes, bh.get("in_channels", 256),
                bh.get("feat_channels", 256), self.num_levels,
                bh.get("centerness_on_reg", False))


class FSAF(SingleStageDetector):
    """FSAF: RetinaNet's towers at one anchor-free prediction a cell, the
    centre-region targets and the online level selection."""

    def _setup_head(self, bh):
        self.strides = tuple(bh.get("strides", (8, 16, 32, 64, 128)))
        self.bbox_head = FSAFHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4))
        self.pos_scale = dict(self.train_cfg.get("assigner", {})).get(
            "pos_scale", 0.2)

    def _loss(self, outs, feats, batch):
        return fsaf_loss(*outs, batch["gt_bboxes"], batch["gt_valid"],
                         batch["gt_labels"], self.num_classes, self.strides,
                         pos_scale=self.pos_scale, gamma=self.focal_gamma,
                         alpha=self.focal_alpha)

    def _decode(self, outs, feats, img_shape):
        return fsaf_bboxes(*outs, img_shape, self.num_classes, self.strides,
                           self.test_cfg)


class FoveaBox(SingleStageDetector):
    """FoveaBox: the fovea targets on each level's scale range, log
    distances from each cell's corner."""

    def _setup_head(self, bh):
        if bh.get("with_deform", False):
            raise _unported("FoveaBox with_deform=True (feature alignment)")
        self.strides = tuple(bh.get("strides", (8, 16, 32, 64, 128)))
        self.bbox_head = FoveaHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256), bh.get("stacked_convs", 4),
            use_gn=dict(bh.get("norm_cfg") or {}).get("type") == "GN")
        lb = dict(bh.get("loss_bbox", {}))
        self.loss_kw = dict(
            strides=self.strides,
            base_edge_list=tuple(bh.get("base_edge_list",
                                        (16, 32, 64, 128, 256))),
            scale_ranges=tuple(tuple(r) for r in bh.get(
                "scale_ranges", ((8, 32), (16, 64), (32, 128), (64, 256),
                                 (128, 512)))),
            sigma=bh.get("sigma", 0.4), bbox_beta=lb.get("beta", 0.11),
            loss_bbox_weight=lb.get("loss_weight", 1.0))

    def _loss(self, outs, feats, batch):
        return fovea_loss(*outs, batch["gt_bboxes"], batch["gt_valid"],
                          batch["gt_labels"], self.num_classes,
                          gamma=self.focal_gamma, alpha=self.focal_alpha,
                          **self.loss_kw)

    def _decode(self, outs, feats, img_shape):
        return fovea_bboxes(*outs, img_shape, self.num_classes,
                            self.test_cfg, self.strides,
                            self.loss_kw["base_edge_list"])


def point_centres(featmap_sizes, strides):
    """Per level ``(H*W, 2)`` float32 points ``(x, y) = (j, i) * stride``,
    row-major (mmdetection's ``PointGenerator``)."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        ys, xs = np.meshgrid(np.arange(h, dtype=np.float32) * s,
                             np.arange(w, dtype=np.float32) * s,
                             indexing="ij")
        out.append(np.stack([xs.ravel(), ys.ravel()], -1))
    return out


class RepPointsDetector(SingleStageDetector):
    """RepPoints: point sets refined through deformable convs, the point
    (or max-IoU) assigner for the init stage and max-IoU for the refine
    stage."""

    def _setup_head(self, bh):
        self.num_points = bh.get("num_points", 9)
        self.strides = tuple(bh.get("point_strides", (8, 16, 32, 64, 128)))
        self.transform_method = bh.get("transform_method", "moment")
        self.bbox_head = RepPointsHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("feat_channels", 256),
            bh.get("point_feat_channels", 256), bh.get("stacked_convs", 3),
            self.num_points, bh.get("gradient_mul", 0.1),
            self.transform_method, bool(bh.get("use_grid_points", False)),
            bool(bh.get("center_init", True)),
            bh.get("point_base_scale", 4))
        init = dict(dict(self.train_cfg.get("init", {})).get("assigner", {}))
        refine = dict(dict(self.train_cfg.get("refine", {})).get(
            "assigner", {}))
        self.loss_kw = dict(
            num_points=self.num_points,
            point_base_scale=bh.get("point_base_scale", 4),
            init_assigner="max_iou" if init.get("type") == "MaxIoUAssigner"
            else "point",
            init_assign_scale=init.get("scale", 4),
            init_pos_num=init.get("pos_num", 1),
            init_pos_iou=init.get("pos_iou_thr", 0.5),
            init_neg_iou=init.get("neg_iou_thr", 0.4),
            refine_pos_iou=refine.get("pos_iou_thr", 0.5),
            refine_neg_iou=refine.get("neg_iou_thr", 0.4),
            loss_init_weight=dict(bh.get("loss_bbox_init", {})).get(
                "loss_weight", 0.5),
            loss_refine_weight=dict(bh.get("loss_bbox_refine", {})).get(
                "loss_weight", 1.0),
            transform_method=self.transform_method)

    def _centres(self, feats):
        return self._cached(feats, lambda sizes: point_centres(
            sizes, self.strides))

    def _loss(self, outs, feats, batch):
        centres = self._centres(feats)
        dev = centres[0].device
        strides = torch.cat([torch.full((len(c),), float(s), device=dev)
                             for c, s in zip(centres, self.strides)])
        lvls = torch.cat([torch.full((len(c),), int(np.log2(s)),
                                     dtype=torch.int32, device=dev)
                          for c, s in zip(centres, self.strides)])
        return reppoints_loss(*outs, torch.cat(centres), strides, lvls,
                              batch["gt_bboxes"], batch["gt_valid"],
                              batch["gt_labels"], self.num_classes,
                              gamma=self.focal_gamma, alpha=self.focal_alpha,
                              **self.loss_kw)

    def _decode(self, outs, feats, img_shape):
        cls_scores, _, pts_refine, mt = outs
        return reppoints_bboxes(cls_scores, pts_refine, mt,
                                self._centres(feats), self.strides,
                                img_shape, self.num_classes, self.test_cfg,
                                self.num_points, self.transform_method)


SSD_ANCHORS = dict(strides=[8, 16, 32, 64, 100, 300],
                   ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
                   basesize_ratio_range=(0.15, 0.9), input_size=300)


class SSD(SingleStageDetector):
    """SSD300/512: the VGG trunk feeds the head (no neck), softmax
    classifiers with hard-negative mining, PISA with ``train_cfg.isr``/
    ``carl``.  The backbone's ``input_size``, ``depth`` and
    ``l2_norm_scale`` are read, its other keys and the neck ignored, as in
    the JAX detector (so is the assigner's ``gt_max_assign_all``).  The
    anchors keep the 300^2 (or 512^2) input's strides at any test size:
    at 1024^2 the last two levels' 14^2 and 12^2 cells sit 100 and 300 px
    apart, reaching past the image, and their boxes are clipped to it
    (ROADMAP.md queue C)."""

    def _build_backbone(self, cfg):
        from ..backbones.ssd_vgg import SSDVGG
        bk = dict(cfg or {})
        self.input_size = int(bk.get("input_size", 300))
        return SSDVGG(self.input_size, bk.get("depth", 16),
                      bk.get("l2_norm_scale", 20.0))

    def _build_neck(self, cfg):
        return None

    def _setup_head(self, bh):
        ag = dict(bh.get("anchor_generator", SSD_ANCHORS))
        legacy = ag.pop("type", "SSDAnchorGenerator") \
            == "LegacySSDAnchorGenerator"
        ag.setdefault("input_size", self.input_size)
        self.anchor_generator = SSDAnchorGenerator(legacy=legacy, **ag)
        self.num_levels = len(self.anchor_generator.strides)
        self.bbox_head = SSDHead(
            self.num_classes, tuple(bh.get(
                "in_channels", (512, 1024, 512, 256, 256, 256))),
            [len(a) for a in self.anchor_generator.base_anchors])
        bc = dict(bh.get("bbox_coder", {}))
        self.target_stds = tuple(bc.get("target_stds", (0.1, 0.1, 0.2, 0.2)))
        self.legacy_coder = bc.get("type") == "LegacyDeltaXYWHBBoxCoder"

    def _loss(self, outs, feats, batch):
        pisa = {k: self.train_cfg[k] for k in ("isr", "carl")
                if self.train_cfg.get(k)} or None
        return ssd_loss(*outs, torch.cat(self._anchors(feats)),
                        batch["gt_bboxes"], batch["gt_valid"],
                        batch["gt_labels"], self.num_classes, self.train_cfg,
                        target_stds=self.target_stds, pisa_cfg=pisa,
                        legacy=self.legacy_coder)

    def _decode(self, outs, feats, img_shape):
        return ssd_bboxes(*outs, self._anchors(feats), img_shape,
                          self.num_classes, self.test_cfg,
                          target_stds=self.target_stds,
                          legacy=self.legacy_coder)


class CornerNet(SingleStageDetector):
    """CornerNet: the stacked hourglass feeds the corner head (no neck).
    Training: each level's gaussian focal loss on both heatmaps (over the
    count of exact corners), smooth L1 offsets at the exact corners and
    the pull and push losses of the GTs' corner embeddings, averaged over
    the levels (``loss_offset``'s ``loss_weight`` is read and not applied,
    as in the JAX detector).  Test: the last level decoded into
    ``num_dets`` corner pairs, the gaussian soft-NMS
    (``core/nms.py::soft_nms``) and the top ``max_per_img``."""

    def _build_backbone(self, cfg):
        cfg = dict(cfg)
        cfg["type"] = "HourglassNet"
        return _build_backbone(cfg)

    def _build_neck(self, cfg):
        return None

    def _setup_head(self, bh):
        self.num_classes = bh.get("num_classes", 1)
        self.bbox_head = CornerHead(
            self.num_classes, bh.get("in_channels", 256),
            bh.get("num_feat_levels", 2), bh.get("corner_emb_channels", 1))
        lh = dict(bh.get("loss_heatmap") or {})
        le = dict(bh.get("loss_embedding") or {})
        lo = dict(bh.get("loss_offset") or {})
        self.loss_kw = dict(
            heat_alpha=lh.get("alpha", 2.0), heat_gamma=lh.get("gamma", 4.0),
            heat_weight=lh.get("loss_weight", 1.0),
            pull_weight=le.get("pull_weight", 0.25),
            push_weight=le.get("push_weight", 0.25),
            off_beta=lo.get("beta", 1.0))

    def _loss(self, outs, feats, batch):
        kw = self.loss_kw
        img = batch["image"]
        fh, fw = feats[-1].shape[2:]
        tgt = corner_targets(batch["gt_bboxes"], batch["gt_valid"], fh, fw,
                             img.shape[1], img.shape[2])
        bidx = torch.arange(img.shape[0], device=img.device)[:, None]
        det = off = pull = push = 0.0
        for out in outs:
            for side in ("tl", "br"):
                heat_t = tgt[f"{side}_heat"]
                pos = (heat_t == 1).float()
                det = det + kw["heat_weight"] * gaussian_focal_loss(
                    torch.sigmoid(out[f"{side}_heat"][:, 0].float()), heat_t,
                    kw["heat_alpha"], kw["heat_gamma"],
                    avg_factor=pos.sum().clamp(min=1.0)) / 2
                pred = out[f"{side}_off"].permute(0, 2, 3, 1)
                m = pos[..., None].expand_as(pred)
                off = off + smooth_l1_loss(
                    pred, tgt[f"{side}_off"], kw["off_beta"], m,
                    avg_factor=(pos.sum() * 2).clamp(min=1.0)) / 2
            if "tl_emb" in out:
                tp, bp = tgt["tl_pos"], tgt["br_pos"]
                te = out["tl_emb"][:, 0][bidx, tp[..., 0], tp[..., 1]]
                be = out["br_emb"][:, 0][bidx, bp[..., 0], bp[..., 1]]
                pl, ps = associative_embedding_loss(
                    te, be, batch["gt_valid"], kw["pull_weight"],
                    kw["push_weight"])
                pull = pull + pl.mean()
                push = push + ps.mean()
        n = len(outs)
        losses = {"loss_heatmap": det / n, "loss_offset": off / n}
        if "tl_emb" in outs[0]:
            losses.update(loss_pull=pull / n, loss_push=push / n)
        return losses

    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor):
        """As :meth:`SingleStageDetector.simple_test`; the head runs on the
        last level alone, the one decoded."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        out = self.bbox_head.level(feats[-1], self.bbox_head.num_feat_levels
                                   - 1)
        cfg = self.test_cfg
        max_per_img = cfg.get("max_per_img", 100)
        nms_cfg = dict(cfg.get("nms", dict(type="soft_nms", iou_threshold=0.5,
                                           method="gaussian")))
        boxes, scores = decode_corners(
            out, img.shape[1], img.shape[2], k=cfg.get("corner_topk", 100),
            distance_threshold=cfg.get("distance_threshold", 0.5),
            num_dets=cfg.get("num_dets", 1000))
        new_scores, rank = soft_nms(
            boxes, scores.clamp(min=0.0),
            iou_threshold=nms_cfg.get("iou_threshold", 0.5),
            sigma=nms_cfg.get("sigma", 0.5),
            method=nms_cfg.get("method", "gaussian"), max_out=max_per_img,
            valid=scores > 0)
        top_s, top_i = torch.sort(new_scores, dim=-1, descending=True,
                                  stable=True)
        top_s, top_i = top_s[:, :max_per_img], top_i[:, :max_per_img]
        det = boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
        return {"det_bboxes": det / scale_factor.float()[:, None, None],
                "det_scores": top_s,
                "det_labels": torch.zeros_like(top_i, dtype=torch.int32),
                "det_valid": (top_s > 0) & (rank.gather(1, top_i) >= 0)}
