"""LOFT: the two-stage trunk plus the roof->footprint offset branch, with
feature-orientation augmentation (``OffsetHeadExpandFeature``) or the plain
``OffsetHead`` (counterpart of ``bonai_tpu/models/detectors/loft.py`` on the
rectangle-offset paths: ``_offset_loss``, ``_extra_forward_train`` and
``_extra_simple_test``)."""

from __future__ import annotations

from ...core.boxes import delta2offset, offset2delta
from ..losses import smooth_l1_loss
from ..roi_heads.offset_heads import (OffsetHead, OffsetHeadExpandFeature,
                                      foa_offset_fusion, foa_offset_targets)
from .two_stage import (TwoStageDetector, _gather_rows, _require_type,
                        boxes_to_rois)

_UNPORTED_ROI_KEYS = ("height_head", "offset_height_head", "angle_head",
                      "side_face_head", "offset_field_head",
                      "offset_reweight")


class LOFT(TwoStageDetector):

    def _setup_roi_head(self, cfg):
        super()._setup_roi_head(cfg)
        unported = [k for k in _UNPORTED_ROI_KEYS if cfg.get(k)]
        if unported:
            raise NotImplementedError(
                f"LOFT attribute heads {unported} are not ported to "
                f"bonai_tpu_torch yet (ROADMAP.md item A5)")
        oh = dict(cfg["offset_head"])
        self.foa = oh.get("type", "OffsetHeadExpandFeature") != "OffsetHead"
        if self.foa:
            _require_type(oh, "OffsetHeadExpandFeature", "A5")
        elif (oh.get("offset_coordinate", "rectangle") != "rectangle"
              or oh.get("reg_num", 2) != 2):
            raise NotImplementedError(
                "polar offsets (OffsetHead with offset_coordinate='polar', "
                "DeltaPolarOffsetCoder) are not ported to bonai_tpu_torch "
                "yet (ROADMAP.md item A5)")
        self.offset_loss = dict(oh.get("loss_offset", {}))
        coder = dict(oh.get("offset_coder", {}))
        _require_type(coder, "DeltaXYOffsetCoder", "A5")
        self.offset_coder_means = tuple(coder.get("target_means", (0., 0.)))
        self.offset_coder_stds = tuple(coder.get("target_stds", (.5, .5)))
        common = dict(roi_feat_size=oh.get("roi_feat_size", 7),
                      in_channels=oh.get("in_channels", 256),
                      num_convs=oh.get("num_convs", 4),
                      num_fcs=oh.get("num_fcs", 2),
                      reg_num=oh.get("reg_num", 2),
                      conv_out_channels=oh.get("conv_out_channels", 256),
                      fc_out_channels=oh.get("fc_out_channels", 1024))
        self.roi_head["offset_head"] = OffsetHeadExpandFeature(
            expand_feature_num=oh.get("expand_feature_num", 4),
            share_expand_fc=oh.get("share_expand_fc", False),
            rotations=tuple(oh.get("rotations", (0, 90, 180, 270))),
            offset_coordinate=oh.get("offset_coordinate", "rectangle"),
            **common) if self.foa else OffsetHead(**common)
        self.offset_extractor_cfg = self._extractor(
            cfg["offset_roi_extractor"])

    def _offset_loss(self, pred, target, weight):
        _require_type(self.offset_loss, "SmoothL1Loss", "A5")
        return self.offset_loss.get("loss_weight", 1.0) * smooth_l1_loss(
            pred, target, self.offset_loss.get("beta", 1.0), weight)

    def _extra_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                             pos_gt, draw):
        """Offset loss of the positive RoIs, padded rows weighted 0: every
        FOA branch against the GT offset turned by its angle, or the plain
        head against the encoded GT offset."""
        rois, roi_valid = boxes_to_rois(pos_boxes, pos_is_pos)
        head = self.roi_head["offset_head"]
        pred = head(self._roi_align_cfg(self.offset_extractor_cfg, feats,
                                        rois, roi_valid))  # (E, BP, 2)|(BP, 2)
        matched = _gather_rows(batch["gt_offsets"], pos_gt)
        if self.foa:
            targets = foa_offset_targets(
                rois[:, 1:5], matched, head.rotations,
                self.offset_coder_means, self.offset_coder_stds)
            w = roi_valid.float()[None, :, None].expand_as(targets)
        else:
            targets = offset2delta(rois[:, 1:5], matched,
                                   self.offset_coder_means,
                                   self.offset_coder_stds)
            w = roi_valid.float()[:, None].expand_as(targets)
        return {"loss_offset": self._offset_loss(pred, targets, w)}

    def _extra_simple_test(self, feats, det_boxes, det_valid, img_shape,
                           scale_factor):
        """Offsets of the detections, decoded against their boxes
        (bounded by ``img_shape``) and mapped back to original-image
        pixels (divided by ``scale_factor``)."""
        b, p = det_boxes.shape[:2]
        rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
        head = self.roi_head["offset_head"]
        pred = head(self._roi_align_cfg(self.offset_extractor_cfg, feats,
                                        rois, roi_valid))
        fused = foa_offset_fusion(pred, head.rotations) if self.foa else pred
        hs = img_shape[:, 0].float().repeat_interleave(p)
        ws = img_shape[:, 1].float().repeat_interleave(p)
        offsets = delta2offset(rois[:, 1:5], fused, self.offset_coder_means,
                               self.offset_coder_stds, max_shape=(hs, ws))
        return {"offsets": offsets.reshape(b, p, 2)
                / scale_factor.float()[:, None, None]}
