"""LOFT: the two-stage trunk plus the roof->footprint offset branch, with
feature-orientation augmentation (``OffsetHeadExpandFeature``) or the plain
``OffsetHead`` (rectangular or polar offsets), and the attribute heads:
building height, joint offset and height, the image's off-nadir angle,
side faces and dense offset fields, with the offset features reweighted by
the roof and side-face logits (counterpart of
``bonai_tpu/models/detectors/loft.py``).

Every attribute RoI feature goes through ``_roi_align_cfg`` (the RoIAlign
kernels under ``'block'`` and ``'pallas'``); the dense GT maps are cropped
per RoI by the plain single-level ``roi_align`` at ``spatial_scale=1``.
"""

from __future__ import annotations

import torch

from ...core.boxes import (BBOX_CODERS, build_bbox_coder, delta2offset,
                           offset2delta)
from ...core.masks import mask_targets_from_instance_masks
from ...ops.roi_align import roi_align
from ..losses import binary_cross_entropy, mse_loss, smooth_l1_loss
from ..roi_heads.attribute_heads import (AngleHead, HeightHead,
                                         OffsetFieldHead, OffsetHeightHead,
                                         SideFaceHead, delta2height,
                                         height2delta,
                                         offset_field_to_offsets,
                                         reweight_roi_feats)
from ..roi_heads.offset_heads import (OffsetHead, OffsetHeadExpandFeature,
                                      foa_offset_fusion, foa_offset_targets)
from .two_stage import TwoStageDetector, _gather_rows, boxes_to_rois


def _head_cfg(cfg, key):
    """A head's config, or ``None`` where it is absent or empty (as the
    JAX detector reads it)."""
    c = cfg.get(key)
    return dict(c) if c else None


class LOFT(TwoStageDetector):

    def _setup_roi_head(self, cfg):
        super()._setup_roi_head(cfg)
        oh = dict(cfg["offset_head"])
        # the JAX detector reads any other type as the plain head and
        # ignores the coder's type; a type neither package defines is
        # refused here (ROADMAP.md queue C)
        oh_type = oh.get("type", "OffsetHeadExpandFeature")
        if oh_type not in ("OffsetHead", "OffsetHeadExpandFeature"):
            raise ValueError(f"offset head type {oh_type!r}: neither "
                             f"package defines it (OffsetHead, "
                             f"OffsetHeadExpandFeature)")
        self.foa = oh_type == "OffsetHeadExpandFeature"
        self.offset_coordinate = oh.get("offset_coordinate", "rectangle")
        if self.foa and self.offset_coordinate == "polar":
            raise ValueError(
                "polar offsets pair with the plain OffsetHead (reference)")
        self.offset_loss = dict(oh.get("loss_offset", {}))
        coder = dict(oh.get("offset_coder", {}))
        coder.setdefault("type", "DeltaXYOffsetCoder")
        if coder["type"] not in BBOX_CODERS:
            raise ValueError(f"offset coder type {coder['type']!r}: neither "
                             f"package defines it "
                             f"({', '.join(sorted(BBOX_CODERS.module_dict))})")
        self.offset_coder_means = tuple(coder.get("target_means", (0., 0.)))
        self.offset_coder_stds = tuple(coder.get("target_stds", (.5, .5)))
        # the polar branches use the polar coder whatever the config names
        # (the JAX detector's choice); the rectangle ones delta-xy
        self.polar_coder = build_bbox_coder(dict(
            type="DeltaPolarOffsetCoder", target_means=self.offset_coder_means,
            target_stds=self.offset_coder_stds))
        self.offset_reg_num = oh.get("reg_num", 2)
        common = dict(roi_feat_size=oh.get("roi_feat_size", 7),
                      in_channels=oh.get("in_channels", 256),
                      num_convs=oh.get("num_convs", 4),
                      num_fcs=oh.get("num_fcs", 2),
                      reg_num=self.offset_reg_num,
                      conv_out_channels=oh.get("conv_out_channels", 256),
                      fc_out_channels=oh.get("fc_out_channels", 1024))
        self.roi_head["offset_head"] = OffsetHeadExpandFeature(
            expand_feature_num=oh.get("expand_feature_num", 4),
            share_expand_fc=oh.get("share_expand_fc", False),
            rotations=tuple(oh.get("rotations", (0, 90, 180, 270))),
            offset_coordinate=self.offset_coordinate,
            **common) if self.foa else OffsetHead(**common)
        self.offset_extractor_cfg = self._extractor(
            cfg["offset_roi_extractor"])
        self._setup_attribute_heads(cfg)

    def _setup_attribute_heads(self, cfg):
        """The attribute heads the config has, their loss weights, the
        height coder and the side-face and offset-field extractors (each
        the config's own, else the mask extractor, else the offset
        one).  The heads' input widths are the RoI features' (the offset
        extractor's ``out_channels``; the JAX modules infer them)."""
        self.offset_reweight = bool(cfg.get("offset_reweight", False))
        ext = self.offset_extractor_cfg
        width = ext.get("out_channels", 256)
        trunk_in = dict(in_channels=width, roi_feat_size=dict(
            ext.get("roi_layer", {})).get("output_size", 7))

        def trunk(c):
            return dict(num_convs=c.get("num_convs", 4),
                        num_fcs=c.get("num_fcs", 2),
                        conv_out_channels=c.get("conv_out_channels", 256),
                        fc_out_channels=c.get("fc_out_channels", 1024),
                        **trunk_in)

        def dense_extractor(key):
            return self._extractor(cfg.get(key, cfg.get(
                "mask_roi_extractor", cfg["offset_roi_extractor"])))

        hh = _head_cfg(cfg, "height_head")
        if hh:
            self.roi_head["height_head"] = HeightHead(**trunk(hh))
        self.height_loss_weight = (hh or {}).get("loss_weight", 1.0)
        hc = (hh or {}).get("height_coder", {})
        self.height_coder = (tuple(hc.get("target_means", (0.0,))),
                             tuple(hc.get("target_stds", (4.0,))))
        ohh = _head_cfg(cfg, "offset_height_head")
        if ohh:
            self.roi_head["offset_height_head"] = OffsetHeightHead(
                reg_num=ohh.get("reg_num", 2), **trunk(ohh))
        ah = _head_cfg(cfg, "angle_head")
        if ah:
            self.roi_head["angle_head"] = AngleHead(
                width, ah.get("conv_out_channels", 256),
                ah.get("num_convs", 2))
        self.angle_loss_weight = (ah or {}).get("loss_weight", 1.0)
        for key, cls in (("side_face", SideFaceHead),
                         ("offset_field", OffsetFieldHead)):
            c = _head_cfg(cfg, f"{key}_head")
            extractor = dense_extractor(f"{key}_roi_extractor")
            setattr(self, f"{key}_extractor_cfg", extractor)
            setattr(self, f"{key}_loss_weight",
                    (c or {}).get("loss_weight", 1.0))
            if c:
                self.roi_head[f"{key}_head"] = cls(
                    extractor.get("out_channels", 256),
                    c.get("num_convs", 4), c.get("conv_out_channels", 256))

    def _dummy_extra_heads(self, feats, rois):
        """The offset head, and the attribute heads the config has, on the
        dummy RoIs (no reweighting), as the JAX LOFT's."""
        f = self._roi_align_cfg(self.offset_extractor_cfg, feats, rois, None)
        outs = [self.roi_head["offset_head"](f)]
        if "height_head" in self.roi_head:
            outs.append(self.roi_head["height_head"](f))
        if "offset_height_head" in self.roi_head:
            outs.extend(self.roi_head["offset_height_head"](f))
        if "angle_head" in self.roi_head:
            outs.append(self.roi_head["angle_head"](feats))
        for key in ("side_face", "offset_field"):
            if f"{key}_head" in self.roi_head:
                outs.append(self.roi_head[f"{key}_head"](self._roi_align_cfg(
                    getattr(self, f"{key}_extractor_cfg"), feats, rois,
                    None)))
        return outs

    def _head(self, name):
        return self.roi_head[name] if name in self.roi_head else None

    @property
    def reweights(self):
        """Whether the offset features are reweighted (the config's
        ``offset_reweight`` with a mask and a side-face head)."""
        return (self.offset_reweight and self.with_mask
                and "side_face_head" in self.roi_head)

    def _offset_loss(self, pred, target, weight):
        """The configured SmoothL1 loss, else MSE (as the JAX detector
        reads any other type)."""
        w = self.offset_loss.get("loss_weight", 1.0)
        if self.offset_loss.get("type", "SmoothL1Loss") == "SmoothL1Loss":
            return w * smooth_l1_loss(pred, target,
                                      self.offset_loss.get("beta", 1.0),
                                      weight)
        return w * mse_loss(pred, target, weight)

    @staticmethod
    def _crop_dense_map(dense, rois, out_size):
        """Each RoI's ``out_size``^2 crop of an image-resolution map
        ``(B, H, W)`` or ``(B, H, W, C)``: the plain single-level RoIAlign
        at ``spatial_scale=1``, in float32."""
        if dense.dim() == 3:
            dense = dense[..., None]
        return roi_align(dense.float(), rois, out_size, spatial_scale=1.0)

    def _mask_logits(self, feats, rois, roi_valid):
        """The mask head's first-class logits ``(N, 1, 2S, 2S)``."""
        mf = self._roi_align_cfg(self.mask_extractor_cfg, feats, rois,
                                 roi_valid)
        return self.roi_head["mask_head"](mf)[:, :1]

    def _side_face_logits(self, feats, rois, roi_valid):
        sf = self._roi_align_cfg(self.side_face_extractor_cfg, feats, rois,
                                 roi_valid)
        return self.roi_head["side_face_head"](sf)

    def _offset_feats(self, feats, rois, roi_valid):
        """The offset RoI features, reweighted by ``(sigmoid(side_face +
        mask) + 1) / 2`` where :attr:`reweights`."""
        ofeats = self._roi_align_cfg(self.offset_extractor_cfg, feats, rois,
                                     roi_valid)
        if not self.reweights:
            return ofeats
        return reweight_roi_feats(
            ofeats, self._mask_logits(feats, rois, roi_valid),
            self._side_face_logits(feats, rois, roi_valid))

    def _image_level_train(self, feats, batch):
        """The angle head's SmoothL1 loss on the batch's ``gt_angle``; its
        prediction gates ``SemiRPNHead``."""
        head = self._head("angle_head")
        if head is None or "gt_angle" not in batch:
            return {}, {}
        pred = head(feats)
        gt = batch["gt_angle"].float().reshape(-1, 1)
        loss = smooth_l1_loss(pred, gt, 1.0, torch.ones_like(gt))
        return ({"loss_angle": self.angle_loss_weight * loss},
                {"angle_pred": pred})

    def _extra_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                             pos_gt, draw):
        """Offset loss of the positive RoIs, padded rows weighted 0: every
        FOA branch against the GT offset turned by its angle, or the plain
        head against the encoded GT offset (polar: ``(length, angle)``, or
        ``(length, cos, sin)`` of it with ``reg_num=3``); then the
        attribute heads' losses."""
        rois, roi_valid = boxes_to_rois(pos_boxes, pos_is_pos)
        head = self.roi_head["offset_head"]
        ofeats = self._offset_feats(feats, rois, roi_valid)
        pred = head(ofeats)                         # (E, BP, 2) | (BP, r)
        matched = _gather_rows(batch["gt_offsets"], pos_gt)
        boxes = rois[:, 1:5]
        if self.foa:
            targets = foa_offset_targets(
                boxes, matched, head.rotations, self.offset_coder_means,
                self.offset_coder_stds)
            w = roi_valid.float()[None, :, None].expand_as(targets)
        else:
            if self.offset_coordinate == "polar":
                targets = self.polar_coder.encode(boxes, matched)
                if self.offset_reg_num == 3:
                    targets = torch.stack([targets[:, 0],
                                           torch.cos(targets[:, 1]),
                                           torch.sin(targets[:, 1])], -1)
            else:
                targets = offset2delta(boxes, matched,
                                       self.offset_coder_means,
                                       self.offset_coder_stds)
            w = roi_valid.float()[:, None].expand_as(targets)
        losses = {"loss_offset": self._offset_loss(pred, targets, w)}
        losses.update(self._attribute_forward_train(
            feats, batch, pos_gt, rois, roi_valid, ofeats, matched))
        return losses

    def _attribute_forward_train(self, feats, batch, pos_gt, rois, roi_valid,
                                 ofeats, matched_off):
        """The attribute heads' losses on the positive RoIs: heights
        (SmoothL1 on the encoded height), the joint offset and height, the
        side faces (sigmoid cross-entropy against the cropped map,
        binarised at 0.5) and the offset field (SmoothL1 against the
        cropped field on the roof pixels, the RoI's instance mask)."""
        losses = {}
        wv = roi_valid.float()
        boxes = rois[:, 1:5]
        h_target = None
        if "gt_building_heights" in batch:
            h_target = height2delta(_gather_rows(
                batch["gt_building_heights"].float(), pos_gt)[:, None],
                *self.height_coder)
        head = self._head("height_head")
        if head is not None and h_target is not None:
            losses["loss_height"] = self.height_loss_weight * smooth_l1_loss(
                head(ofeats), h_target, 1.0, wv[:, None])
        head = self._head("offset_height_head")
        if head is not None and h_target is not None:
            off_pred, h_pred = head(ofeats)
            off_t = offset2delta(boxes, matched_off, self.offset_coder_means,
                                 self.offset_coder_stds)
            losses["loss_offset_height"] = self._offset_loss(
                off_pred, off_t, wv[:, None].expand_as(off_t)) \
                + self.height_loss_weight * smooth_l1_loss(
                    h_pred, h_target, 1.0, wv[:, None])
        if "side_face_head" in self.roi_head \
                and "gt_side_face_maps" in batch:
            logits = self._side_face_logits(feats, rois, roi_valid)[:, 0]
            s = logits.shape[1]
            tgt = (self._crop_dense_map(batch["gt_side_face_maps"], rois, s)
                   [..., 0] > 0.5).float()
            losses["loss_side_face"] = self.side_face_loss_weight \
                * binary_cross_entropy(
                    logits, tgt, wv[:, None, None].expand_as(logits),
                    avg_factor=(wv.sum() * s * s).clamp(min=1.0))
        if "offset_field_head" in self.roi_head \
                and "gt_offset_field" in batch:
            ffeats = self._roi_align_cfg(self.offset_field_extractor_cfg,
                                         feats, rois, roi_valid)
            field = self.roi_head["offset_field_head"](ffeats)
            s = field.shape[1]
            tgt = self._crop_dense_map(batch["gt_offset_field"], rois, s)
            roof = mask_targets_from_instance_masks(
                boxes, _gather_rows(batch["gt_bboxes"], pos_gt),
                _gather_rows(batch["gt_masks"], pos_gt), s)
            w = (roof * wv[:, None, None])[..., None].expand_as(field)
            losses["loss_offset_field"] = self.offset_field_loss_weight \
                * smooth_l1_loss(field, tgt, 1.0, w)
        return losses

    def _extra_simple_test(self, feats, det_boxes, det_valid, img_shape,
                           scale_factor):
        """Offsets of the detections, decoded against their boxes and
        mapped back to original-image pixels: rectangular ones bounded by
        ``img_shape`` and divided by ``scale_factor``; polar ones with the
        angle of ``(cos, sin)`` under ``reg_num=3`` and only the length
        divided.  Then the attribute heads' outputs."""
        b, p = det_boxes.shape[:2]
        rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
        head = self.roi_head["offset_head"]
        ofeats = self._offset_feats(feats, rois, roi_valid)
        pred = head(ofeats)
        fused = foa_offset_fusion(pred, head.rotations) if self.foa else pred
        sf = scale_factor.float()
        if self.offset_coordinate == "polar":
            if self.offset_reg_num == 3:
                fused = torch.stack([fused[:, 0], torch.atan2(
                    fused[:, 2], fused[:, 1])], -1)
            off = self.polar_coder.decode(rois[:, 1:5], fused).reshape(
                b, p, 2)
            offsets = torch.stack([off[..., 0] / sf[:, None], off[..., 1]],
                                  -1)
        else:
            hs = img_shape[:, 0].float().repeat_interleave(p)
            ws = img_shape[:, 1].float().repeat_interleave(p)
            offsets = delta2offset(
                rois[:, 1:5], fused, self.offset_coder_means,
                self.offset_coder_stds, max_shape=(hs, ws)).reshape(
                    b, p, 2) / sf[:, None, None]
        out = {"offsets": offsets}
        out.update(self._attribute_simple_test(feats, rois, roi_valid,
                                               ofeats, b, p))
        return out

    def _attribute_simple_test(self, feats, rois, roi_valid, ofeats, b, p):
        """The attribute heads' outputs under the JAX detector's keys:
        ``heights`` ``(B, P)`` (metres, not rescaled),
        ``offset_height_offsets`` ``(B, P, 2)`` (decoded, in the resized
        image) and ``offset_height_heights``, ``angle`` ``(B,)`` radians,
        ``side_face_probs`` ``(B, P, 2S, 2S)`` and, with a mask head,
        ``offset_field_offsets`` ``(B, P, 2)``."""
        out = {}
        head = self._head("height_head")
        if head is not None:
            out["heights"] = delta2height(head(ofeats),
                                          *self.height_coder).reshape(b, p)
        head = self._head("offset_height_head")
        if head is not None:
            off_pred, h_pred = head(ofeats)
            out["offset_height_offsets"] = delta2offset(
                rois[:, 1:5], off_pred, self.offset_coder_means,
                self.offset_coder_stds).reshape(b, p, 2)
            out["offset_height_heights"] = delta2height(
                h_pred, *self.height_coder).reshape(b, p)
        head = self._head("angle_head")
        if head is not None:
            out["angle"] = head(feats)[:, 0]
        if "side_face_head" in self.roi_head:
            logits = self._side_face_logits(feats, rois, roi_valid)[:, 0]
            out["side_face_probs"] = torch.sigmoid(logits).reshape(
                b, p, *logits.shape[1:])
        if "offset_field_head" in self.roi_head and self.with_mask:
            ffeats = self._roi_align_cfg(self.offset_field_extractor_cfg,
                                         feats, rois, roi_valid)
            out["offset_field_offsets"] = offset_field_to_offsets(
                self.roi_head["offset_field_head"](ffeats),
                self._mask_logits(feats, rois, roi_valid)).reshape(b, p, 2)
        return out
