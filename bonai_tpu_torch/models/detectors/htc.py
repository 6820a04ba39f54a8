"""Hybrid Task Cascade (counterpart of ``bonai_tpu/models/detectors/htc.py``;
reference ``mmdet/models/detectors/htc.py`` and
``roi_heads/htc_roi_head.py``): the Cascade R-CNN's box stages with a mask
head at every stage, whose features flow into the next stage's mask head
(``mask_info_flow``), each stage's mask branch sampling on the boxes that
stage's box head refined (``interleaved``), and a semantic head whose
embedding adds into the box and mask RoI features (``semantic_fusion``)
and, where the batch carries ``gt_semantic_seg``, trains on it.

The choices of the JAX package, kept here (ROADMAP.md queue C): the
semantic embedding is pooled by the plain single-level RoIAlign at the
RoI features' own size (mmdet pools 14^2 and resizes); the semantic loss
is a plain cross-entropy over every pixel; the mask heads take their
widths from the config whatever its ``type`` says.

Keys are mmdet's: ``roi_head.mask_head.<i>.{conv_res,convs.<j>,upsample,
conv_logits}``, ``roi_head.semantic_head.{lateral_convs.<i>,convs.<j>,
conv_embedding,conv_logits}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.masks import mask_targets_from_instance_masks
from ...ops.roi_align import roi_align
from ..losses import binary_cross_entropy, cross_entropy, l1_loss
from ..roi_heads.mask_head import (FusedSemanticHead, HTCMaskHead,
                                   resize_bilinear)
from .cascade_rcnn import CascadeRCNN
from .two_stage import _gather_rows, assign_and_sample_rcnn, boxes_to_rois

MASK_HEAD_TYPES = ("FCNMaskHead", "HTCMaskHead")


class HTC(CascadeRCNN):

    def aug_test(self, *args, **kwargs):
        """Refused: the JAX detector's ``aug_test`` does not run on HTC."""
        self._refuse_aug_test(
            "the JAX detector's aug_test reads the trunk's single mask head "
            "(mask_head/conv0), which HTC's per-stage heads replace")

    def forward_dummy(self, img):
        """The JAX HTC's ``__call__``: the RPN head's outputs, every stage's
        box head on the dummy RoIs' features (no semantic fusion), the
        semantic head's logits, and every stage's mask logits
        (:meth:`mask_stage`, fused with the semantic embedding)."""
        feats = self.extract_feat(img)
        outs = self.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
        rois = self._dummy_rois(img)
        bf = self._roi_align_cfg(self.bbox_extractor_cfg, feats, rois, None)
        extra = [h(bf) for h in self.roi_head["bbox_head"]]
        seg_logits, sem_feat = self.semantic(feats)
        if seg_logits is not None:
            extra.append(seg_logits)
        if self.with_mask:
            extra += [self.mask_stage(i, feats, rois, None, sem_feat)
                      for i in range(self.num_stages)]
        return outs, extra

    def _setup_mask_head(self, cfg, cascade=True):
        """One ``HTCMaskHead`` a stage (with ``mask_info_flow``, a
        ``conv_res`` on every stage but the first), the semantic head and
        the cascade's options."""
        self.mask_info_flow = bool(cfg.get("mask_info_flow", True))
        self.interleaved = bool(cfg.get("interleaved", True))
        mh = cfg.get("mask_head")
        if mh is not None:
            heads = mh if isinstance(mh, (list, tuple)) \
                else [mh] * self.num_stages
            for h in heads:
                if dict(h).get("type", "HTCMaskHead") not in MASK_HEAD_TYPES:
                    raise NotImplementedError(
                        f"HTC mask head {h['type']} is not ported to "
                        f"bonai_tpu_torch yet (ROADMAP.md item A7)")
            self.roi_head["mask_head"] = nn.ModuleList(HTCMaskHead(
                h.get("num_convs", 4), h.get("in_channels", 256),
                h.get("conv_out_channels", 256), h.get("num_classes", 1),
                with_conv_res=self.mask_info_flow and i > 0)
                for i, h in enumerate(heads))
            self.mask_extractor_cfg = self._extractor(
                cfg["mask_roi_extractor"])
        sem = cfg.get("semantic_head")
        if sem is None:
            return
        sem = dict(sem)
        self.roi_head["semantic_head"] = FusedSemanticHead(
            sem.get("num_ins", 5), sem.get("fusion_level", 1),
            sem.get("num_convs", 4), sem.get("in_channels", 256),
            sem.get("conv_out_channels", 256), sem.get("num_classes", 183))
        # mmdet's htc configs give a flat loss_weight, the BONAI one nests
        # it under loss_seg
        self.semantic_loss_weight = dict(sem.get("loss_seg") or {}).get(
            "loss_weight", sem.get("loss_weight", 0.2))
        self.semantic_stride = int(dict(cfg.get(
            "semantic_roi_extractor", {"featmap_strides": [8]}))[
            "featmap_strides"][0])
        self.semantic_fusion = tuple(cfg.get("semantic_fusion",
                                             ("bbox", "mask")))

    def semantic(self, feats):
        """The semantic head's float32 ``(B, K, H, W)`` logits and NHWC
        embedding, or ``(None, None)`` without one."""
        if "semantic_head" not in self.roi_head:
            return None, None
        return self.roi_head["semantic_head"](feats)

    def _fuse_semantic(self, roi_feats, rois, roi_valid, sem_feat):
        """``roi_feats`` ``(R, S, S, C)`` plus the embedding's plain
        RoIAlign at ``S``^2, zero on invalid RoIs."""
        out = roi_align(sem_feat, rois, roi_feats.shape[1],
                        1.0 / self.semantic_stride)
        if roi_valid is not None:
            out = out * roi_valid[:, None, None, None].to(out.dtype)
        return roi_feats + out.to(roi_feats.dtype)

    def _bbox_head_forward(self, head, feats, rois, roi_valid,
                           sem_feat=None):
        x = self._roi_align_cfg(self.bbox_extractor_cfg, feats, rois,
                                roi_valid)
        if sem_feat is not None and "bbox" in self.semantic_fusion:
            x = self._fuse_semantic(x, rois, roi_valid, sem_feat)
        return head(x)

    def mask_stage(self, stage, feats, rois, roi_valid, sem_feat=None):
        """Stage ``stage``'s float32 ``(N, K, 2S, 2S)`` mask logits: one
        RoIAlign call, the semantic fusion, and with ``mask_info_flow`` the
        earlier stages' heads chained on the same RoI features."""
        x = self._roi_align_cfg(self.mask_extractor_cfg, feats, rois,
                                roi_valid)
        if sem_feat is not None and "mask" in self.semantic_fusion:
            x = self._fuse_semantic(x, rois, roi_valid, sem_feat)
        heads = self.roi_head["mask_head"]
        last = None
        if self.mask_info_flow:
            for head in heads[:stage]:
                last = head(x, last, return_logits=False)
        return heads[stage](x, last)

    def _roi_forward_train(self, feats, proposals, prop_valid, batch, draw):
        """``loss_semantic`` (with ``gt_semantic_seg`` ``(B, Hs, Ws)`` in
        the batch: the logits resized to it), and each stage's
        ``s<i>.loss_cls``, ``s<i>.loss_bbox`` and ``s<i>.loss_mask``
        (weighted by its stage loss weight).  ``draw`` is called for each
        stage's boxes and then, interleaved, for its mask sample on the
        boxes the stage refined, in the order of the JAX stage keys
        ``fold_in(rng, i)`` and ``fold_in(rng, 100 + i)``."""
        stage_cfgs = self.train_cfg["rcnn"]
        if isinstance(stage_cfgs, dict):
            stage_cfgs = [stage_cfgs] * self.num_stages
        gt_bboxes, gt_valid = batch["gt_bboxes"], batch["gt_valid"]
        b = gt_bboxes.shape[0]
        losses = {}
        seg_logits, sem_feat = self.semantic(feats)
        if seg_logits is not None and "gt_semantic_seg" in batch:
            tgt = batch["gt_semantic_seg"]
            sl = resize_bilinear(seg_logits, tgt.shape[1:3])
            losses["loss_semantic"] = self.semantic_loss_weight * \
                cross_entropy(sl.permute(0, 2, 3, 1).reshape(
                    -1, sl.shape[1]), tgt.reshape(-1))
        cur, cur_valid = proposals, prop_valid
        with_mask = self.with_mask and batch.get("gt_masks") is not None
        for i in range(self.num_stages):
            rcnn = dict(stage_cfgs[i])
            sampler = dict(rcnn["sampler"])
            res, sampled = assign_and_sample_rcnn(
                draw, cur, cur_valid, gt_bboxes, gt_valid,
                dict(rcnn["assigner"]), sampler)
            st = self._bbox_stage(self.roi_head["bbox_head"][i],
                                  self.bbox_coders[i], feats, sampled, res,
                                  batch, sem_feat=sem_feat)
            w = self.stage_loss_weights[i]
            losses[f"s{i}.loss_cls"] = w * st["loss_cls"]
            losses[f"s{i}.loss_bbox"] = w * l1_loss(
                st["bbox_pred"][:, :4], st["bbox_t"], st["bbox_w"],
                avg_factor=float(st["labels"].shape[0]))
            with torch.no_grad():
                refined = self._decode(i, st["rois"], st["bbox_pred"].float(),
                                       batch["img_shape"], b)
            if with_mask:
                if self.interleaved:
                    mres, msampled = assign_and_sample_rcnn(
                        draw, refined, res["valid"], gt_bboxes, gt_valid,
                        dict(rcnn["assigner"]), sampler)
                else:
                    mres, msampled = res, sampled
                num_pos = int(sampler.get("num", 512)
                              * sampler.get("pos_fraction", 0.25))
                losses[f"s{i}.loss_mask"] = w * self._stage_mask_loss(
                    i, feats, batch, rcnn, msampled[:, :num_pos],
                    mres["is_pos"][:, :num_pos],
                    mres["pos_gt_inds"][:, :num_pos], sem_feat)
            cur, cur_valid = refined, res["valid"]
        return losses

    def _stage_mask_loss(self, stage, feats, batch, rcnn, pos_boxes,
                         pos_is_pos, pos_gt, sem_feat):
        """Stage ``stage``'s mask loss on the positive slots ``(B, P)`` at
        ``train_cfg.rcnn.mask_size``."""
        mask_size = rcnn.get("mask_size", 28)
        rois, roi_valid = boxes_to_rois(pos_boxes, pos_is_pos)
        logits = self.mask_stage(stage, feats, rois, roi_valid,
                                 sem_feat)[:, 0]
        targets = mask_targets_from_instance_masks(
            rois[:, 1:5], _gather_rows(batch["gt_bboxes"], pos_gt),
            _gather_rows(batch["gt_masks"], pos_gt), mask_size)
        w = roi_valid.float()[:, None, None]
        return binary_cross_entropy(
            logits, targets, w.expand_as(logits),
            avg_factor=(w.sum() * mask_size * mask_size).clamp(min=1.0))

    @torch.inference_mode()
    def simple_test(self, img, img_shape, scale_factor):
        """The cascade's detections with the semantic embedding fused into
        every box and mask RoI feature, and the mask probabilities
        averaged over the stages' mask heads."""
        dtype = next(self.parameters()).dtype
        feats = self.extract_feat(img.to(dtype))
        proposals, _, prop_valid = self._rpn_and_proposals(
            feats, img_shape, dict(self.test_cfg.get("rpn", {})))
        return self._rcnn_simple_test(feats, proposals, prop_valid,
                                      img_shape, scale_factor,
                                      sem_feat=self.semantic(feats)[1])

    def _detections_out(self, feats, det_boxes, det_scores, det_labels,
                        det_valid, img_shape, scale_factor, sem_feat=None):
        b = det_boxes.shape[0]
        out = {"det_bboxes": det_boxes / scale_factor.float()[:, None, None],
               "det_scores": det_scores, "det_labels": det_labels,
               "det_valid": det_valid}
        if self.with_mask:
            rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
            acc = 0.0
            for i in range(self.num_stages):
                acc = acc + torch.sigmoid(self.mask_stage(
                    i, feats, rois, roi_valid, sem_feat)[:, 0])
            probs = acc / self.num_stages
            out["mask_probs"] = probs.reshape(b, -1, *probs.shape[1:])
        return out
