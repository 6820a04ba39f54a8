"""Cascade (Mask) R-CNN (counterpart of
``bonai_tpu/models/detectors/cascade_rcnn.py``; reference
``mmdet/models/detectors/cascade_rcnn.py`` and
``roi_heads/cascade_roi_head.py``): box heads in stages of rising IoU
thresholds and shrinking delta stds, each stage assigning and sampling the
boxes the stage before it regressed; at test time the class scores are
averaged over the stages, each run on the boxes of the one before.

The choices of the JAX package, kept here (ROADMAP.md queue C lists where
they leave mmdetection's ``CascadeRoIHead``):

- every stage's box loss is L1, whatever its ``loss_bbox`` says, and no
  stage reads PISA's ``isr``/``carl`` or ranks by a hard-mining sampler
  (the port raises A7 for those);
- a stage refines all its sampled slots, the GTs it sampled among them;
- the regression is class-agnostic unless a stage's config says not, and
  refinement and the loss read the first four deltas;
- the mask branch runs once, on the last stage's positive slots.

The stages' heads are ``roi_head.bbox_head.<i>``, mmdet's keys, so an
mmdet cascade ``state_dict`` loads as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.boxes import clip_boxes, delta2bbox
from ...core.nms import multiclass_nms
from ..losses import l1_loss
from .two_stage import (TwoStageDetector, _bbox_head, _refuse_roi_keys,
                        assign_and_sample_rcnn, boxes_to_rois)


def _img_hw(img_shape):
    """``(h, w)`` of each image, broadcasting against ``(B, N)``."""
    return (img_shape[:, 0, None].float(), img_shape[:, 1, None].float())


class CascadeRCNN(TwoStageDetector):

    # the stages sample at random, IoU-, instance-balanced or combined; the
    # hard-mining samplers and PISA raise A7 as the detector is built
    rcnn_extras = False

    def _setup_roi_head(self, cfg):
        _refuse_roi_keys(cfg, cascade=True)
        heads = cfg["bbox_head"]
        if isinstance(heads, dict):
            heads = [heads] * cfg.get("num_stages", 3)
        self.num_stages = len(heads)
        self.stage_loss_weights = list(cfg.get(
            "stage_loss_weights", [1.0, 0.5, 0.25][:self.num_stages]))
        built = [_bbox_head(dict(h, bbox_coder=h.get("bbox_coder", dict(
            target_means=[0.] * 4, target_stds=[0.1, 0.1, 0.2, 0.2]))),
            reg_class_agnostic=True, cascade=True) for h in heads]
        self.roi_head["bbox_head"] = nn.ModuleList(h for h, _, _ in built)
        self.bbox_coders = [c for _, c, _ in built]
        self.bbox_extractor_cfg = self._extractor(cfg["bbox_roi_extractor"])
        self._setup_mask_head(cfg, cascade=True)

    def forward_dummy(self, img):
        """The JAX cascade's ``__call__``: the RPN head's outputs, and every
        stage's box head and the mask head on the dummy RoIs' features
        (``TwoStageDetector.forward_dummy``)."""
        feats = self.extract_feat(img)
        outs = self.rpn_head([f.permute(0, 3, 1, 2) for f in feats])
        rois = self._dummy_rois(img)
        bf = self._roi_align_cfg(self.bbox_extractor_cfg, feats, rois, None)
        extra = [h(bf) for h in self.roi_head["bbox_head"]]
        if self.with_mask:
            extra.append(self.roi_head["mask_head"](self._roi_align_cfg(
                self.mask_extractor_cfg, feats, rois, None)))
        return outs, extra

    def _aug_test_box_head(self):
        """The first stage's head with the last stage's coder: the JAX
        cascade's ``aug_test`` runs the trunk's single-head path, whose
        ``bbox_head_m`` is the first stage and ``bbox_coder_cfg`` the last
        stage's (ROADMAP.md queue C)."""
        return self.roi_head["bbox_head"][0], self.bbox_coders[-1]

    def _decode(self, i, rois, bbox_pred, img_shape, b):
        """Stage ``i``'s boxes ``(B, N, 4)``: its first four deltas decoded
        on ``rois`` ``(B*N, 5)`` and clipped to each image."""
        coder = self.bbox_coders[i]
        boxes = delta2bbox(rois[:, 1:5], bbox_pred[:, :4],
                           tuple(coder.get("target_means", (0.,) * 4)),
                           tuple(coder.get("target_stds", (1.,) * 4)))
        return clip_boxes(boxes.reshape(b, -1, 4), _img_hw(img_shape))

    def _roi_forward_train(self, feats, proposals, prop_valid, batch, draw):
        """Each stage's losses ``s<i>.loss_cls`` / ``s<i>.loss_bbox``
        (weighted by its stage loss weight) and the mask loss.  ``draw`` is
        called once a stage."""
        stage_cfgs = self.train_cfg["rcnn"]
        if isinstance(stage_cfgs, dict):
            stage_cfgs = [stage_cfgs] * self.num_stages
        b = batch["gt_bboxes"].shape[0]
        losses = {}
        cur, cur_valid = proposals, prop_valid
        for i in range(self.num_stages):
            rcnn = dict(stage_cfgs[i])
            res, sampled = assign_and_sample_rcnn(
                draw, cur, cur_valid, batch["gt_bboxes"], batch["gt_valid"],
                dict(rcnn["assigner"]), dict(rcnn["sampler"]))
            st = self._bbox_stage(self.roi_head["bbox_head"][i],
                                  self.bbox_coders[i], feats, sampled, res,
                                  batch)
            w = self.stage_loss_weights[i]
            losses[f"s{i}.loss_cls"] = w * st["loss_cls"]
            losses[f"s{i}.loss_bbox"] = w * l1_loss(
                st["bbox_pred"][:, :4], st["bbox_t"], st["bbox_w"],
                avg_factor=float(st["labels"].shape[0]))
            if i < self.num_stages - 1:
                with torch.no_grad():
                    cur = self._decode(i, st["rois"],
                                       st["bbox_pred"].float(),
                                       batch["img_shape"], b)
                cur_valid = res["valid"]
        sampler = dict(rcnn["sampler"])
        num_pos = int(sampler.get("num", 512)
                      * sampler.get("pos_fraction", 0.25))
        losses.update(self._mask_forward_train(
            feats, batch, rcnn, sampled[:, :num_pos],
            res["is_pos"][:, :num_pos], res["pos_gt_inds"][:, :num_pos],
            draw))
        return losses

    def _rcnn_simple_test(self, feats, proposals, prop_valid, img_shape,
                          scale_factor, **head_kw):
        """Every stage on the boxes of the one before; the class scores
        averaged over the stages, the last stage's boxes, plain NMS.
        ``head_kw`` go to :meth:`_bbox_head_forward` and
        :meth:`_detections_out` (HTC's semantic feature)."""
        rcnn = dict(self.test_cfg["rcnn"])
        b = proposals.shape[0]
        cur = proposals
        scores = 0.0
        for i, head in enumerate(self.roi_head["bbox_head"]):
            rois, roi_valid = boxes_to_rois(cur, prop_valid)
            cls_score, bbox_pred = self._bbox_head_forward(
                head, feats, rois, roi_valid, **head_kw)
            scores = scores + torch.softmax(cls_score, dim=-1)
            cur = self._decode(i, rois, bbox_pred, img_shape, b)
        scores = (scores / self.num_stages).reshape(b, cur.shape[1], -1)
        det_boxes, det_scores, det_labels, det_valid = multiclass_nms(
            cur, scores, rcnn.get("score_thr", 0.05),
            dict(rcnn.get("nms", dict(type="nms", iou_threshold=0.5))),
            rcnn.get("max_per_img", 100), valid=prop_valid)
        return self._detections_out(feats, det_boxes, det_scores, det_labels,
                                    det_valid, img_shape, scale_factor,
                                    **head_kw)
