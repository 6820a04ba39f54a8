"""Grid R-CNN (counterpart of ``bonai_tpu/models/detectors/grid_rcnn.py``;
reference ``mmdet/models/detectors/grid_rcnn.py`` and
``roi_heads/grid_roi_head.py``): the box head classifies only
(``with_reg=False``), and the grid head's heatmaps place the boxes."""

from __future__ import annotations

from ..losses import binary_cross_entropy
from ..roi_heads.grid_head import (GridHead, grid_decode_boxes, grid_targets,
                                   jitter_boxes)
from .two_stage import (TwoStageDetector, _gather_rows, _kwargs,
                        _require_type, boxes_to_rois)

JITTER = 0.15           # the reference's jitter amplitude


class GridRCNN(TwoStageDetector):
    """Training adds ``loss_grid`` on the jittered positive boxes; testing
    moves each detection to its grid points' vote.  Every positive slot
    trains the grid head: ``train_cfg.rcnn.max_num_grid`` is not read, as
    in the JAX package (ROADMAP.md queue C)."""

    def _setup_roi_head(self, cfg):
        super()._setup_roi_head(cfg)
        gh = dict(cfg.get("grid_head") or {})
        _require_type(gh, "GridHead", "A7")
        self.grid_loss_weight = dict(gh.pop("loss_grid", None) or {}).get(
            "loss_weight", 15.0)
        # the JAX grid head's convs always take GroupNorm(36) and read no
        # norm_cfg: the gn-head configs' value is what it computes
        norm = gh.pop("norm_cfg", None)
        if norm is not None and dict(norm) != dict(type="GN",
                                                   num_groups=36):
            raise NotImplementedError(
                f"grid_head norm_cfg {norm} is not ported to bonai_tpu_torch "
                f"(the JAX grid head has GroupNorm(36); ROADMAP.md item A7)")
        self.roi_head["grid_head"] = GridHead(**_kwargs(gh, "grid_head", (
            "grid_points", "num_convs", "roi_feat_size", "in_channels",
            "point_feat_channels"), "A7"))
        self.grid_extractor_cfg = self._extractor(
            cfg.get("grid_roi_extractor") or cfg["bbox_roi_extractor"])

    def _dummy_extra_heads(self, feats, rois):
        """The grid head's fused and unfused heatmaps."""
        return [self.roi_head["grid_head"](self._roi_align_cfg(
            self.grid_extractor_cfg, feats, rois, None), unfused=True)]

    def _extra_forward_train(self, feats, batch, rcnn, pos_boxes, pos_is_pos,
                             pos_gt, draw):
        """``loss_grid``: the sigmoid cross-entropy of the fused and the
        unfused heatmaps (logits clipped to +-30) on the positive boxes
        jittered by ``draw.offsets``, over the valid RoIs' cells."""
        b, p = pos_boxes.shape[:2]
        jittered = jitter_boxes(
            draw.offsets((b, p, 4), pos_boxes.device, JITTER), pos_boxes,
            batch["img_shape"])
        rois, roi_valid = boxes_to_rois(jittered, pos_is_pos)
        head = self.roi_head["grid_head"]
        pred = head(self._roi_align_cfg(self.grid_extractor_cfg, feats, rois,
                                        roi_valid), unfused=True)
        target = grid_targets(rois[:, 1:5], _gather_rows(batch["gt_bboxes"],
                                                         pos_gt),
                              head.grid_points, head.whole_map_size,
                              rcnn.get("pos_radius", 1))
        w = roi_valid.float()[:, None, None, None].expand_as(target)
        avg = (roi_valid.float().sum() * target[0].numel()).clamp(min=1.0)
        return {"loss_grid": self.grid_loss_weight * sum(
            binary_cross_entropy(pred[k].clamp(-30, 30), target, w, avg)
            for k in ("fused", "unfused"))}

    def _extra_simple_test(self, feats, det_boxes, det_valid, img_shape,
                           scale_factor):
        """The detections ``(B, M, 4)`` placed by the grid head's fused
        heatmaps, padded slots kept, in original-image pixels."""
        b, m = det_boxes.shape[:2]
        rois, roi_valid = boxes_to_rois(det_boxes, det_valid)
        head = self.roi_head["grid_head"]
        heatmap = head(self._roi_align_cfg(self.grid_extractor_cfg, feats,
                                           rois, roi_valid))["fused"]
        placed = grid_decode_boxes(rois[:, 1:5].float(), heatmap,
                                   head.grid_points, head.whole_map_size,
                                   img_shape.repeat_interleave(m, 0))
        placed = placed.view(b, m, 4).where(det_valid[..., None], det_boxes)
        return {"det_bboxes": placed / scale_factor.float()[:, None, None]}
