"""PointRend (counterpart of ``bonai_tpu/models/detectors/point_rend.py``;
reference ``mmdet/models/detectors/point_rend.py`` and
``roi_heads/point_rend_roi_head.py``): a Mask R-CNN whose mask branch is a
coarse FC head (7x7) refined by a point MLP on fine-grained features of
the finest FPN level."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..losses import binary_cross_entropy
from ..roi_heads.point_head import (MaskPointHead, coarse_point_sample,
                                    fine_grained_point_feats,
                                    point_targets_from_instance_masks,
                                    uncertainty_points_test,
                                    uncertainty_points_train)
from .two_stage import TwoStageDetector, _kwargs, _require_type


class PointRend(TwoStageDetector):
    """Training adds ``loss_point`` on points drawn around the coarse
    masks' uncertain cells; testing upsamples the coarse logits 2x a step
    and re-predicts the most uncertain cells of each step (5 steps, 7^2 to
    224^2, in the BONAI config)."""

    def _setup_roi_head(self, cfg):
        super()._setup_roi_head(cfg)
        ph = dict(cfg.get("point_head") or {})
        _require_type(ph, "MaskPointHead", "A7")
        self.point_loss_weight = dict(ph.pop("loss_point", None) or {}).get(
            "loss_weight", 1.0)
        self.roi_head["point_head"] = MaskPointHead(**_kwargs(
            ph, "point_head", ("num_fcs", "in_channels", "fc_channels",
                               "num_classes", "coarse_pred_each_layer"),
            "A7"))
        # the fine-grained features are the finest FPN level's (the mask
        # extractor's single stride, 4 in the config)
        self.point_stride = list(self.mask_extractor_cfg.get(
            "featmap_strides", [4]))[0]

    def _dummy_extra_heads(self, feats, rois):
        """The point head at four points, each at the RoIs' centre."""
        coarse = self.roi_head["mask_head"](self._roi_align_cfg(
            self.mask_extractor_cfg, feats, rois, None))
        rel = rois.new_full((rois.shape[0], 4, 2), 0.5)
        fine = fine_grained_point_feats(feats[0], rois, rel,
                                        self.point_stride)
        return [self.roi_head["point_head"](
            fine, coarse_point_sample(coarse, rel))]

    def _point_logits(self, feats, rois, coarse, rel_pts):
        """The point head's fg logits ``(N, P)`` at RoI-relative points."""
        fine = fine_grained_point_feats(feats[0], rois, rel_pts,
                                        self.point_stride)
        return self.roi_head["point_head"](
            fine, coarse_point_sample(coarse, rel_pts))[..., 0]

    def _mask_refine_train(self, feats, rcnn, rois, roi_valid, mask_logits,
                           gt_boxes, gt_masks, draw):
        """``loss_point``: the point head's sigmoid cross-entropy at
        ``num_points`` points a positive, the most uncertain of
        ``oversample_ratio`` times as many random points and fresh random
        ones (both from ``draw.points``), against the GT masks sampled
        there and thresholded at 0.5."""
        n = rois.shape[0]
        num_points = rcnn.get("num_points", 196)
        ratio = rcnn.get("importance_sample_ratio", 0.75)
        n_samp = int(num_points * rcnn.get("oversample_ratio", 3))
        pts, fresh = draw.points(
            ((n, n_samp, 2), (n, num_points - int(ratio * num_points), 2)),
            rois.device)
        rel_pts = uncertainty_points_train(pts, fresh,
                                           mask_logits[:, 0].detach(),
                                           num_points, ratio)
        logits = self._point_logits(feats, rois, mask_logits, rel_pts)
        target = (point_targets_from_instance_masks(
            rois, rel_pts, gt_boxes, gt_masks) >= 0.5).float()
        w = roi_valid.float()[:, None].expand_as(logits)
        return {"loss_point": self.point_loss_weight * binary_cross_entropy(
            logits, target, w,
            avg_factor=(roi_valid.float().sum() * logits.shape[1]).clamp(
                min=1.0))}

    def _mask_probs(self, feats, rois, logits):
        """Subdivision (reference ``_mask_point_forward_test``): each step
        upsamples the map 2x (bilinear, half-pixel centres) and, unless the
        map has no more cells than ``subdivision_num_points`` and a step is
        left, sets its most uncertain cells to the point head's logits
        there.  Returns the final map's probabilities."""
        tc = dict(self.test_cfg["rcnn"])
        steps = tc.get("subdivision_steps", 5)
        num_points = tc.get("subdivision_num_points", 784)
        scale = tc.get("scale_factor", 2)
        refined = logits[:, 0]
        n = refined.shape[0]
        for step in range(steps):
            h, w = refined.shape[1] * scale, refined.shape[2] * scale
            refined = F.interpolate(refined[:, None], size=(h, w),
                                    mode="bilinear", align_corners=False)[:, 0]
            if num_points >= h * w and step < steps - 1:
                continue
            idx, rel_pts = uncertainty_points_test(refined, num_points)
            point = self._point_logits(feats, rois, logits, rel_pts)
            refined = refined.reshape(n, h * w).scatter(
                1, idx, point).view(n, h, w)
        return torch.sigmoid(refined)
