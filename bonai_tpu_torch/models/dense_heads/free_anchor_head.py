"""FreeAnchor's learning-to-match loss on RetinaNet's head and anchors
(counterpart of ``bonai_tpu/models/dense_heads/free_anchor_head.py::
free_anchor_loss``, batched over images here).

Each GT's bag is its ``pre_anchor_topk`` anchors of highest IoU (exact ties
to the lower anchor index, as ``jax.lax.top_k`` breaks them); the positive
loss is the mean-max over a bag of class probability times box
probability, the negative loss the focal-weighted probability of an
anchor matching no object.  Padded GTs take part in neither.
"""

from __future__ import annotations

import torch

from ...core.boxes import bbox_overlaps, delta2bbox
from .retina_head import flatten_levels


def _encode(anchors, gt, means, stds):
    """The delta-xywh code of ``gt`` on ``anchors`` with FreeAnchor's
    floors (every size at least 1e-6)."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = (anchors[..., 2] - anchors[..., 0]).clamp(min=1e-6)
    ah = (anchors[..., 3] - anchors[..., 1]).clamp(min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=1e-6)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=1e-6)
    d = torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                     torch.log(gh / ah)], dim=-1)
    return (d - d.new_tensor(means)) / d.new_tensor(stds)


def free_anchor_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_valid,
                     gt_labels, num_classes, target_means=(0.,) * 4,
                     target_stds=(1.,) * 4, pre_anchor_topk=50, bbox_thr=0.6,
                     gamma=2.0, alpha=0.5, bbox_beta=0.11,
                     loss_bbox_weight=0.75):
    """``positive_bag_loss`` and ``negative_bag_loss`` of a batch over the
    ``(A, 4)`` concatenated anchors."""
    cls_prob = torch.sigmoid(flatten_levels(cls_scores, num_classes))
    reg = flatten_levels(bbox_preds, 4)                       # (B, A, 4)
    gt_bboxes = gt_bboxes.float()
    gv = gt_valid[..., None]                                  # (B, G, 1)
    labels = gt_labels.long()

    # P(anchor -> some object of class c), no gradient: per GT the IoU of
    # the predicted boxes mapped linearly from bbox_thr..its best to 0..1,
    # then the largest over the GTs of each class
    with torch.no_grad():
        pred = delta2bbox(anchors, reg, target_means, target_stds)
        iou = torch.where(gv, bbox_overlaps(gt_bboxes, pred), 0.0)
        t2 = iou.amax(dim=2, keepdim=True).clamp(min=bbox_thr + 1e-12)
        obj = ((iou - bbox_thr) / (t2 - bbox_thr)).clamp(0.0, 1.0)
        obj = torch.where(gv, obj, 0.0)                       # (B, G, A)
        b, g, a = obj.shape
        image_box_prob = cls_prob.new_zeros(
            (b, a, num_classes)).scatter_reduce_(
                2, labels[:, None, :].expand(b, a, g), obj.transpose(1, 2),
                "amax")

    # the positive bags
    k = min(pre_anchor_topk, a)
    anchor_iou = bbox_overlaps(gt_bboxes, anchors)            # (B, G, A)
    bag = torch.sort(anchor_iou, dim=-1, descending=True,
                     stable=True).indices[..., :k]            # (B, G, K)
    flat = bag.reshape(b, -1)
    m_cls = cls_prob.gather(1, flat[..., None].expand(-1, -1, num_classes))
    m_cls = m_cls.reshape(b, g, k, num_classes).gather(
        3, labels[:, :, None, None].expand(b, g, k, 1))[..., 0]
    m_targets = _encode(anchors[bag], gt_bboxes[:, :, None, :], target_means,
                        target_stds)
    m_reg = reg.gather(1, flat[..., None].expand(-1, -1, 4)).reshape(
        b, g, k, 4)
    diff = (m_reg - m_targets).abs()
    lb = loss_bbox_weight * torch.where(
        diff < bbox_beta, 0.5 * diff * diff / bbox_beta,
        diff - 0.5 * bbox_beta).sum(-1)                       # smooth L1
    matched_prob = m_cls * torch.exp(-lb)                     # (B, G, K)
    wgt = 1.0 / (1.0 - matched_prob).clamp(min=1e-12)
    wgt = wgt / wgt.sum(dim=-1, keepdim=True)
    bag_prob = (wgt * matched_prob).sum(-1)
    pos_loss = torch.where(gt_valid, alpha * -torch.log(
        bag_prob.clamp(1e-12, 1.0)), 0.0)

    prob = cls_prob * (1.0 - image_box_prob)
    neg = (1 - alpha) * prob ** gamma * -torch.log(
        (1.0 - prob).clamp(1e-12, 1.0))
    num_pos = gt_valid.float().sum().clamp(min=1.0)
    return {"positive_bag_loss": pos_loss.sum() / num_pos,
            "negative_bag_loss": neg.sum() / (num_pos * pre_anchor_topk)}
