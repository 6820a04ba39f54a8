"""Detector builder (counterpart of ``bonai_tpu/models/builder.py``) for
the detector types the port implements so far, mapped as the JAX package
maps them (``MaskScoringRCNN`` is a ``MaskRCNN`` with a
``mask_iou_head``, ``HybridTaskCascade`` an ``HTC``, DetectoRS a
``CascadeRCNN`` with its backbone and neck).  A config with a
``bbox_head`` and neither an ``rpn_head`` nor a ``roi_head`` is a
single-stage layout, as the JAX builder reads it."""

from __future__ import annotations

import os

from ..registry import Registry
from .detectors.cascade_rcnn import CascadeRCNN
from .detectors.grid_rcnn import GridRCNN
from .detectors.htc import HTC
from .detectors.loft import LOFT
from .detectors.point_rend import PointRend
from .detectors.single_stage import (ATSS, FCOS, FSAF, GFL, NASFCOS, SSD,
                                     CornerNet, FoveaBox, FreeAnchor,
                                     RepPointsDetector, RetinaNet,
                                     SingleStageDetector)
from .detectors.two_stage import (RPN, DynamicRCNN, FastRCNN, FasterRCNN,
                                  MaskRCNN, TwoStageDetector)

DETECTORS = Registry("detector")
for _cls in (LOFT, FasterRCNN, MaskRCNN, TwoStageDetector, CascadeRCNN,
             DynamicRCNN, RPN, FastRCNN, GridRCNN, PointRend, HTC):
    DETECTORS.register_module()(_cls)
DETECTORS.register_module(name="MaskScoringRCNN")(MaskRCNN)
DETECTORS.register_module(name="HybridTaskCascade")(HTC)
for _cls in (RetinaNet, FreeAnchor, ATSS, GFL, FCOS, FSAF, FoveaBox,
             RepPointsDetector, NASFCOS, SSD, CornerNet):
    DETECTORS.register_module()(_cls)
DETECTORS.register_module(name="FOVEA")(FoveaBox)


def _plain(obj):
    """ConfigDict -> plain dict, recursively."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def build_detector(cfg, train_cfg=None, test_cfg=None, roi_align_impl=None):
    """Build the detector ``cfg['type']`` names from its config dicts.
    A type the port does not implement yet raises ``NotImplementedError``
    naming the ROADMAP.md item that ports it.  ``train_cfg`` is what
    ``forward_train`` reads (the serving path needs only ``test_cfg``).

    A single-stage type given a two-stage layout, or the reverse, raises
    ``ValueError``.  The RoIAlign route (``gather``, ``blocked``,
    ``pallas`` or ``block``; two-stage detectors only, as in the JAX
    package) is, first found: the ``BONAI_ROI_IMPL`` environment variable, the
    ``roi_align_impl`` argument, ``cfg['roi_align_impl']`` (the JAX
    package's precedence)."""
    cfg = _plain(dict(cfg))
    det_type = cfg.pop("type")
    if det_type not in DETECTORS:
        raise NotImplementedError(
            f"detector type {det_type!r} is not ported to bonai_tpu_torch "
            f"yet (ROADMAP.md item A7; ported: "
            f"{sorted(DETECTORS.module_dict)})")
    train_cfg = _plain(dict(train_cfg)) if train_cfg else None
    test_cfg = _plain(dict(test_cfg)) if test_cfg else None
    two_stage_layout = cfg.get("rpn_head") is not None \
        or cfg.get("roi_head") is not None
    cls = DETECTORS.get(det_type)
    if issubclass(cls, SingleStageDetector):
        if two_stage_layout or cfg.get("bbox_head") is None:
            raise ValueError(
                f"{det_type} is a single-stage detector: its config needs a "
                f"bbox_head and no rpn_head or roi_head")
        return cls(
            backbone=cfg["backbone"], neck=cfg["neck"],
            bbox_head=cfg["bbox_head"], train_cfg=train_cfg,
            test_cfg=test_cfg)
    if not two_stage_layout:
        raise ValueError(
            f"{det_type} is a two-stage detector: its config needs an "
            f"rpn_head or a roi_head (a lone bbox_head is a single-stage "
            f"layout)")
    # the RPN has no RoI head and Fast R-CNN no RPN; another detector
    # without either is a C4 layout
    if (cfg.get("rpn_head") is None and det_type != "FastRCNN") or (
            cfg.get("roi_head") is None and det_type != "RPN"):
        raise NotImplementedError(
            "detectors without an RPN or RoI head are not ported yet "
            "(ROADMAP.md item A7)")
    return cls(
        backbone=cfg["backbone"], neck=cfg.get("neck"),
        rpn_head=cfg.get("rpn_head"), roi_head=cfg.get("roi_head"),
        train_cfg=train_cfg, test_cfg=test_cfg,
        roi_align_impl=(os.environ.get("BONAI_ROI_IMPL") or roi_align_impl
                        or cfg.get("roi_align_impl")))
