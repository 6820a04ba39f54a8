"""Where the serving time goes on the GPU.

Runs ``simple_test`` of a config (``--config``: the LOFT-FOA R50-FPN
config by default, or another detector the port builds, such as the Mask,
Cascade Mask, Dynamic, Libra, Double-Head and Mask Scoring R-CNN BONAI
baselines, Grid R-CNN, PointRend, the RPN, Fast R-CNN (on 2000 synthetic
proposals an image, ``profile_train.synthetic_proposals``), LOFT-FOA on
HRNet-W32 + HRFPN, the trunk variants (the DCNv2, GCNet, Res2Net and
RegNetX-3.2GF Mask R-CNNs, the generalized-attention and PAFPN Faster
R-CNNs), HTC, DetectoRS, Guided-Anchoring Faster R-CNN, or a dense
single-stage detector: RetinaNet, its GHM and PISA configs, NAS-FPN
RetinaNet, FreeAnchor, ATSS, GFL, FCOS, NAS-FCOS, FSAF, FoveaBox,
RepPoints, SSD300, CornerNet;
1024^2, B=2, bfloat16,
seeded random weights, or a trained ``.pth`` given with ``--checkpoint``,
loaded as the test CLI loads it) and prints

- each stage's time (host clock, the device synchronised at each stage's
  start and end): the backbone and the neck (named with their types:
  ResNet, Res2Net, RegNet or HRNet, and FPN, PAFPN, HRFPN or RFP), the
  backbone's deformable sampling, attention blocks and switchable atrous
  convs apart from it (``backbone: DCN sampling``, ``backbone:
  ContextBlock``, ``backbone: SAC``, ...), the RFP's steps apart from the
  neck (``neck: RFP step (ASPP + backbone copy)``), RPN and
  proposals (with its NMS), the
  RoIAlign kernel of the route (B1, under the block rule for ``block``
  and under the strip rule for ``pallas``), the plain RoIAlign of a
  ``GenericRoIExtractor`` (PointRend's mask branch), each RoI head (a
  cascade's stage by stage; HTC's semantic head, and its mask heads'
  calls for the next stage's feature as the ``mask info-flow chain``),
  HTC's semantic fusion (the plain single-level RoIAlign), Grid R-CNN's
  vote, PointRend's uncertain
  cells and point features, the R-CNN multi-class NMS (soft-NMS in the
  LOFT configs), and the rest; for a dense single-stage detector the
  backbone and the neck, the head (its towers and output convs over the
  levels), the anchors or points, the decode (per-level top-k, boxes) and
  the multi-class NMS; a head's or a GA-RPN's deformable sampling apart
  from it (``head: DCN sampling``, ``rpn: DCN sampling``); NAS-FPN's
  stacks and NAS-FCOS's concat cells apart from the neck (``neck: NAS-FPN
  stack <s>``, ``neck: cell <name>``); CornerNet's corner pools apart
  from its head (``head: corner pool``), its corner decode and its
  soft-NMS;
- from ``torch.profiler`` over one call: the summed CUDA kernel time, the
  device's idle share against the wall time of an unprofiled call, and
  the kernels that take the most time.

Needs a CUDA device.  Run from the repository root:

    python -m bonai_tpu_torch.tools.profile_serve [--config CONFIG] \
        [--roi-align-impl pallas] [--checkpoint PATH]
"""

from __future__ import annotations

import argparse
import collections
import os
import time

import numpy as np
import torch

from ..apis import init_detector, prepare_batch
from ..config import Config
from ..models.dense_heads import corner_head, retina_head, ssd_head
from ..models.detectors import (cascade_rcnn, grid_rcnn, htc, point_rend,
                                single_stage, two_stage)
from ..models.necks.nas_fpn import NASFPN
from ..models.necks.nasfcos_fpn import NASFCOS_FPN
from ..models.necks.rfp import RFP
from ..models.roi_heads.mask_head import HTCMaskHead
from ..ops import deform_conv, layers
from ..ops.saconv import SAConv2d

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..",
                      "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
# the detector modules whose functions the stages patch
DETECTOR_MODULES = (two_stage, cascade_rcnn, grid_rcnn, point_rend, htc)
# HTC's stage names
SEMANTIC_FUSION = "semantic fusion, plain RoIAlign"
INFO_FLOW = "mask info-flow chain"
RFP_STEP = "neck: RFP step (ASPP + backbone copy)"
# the dense detectors' decodes (in the detector module) and their NMS (in
# the head module whose helper calls it)
DENSE_DECODES = ("retina_bboxes", "atss_bboxes", "gfl_bboxes",
                 "fcos_bboxes", "fsaf_bboxes", "fovea_bboxes",
                 "reppoints_bboxes", "ssd_bboxes")
CORNER_POOL = "head: corner pool"
# a dense detector's head, and the stage that holds a GA-RPN
DENSE_HEAD = "head (towers + outputs)"
RPN_STAGE = "rpn+proposals"


def is_dense(model):
    return isinstance(model, single_stage.SingleStageDetector)


def geometry_attr(model):
    """The dense detector's method that gives its anchors or points (none
    for FSAF and FoveaBox, whose targets and decodes lay out their cells
    inline)."""
    if isinstance(model, (single_stage.FSAF, single_stage.FoveaBox)):
        return None
    if isinstance(model, single_stage.RepPointsDetector):
        return "_centres"
    return "_points" if isinstance(model, single_stage.FCOS) else "_anchors"


def roi_heads(model):
    """``(name, module)`` of every RoI head: a cascade's stage heads one by
    one (``bbox_head.<i>``), HTC's semantic head as ``semantic head``."""
    for name, m in model.roi_head.items():
        if isinstance(m, torch.nn.ModuleList):
            yield from ((f"{name}.{i}", h) for i, h in enumerate(m))
        else:
            yield name.replace("semantic_head", "semantic head"), m


def time_heads(heads, totals):
    """Time each head's forward under its name; an HTC mask head's calls
    that give the next stage's feature (``return_logits=False``) under
    :data:`INFO_FLOW`."""
    for name, m in heads.items():
        m.forward = _timed(name, m.forward, totals)
        if isinstance(m, HTCMaskHead):
            m.forward = _chain_timed(m.forward, _timed(INFO_FLOW, type(
                m).forward.__get__(m), totals))


def _chain_timed(logits, chain):
    def forward(x, res_feat=None, return_logits=True):
        return (logits if return_logits else chain)(x, res_feat,
                                                     return_logits)
    return forward


def trunk(model):
    """The backbone and the neck (SSD and CornerNet have none), named with
    their types (``backbone (HRNet)``)."""
    return {f"{k} ({type(m).__name__})": m
            for k, m in (("backbone", model.backbone), ("neck", model.neck))
            if m is not None}


def neck_parts(neck):
    """``(module, stage)`` of NAS-FPN's merge cells (by stack) and
    NAS-FCOS's concat cells."""
    if isinstance(neck, NASFPN):
        return [(cell, f"neck: NAS-FPN stack {s}")
                for s, stage in enumerate(neck.fpn_stages)
                for cell in stage.values()]
    if isinstance(neck, NASFCOS_FPN):
        return [(cell, f"neck: cell {name}")
                for name, cell in neck.fpn.items()]
    return []


def patch_backbone_parts(model, totals):
    """Time the deformable sampling (the forward, and in a training step
    the backward, of ``ops/deform_conv.py``'s sampling function) under
    the part that calls it: ``backbone: DCN sampling``, or ``head: DCN
    sampling`` in a dense head, ``rpn: DCN sampling`` in a GA-RPN; the
    backbone's attention blocks (``ContextBlock``,
    ``GeneralizedAttention``, ``NonLocal2d``) and its switchable atrous
    convs (``backbone: SAC``) as stages of their own, ``backbone:
    <part>``, and the RFP's ASPP and backbone copies as :data:`RFP_STEP`;
    :func:`split_backbone` takes them out of the backbone's, the neck's,
    the head's or the RPN's (and the backward's) time.  Returns what
    :func:`restore_backbone_parts` puts back."""
    blocks = [(m, f"backbone: {type(m).__name__}")
              for m in model.backbone.modules()
              if isinstance(m, (layers.ContextBlock,
                                layers.GeneralizedAttention,
                                layers.NonLocal2d))]
    blocks += [(m, "backbone: SAC") for m in model.backbone.modules()
               if isinstance(m, SAConv2d)]
    if isinstance(model.neck, RFP):
        blocks += [(m, RFP_STEP) for m in (model.neck.rfp_aspp,
                                           *model.neck.rfp_modules)]
    blocks += neck_parts(model.neck)
    for m, name in blocks:
        m.forward = _timed(name, m.forward, totals)
    part = ["backbone"]
    callers = [(m, name) for m, name in (
        (getattr(model, "bbox_head", None), "head"),
        (getattr(model, "rpn_head", None), "rpn"))
        if m is not None and any(isinstance(x, (
            deform_conv.DeformConv2d, deform_conv.DeformConv2dPack))
            for x in m.modules())]
    callers = [(m, name, m.__dict__.get("forward")) for m, name in callers]
    for m, name, _ in callers:
        m.forward = _in_part(part, name, m.forward)
    sample = deform_conv._DeformSample
    saved = {k: sample.__dict__[k] for k in ("forward", "backward")}
    fwd, bwd = saved["forward"].__func__, saved["backward"].__func__

    def forward(ctx, *args):
        ctx.stage_part = part[0]
        return _timed(f"{part[0]}: DCN sampling, forward", fwd, totals)(
            ctx, *args)

    def backward(ctx, *grads):
        return _timed(f"{ctx.stage_part}: DCN sampling, backward", bwd,
                      totals)(ctx, *grads)
    sample.forward, sample.backward = (staticmethod(forward),
                                       staticmethod(backward))
    return blocks, callers, saved


def _in_part(part, name, fn):
    def wrapper(*args, **kwargs):
        outer, part[0] = part[0], name
        try:
            return fn(*args, **kwargs)
        finally:
            part[0] = outer
    return wrapper


def restore_backbone_parts(saved):
    blocks, callers, fns = saved
    for m, _ in blocks:
        del m.forward
    for m, _, own in callers:       # the instance's own forward, if any
        if own is None:
            del m.forward
        else:
            m.forward = own
    for k, fn in fns.items():
        setattr(deform_conv._DeformSample, k, fn)


def split_backbone(model, stages, backward=None, rpn=RPN_STAGE):
    """Take the backbone parts' forward times out of the backbone's stage,
    the RFP's steps out of the neck's, a dense head's or a GA-RPN's
    deformable sampling out of the head's or the RPN's stage (``rpn``),
    and their backward times out of stage ``backward``."""
    owners = {"backbone": f"backbone ({type(model.backbone).__name__})",
              "neck": f"neck ({type(model.neck).__name__})",
              "head": DENSE_HEAD, "rpn": rpn}
    for k, v in stages.items():
        part = k.split(": ")[0]
        if part not in owners or (part in ("head", "rpn")
                                  and "DCN sampling" not in k
                                  and k != CORNER_POOL):
            continue
        stages[backward if k.endswith("backward") else owners[part]] -= v


def patch_functions(names, totals, modules=DETECTOR_MODULES):
    """Time each function ``names`` keys in every module of ``modules``
    that uses it; returns what :func:`restore_functions` puts back."""
    saved = []
    for mod in modules:
        for k, name in names.items():
            if hasattr(mod, k):
                fn = getattr(mod, k)
                saved.append((mod, k, fn))
                setattr(mod, k, _timed(name, fn, totals))
    return saved


def restore_functions(saved):
    for mod, k, fn in saved:
        setattr(mod, k, fn)


def _timed(name, fn, totals):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def _timed_calls(model, batch, reps):
    """The wall ms of ``reps`` synchronised ``simple_test`` calls."""
    wall = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.simple_test(*batch)
        torch.cuda.synchronize()
        wall += (time.perf_counter() - t0) * 1e3
    return wall


def dense_stage_times(model, batch, reps=3):
    """:func:`stage_times` of a dense single-stage detector: the trunk,
    the head, the anchors or points, the decode and the NMS."""
    totals = collections.defaultdict(float)
    geometry = geometry_attr(model)
    if geometry:
        setattr(model, geometry, _timed("anchors or points",
                                        getattr(model, geometry), totals))
    corner = isinstance(model, single_stage.CornerNet)
    heads = trunk(model)
    for k, m in heads.items():
        m.forward = _timed(k, m.forward, totals)
    # CornerNet's test runs the head's last level alone
    head_attr = "level" if corner else "forward"
    setattr(model.bbox_head, head_attr, _timed(
        DENSE_HEAD, getattr(model.bbox_head, head_attr), totals))
    saved = patch_functions(dict.fromkeys(DENSE_DECODES, "decode+nms"),
                            totals, (single_stage,))
    saved += patch_functions({"multiclass_nms": "multiclass nms"}, totals,
                             (retina_head, ssd_head))
    saved += patch_functions({"decode_corners": "corner decode",
                              "soft_nms": "soft-NMS"}, totals,
                             (single_stage,))
    saved += patch_functions({"corner_pool": CORNER_POOL}, totals,
                             (corner_head,))
    parts = patch_backbone_parts(model, totals)
    try:
        wall = _timed_calls(model, batch, reps)
    finally:
        restore_backbone_parts(parts)
        if geometry:
            delattr(model, geometry)
        for m in heads.values():
            del m.forward
        delattr(model.bbox_head, head_attr)
        restore_functions(saved)
    stages = {k: v / reps for k, v in totals.items()}
    split_backbone(model, stages)
    if "decode+nms" in stages:
        stages["decode (top-k, boxes)"] = stages.pop("decode+nms") \
            - stages["multiclass nms"]
    stages["other"] = wall / reps - sum(stages.values())
    return stages, wall / reps


def stage_times(model, batch, reps=3):
    """Mean over ``reps`` calls: ``{stage: ms}`` and the total ms a call."""
    if is_dense(model):
        return dense_stage_times(model, batch, reps)
    totals = collections.defaultdict(float)
    patched = {
        "_rpn_and_proposals": (RPN_STAGE, model._rpn_and_proposals),
    }
    for attr, (name, fn) in patched.items():
        setattr(model, attr, _timed(name, fn, totals))
    heads = {**trunk(model), **dict(roi_heads(model))}
    time_heads(heads, totals)
    nms = dict(model.test_cfg.get("rcnn", {}).get("nms", {})).get("type",
                                                                  "nms")
    saved = patch_functions(
        {"roi_align_block": "roi_align_block (B1)",
         "roi_align_fused": "roi_align_fused (B1, strip rule)",
         "roi_align_at_levels": "RoIAlign, plain (generic extractor)",
         "grid_decode_boxes": "grid vote",
         "uncertainty_points_test": "uncertain cells (sort)",
         "fine_grained_point_feats": "point features",
         "roi_align": SEMANTIC_FUSION,
         "multiclass_nms": f"rcnn multiclass {nms}"}, totals)
    parts = patch_backbone_parts(model, totals)
    try:
        wall = _timed_calls(model, batch, reps)
    finally:
        restore_backbone_parts(parts)
        for attr in patched:
            delattr(model, attr)
        for m in heads.values():
            del m.forward
        restore_functions(saved)
    stages = {k: v / reps for k, v in totals.items()}
    split_backbone(model, stages)
    stages["other"] = wall / reps - sum(stages.values())
    return stages, wall / reps


def wall_ms(model, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.simple_test(*batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile(model, batch):
    """One call under ``torch.profiler``: summed kernel ms and the kernels
    by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model.simple_test(*batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only: the CPU ops that launched them report
        # the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def main(argv=None):
    parser = argparse.ArgumentParser(description="Where the serving time "
                                     "goes on the GPU.")
    parser.add_argument("--config", default=CONFIG,
                        help="detector config (default: LOFT-FOA R50-FPN)")
    parser.add_argument("--roi-align-impl", default=None,
                        help="RoIAlign route (default: the config's)")
    parser.add_argument("--checkpoint", default=None,
                        help="mmdet .pth to load (default: random weights)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    cfg = Config.fromfile(args.config)
    if args.roi_align_impl:
        cfg.model.roi_align_impl = args.roi_align_impl
    model = init_detector(cfg, args.checkpoint, seed=0)
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (1024, 1024, 3), np.uint8) for _ in range(2)]
    batch = prepare_batch(model, imgs)[:3]
    if model.takes_proposals:
        from .profile_train import synthetic_batch
        synth = synthetic_batch(proposals=2000)
        batch = (*batch, *(torch.as_tensor(synth[k]).cuda()
                           for k in ("proposals", "proposals_valid")))
    model.simple_test(*batch)                         # warm-up
    wall = wall_ms(model, batch)
    stages, staged = stage_times(model, batch)
    print(f"{os.path.basename(args.config)}: simple_test of two 1024^2 "
          f"images at the test scale, {tuple(batch[0].shape[1:3])}, bf16, "
          f"roi_align_impl="
          f"{getattr(model, 'roi_align_impl', None)}, weights "
          f"{args.checkpoint or 'random (seed 0)'}: {wall:.1f} ms a call; stage "
          f"times (synchronised at each stage), {staged:.1f} ms a call:")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {ms:9.2f} ms  {100 * ms / staged:5.1f} %")
    kernels, rows = profile(model, batch)
    print(f"profiler: CUDA kernels {kernels:.1f} ms a call, device idle "
          f"{100 * (1 - kernels / wall):.1f} % of the {wall:.1f} ms call")
    for ms, count, key in rows[:15]:
        print(f"  {ms:9.2f} ms  {count:7d}x  {key[:90]}")


if __name__ == "__main__":
    main()
