"""Where the training time goes on the GPU.

Builds a config (``--config``: the LOFT-FOA R50-FPN config by default, or
another detector the port builds, such as the Mask, Cascade Mask,
Dynamic, Libra, Double-Head and Mask Scoring R-CNN BONAI baselines, Grid
R-CNN, PointRend, the RPN, Fast R-CNN, LOFT-FOA on HRNet-W32 + HRFPN,
the trunk variants (DCNv2, GCNet, Res2Net, RegNetX-3.2GF, generalized
attention, PAFPN), HTC (its batch with a ``gt_semantic_seg`` planted from
the GT masks, so that the semantic loss runs), DetectoRS, Guided-Anchoring
Faster R-CNN, or a dense single-stage detector: RetinaNet, its GHM and
PISA configs, NAS-FPN RetinaNet, FreeAnchor, ATSS, GFL, FCOS, NAS-FCOS,
FSAF, FoveaBox, RepPoints, SSD300, CornerNet) for
training with ``train_detector``'s
``build_trainer`` (seeded random float32 weights, channels-last, the
config's SGD and schedule), takes a few steps on the synthetic padded
batch of
:func:`synthetic_batch` (1024^2, B=2, 100 GTs; for a Fast R-CNN with
2000 proposals an image, :func:`synthetic_proposals`) under bfloat16
autocast, and prints

- the step time (host clock around a synchronised step, median of 5);
- each stage's time (the device synchronised at each stage's start and
  end): the backbone and the neck (named with their types), the
  backbone's deformable sampling (its forward, and its backward apart
  from the rest of the backward), attention blocks and SAC convs apart
  from the backbone, the RFP's steps apart from the neck, the RPN
  head, proposals (with their NMS), the RPN targets and loss, R-CNN assignment and sampling, the RoIAlign forward
  of the route (B1, under the block or the strip rule), the plain RoIAlign
  of a ``GenericRoIExtractor``, each RoI head (a cascade's stage by
  stage; HTC's semantic head and mask info-flow chain), HTC's semantic
  fusion, mask, grid and point targets, PointRend's training points and
  point features, the rest of the forward, clip
  + SGD, and what the step leaves after those (the backward, with the
  RoIAlign backward B2 inside); for a dense single-stage detector the
  backbone and the neck, the head (towers and outputs), the anchors or
  points, the targets (the assignment: max-IoU, ATSS, FCOS's, FSAF's
  regions and level selection, FoveaBox's foveas, RepPoints' point and
  max-IoU assigners; FreeAnchor matches inside its loss), the loss, the
  rest of the forward, clip + SGD and the backward; a head's deformable
  sampling (RepPoints', NAS-FCOS's) apart from the head, forward and
  backward; NAS-FPN's stacks and NAS-FCOS's cells apart from the neck,
  SSD's hard-negative mining apart from its loss, CornerNet's corner
  pools apart from its head (forward);
  GA-RPN's location and shape targets apart from the rest of its loss,
  and its deformable sampling apart from its head;
- from ``torch.profiler`` over one step: the summed CUDA kernel time, the
  device's idle share against the wall time of an unprofiled step, and
  the kernels that take the most time.

Needs a CUDA device.  Run from the repository root:

    python -m bonai_tpu_torch.tools.profile_train [--config CONFIG] \
        [--roi-align-impl pallas]
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import time

import numpy as np
import torch

from ..apis.train import build_trainer
from ..config import Config
from ..core.samplers import generator_draws
from ..engine import train_step as train_step_module
from ..models.dense_heads import (atss_head, corner_head, fcos_head,
                                  fovea_head, fsaf_head, ga_rpn_head,
                                  gfl_head, reppoints_head, retina_head,
                                  ssd_head)
from ..models.detectors import single_stage
from .profile_serve import (CORNER_POOL, DENSE_HEAD, SEMANTIC_FUSION,
                            geometry_attr, is_dense, patch_backbone_parts,
                            patch_functions, restore_backbone_parts,
                            restore_functions, roi_heads, split_backbone,
                            time_heads, trunk)

# the dense detectors' losses (in the detector module) and the target
# functions they call (in the head modules)
DENSE_LOSSES = ("retina_loss", "free_anchor_loss", "atss_loss", "gfl_loss",
                "fcos_loss", "fsaf_loss", "fovea_loss", "reppoints_loss",
                "ssd_loss")
DENSE_TARGETS = ("retina_targets", "atss_targets", "fcos_targets",
                 "fsaf_targets", "fovea_targets_level", "ssd_targets",
                 "corner_targets")
HARD_NEGATIVES = "loss: hard-negative mining"
GA_TARGETS = "rpn: loc/shape targets"

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..",
                      "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")


def synthetic_proposals(gt_bboxes, gt_valid, n=2000, size=1024, seed=0):
    """Fast R-CNN's proposals for the GTs ``(B, G, 4)`` of a ``size``^2
    batch, from a numpy seed: each image's valid GT boxes jittered by up
    to a tenth of their size, then random boxes inside the image whose
    sides are log-uniform on 8..``0.9 size`` px (so that every pyramid
    level gets RoIs), the last image's last eighth padding.  Returns
    ``(B, n, 4)`` float32 proposals and their ``(B, n)`` validity."""
    r = np.random.RandomState(seed)
    b = gt_bboxes.shape[0]
    wh = np.exp(r.uniform(np.log(8.0), np.log(size * 0.9), (b, n, 2)))
    xy = r.uniform(0.0, 1.0, (b, n, 2)) * (size - 1 - wh)
    props = np.concatenate([xy, xy + wh], -1)
    for i in range(b):
        gts = np.asarray(gt_bboxes[i])[np.asarray(gt_valid[i])][:n]
        span = np.tile(gts[:, 2:] - gts[:, :2], 2)       # w, h, w, h
        props[i, :len(gts)] = gts + r.uniform(-0.1, 0.1, gts.shape) * span
    valid = np.ones((b, n), bool)
    valid[-1, n - n // 8:] = False
    props[~valid] = 0.0
    return props.astype(np.float32), valid


def semantic_seg(gt_bboxes, gt_valid, gt_masks, size, stride=8):
    """HTC's ``gt_semantic_seg`` ``(B, size / stride, size / stride)``
    planted from a batch's GTs: class 1 (the BONAI semantic head's roof)
    on the cells whose centres fall on a valid GT's instance mask, 0
    elsewhere."""
    s = size // stride
    out = np.zeros((gt_bboxes.shape[0], s, s), np.int32)
    centres = (np.arange(s) + 0.5) * stride
    for i in range(len(out)):
        for box, mask in zip(gt_bboxes[i][gt_valid[i]],
                             gt_masks[i][gt_valid[i]]):
            m = mask.shape[-1]
            ys = np.floor((centres - box[1]) / max(box[3] - box[1], 1e-6)
                          * m).astype(int)
            xs = np.floor((centres - box[0]) / max(box[2] - box[0], 1e-6)
                          * m).astype(int)
            iy, ix = np.nonzero((ys >= 0) & (ys < m))[0], np.nonzero(
                (xs >= 0) & (xs < m))[0]
            out[i][np.ix_(iy, ix)] |= mask[np.ix_(ys[iy], xs[ix])] > 0
    return out


def synthetic_batch(batch=2, size=1024, g=100, m=112, seed=0, proposals=0,
                    semantic=False):
    """The padded batch of ``bench.py``'s training benchmark, from a numpy
    seed: normalised float images, ``g`` GT boxes of 10..``size/5`` px,
    random ``m``^2 instance masks, offsets within +-30 px; with
    ``proposals``, that many of :func:`synthetic_proposals` an image; with
    ``semantic``, HTC's :func:`semantic_seg` at stride 8."""
    r = np.random.RandomState(seed)
    xy1 = r.uniform(0, size * 0.6, (batch, g, 2)).astype(np.float32)
    wh = r.uniform(10, size * 0.2, (batch, g, 2)).astype(np.float32)
    out = {
        "image": r.randn(batch, size, size, 3).astype(np.float32),
        "img_shape": np.full((batch, 2), float(size), np.float32),
        "gt_bboxes": np.concatenate([xy1, np.minimum(xy1 + wh, size - 1)],
                                    -1),
        "gt_labels": np.zeros((batch, g), np.int32),
        "gt_valid": np.ones((batch, g), bool),
        "gt_masks": (r.rand(batch, g, m, m) > 0.4).astype(np.uint8),
        "gt_offsets": r.uniform(-30, 30, (batch, g, 2)).astype(np.float32)}
    if proposals:
        out["proposals"], out["proposals_valid"] = synthetic_proposals(
            out["gt_bboxes"], out["gt_valid"], proposals, size, seed)
    if semantic:
        out["gt_semantic_seg"] = semantic_seg(
            out["gt_bboxes"], out["gt_valid"], out["gt_masks"], size)
    return out


def _timed(name, fn, totals):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapper


def step_ms(train_step, batch, draw, reps=5):
    times = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch, i, draw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _patch_stages(model, totals):
    """Time the stages of ``model``'s step; returns the patched methods
    and modules and what :func:`restore_functions` puts back."""
    patched = {"forward_train": "forward"}
    if is_dense(model):
        if geometry_attr(model):
            patched[geometry_attr(model)] = "anchors or points"
        if isinstance(model, single_stage.CornerNet):    # its loss inline
            patched["_loss"] = "loss+targets"
        heads = {**trunk(model), DENSE_HEAD: model.bbox_head}
        saved = patch_functions(dict.fromkeys(DENSE_LOSSES, "loss+targets"),
                                totals, (single_stage,))
        saved += patch_functions(dict.fromkeys(DENSE_TARGETS, "targets"),
                                 totals, (retina_head, atss_head, gfl_head,
                                          fcos_head, fsaf_head, fovea_head,
                                          ssd_head, single_stage))
        saved += patch_functions(dict.fromkeys(
            ("point_assign", "max_iou_assign"), "targets"), totals,
            (reppoints_head,))
        saved += patch_functions({"hard_negatives": HARD_NEGATIVES}, totals,
                                 (ssd_head,))
        saved += patch_functions({"corner_pool": CORNER_POOL}, totals,
                                 (corner_head,))
    else:
        heads = {**trunk(model), **({"rpn_head": model.rpn_head}
                                    if model.has_rpn else {}),
                 **dict(roi_heads(model))}
        saved = patch_functions(
            {"rpn_proposals": "proposals (NMS)",
             "ga_proposals": "proposals (NMS)",
             "rpn_loss": "rpn targets+loss",
             "ga_rpn_loss": "rpn targets+loss",
             "assign_and_sample_rcnn": "rcnn assign+sample",
             "roi_align_block": "roi_align_block fwd (B1)",
             "roi_align_fused": "roi_align_fused fwd (B1, strip rule)",
             "roi_align_at_levels": "RoIAlign, plain (generic extractor)",
             "mask_targets_from_instance_masks": "mask targets",
             "grid_targets": "grid targets",
             "uncertainty_points_train": "training points",
             "fine_grained_point_feats": "point features",
             "point_targets_from_instance_masks": "point targets",
             "roi_align": SEMANTIC_FUSION}, totals)
        saved += patch_functions(dict.fromkeys(
            ("ga_loc_targets", "ga_shape_targets"), GA_TARGETS), totals,
            (ga_rpn_head,))
    for attr, name in patched.items():
        setattr(model, attr, _timed(name, getattr(model, attr), totals))
    time_heads(heads, totals)
    return patched, heads, saved, patch_backbone_parts(model, totals)


def stage_times(model, train_step, batch, draw, reps=3):
    """Mean over ``reps`` steps: ``{stage: ms}`` and the total ms a step.
    The backward is what the step's total leaves after the forward and
    the update."""
    totals = collections.defaultdict(float)
    patched, heads, saved, parts = _patch_stages(model, totals)
    saved_update = train_step_module.apply_gradients
    train_step_module.apply_gradients = _timed("clip+sgd", saved_update,
                                               totals)
    try:
        wall = 0.0
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(batch, i, draw)
            torch.cuda.synchronize()
            wall += (time.perf_counter() - t0) * 1e3
    finally:
        restore_backbone_parts(parts)
        for attr in patched:
            delattr(model, attr)
        for m in heads.values():
            del m.forward
        restore_functions(saved)
        train_step_module.apply_gradients = saved_update
    stages = {k: v / reps for k, v in totals.items()}
    if "loss+targets" in stages:
        stages["loss"] = stages.pop("loss+targets") - stages.get(
            "targets", 0.0) - stages.get(HARD_NEGATIVES, 0.0)
    if GA_TARGETS in stages:
        stages["rpn targets+loss"] -= stages[GA_TARGETS]
    forward = stages.pop("forward")
    backward = "backward (incl. B2) + rest"
    stages[backward] = wall / reps - forward - stages["clip+sgd"]
    split_backbone(model, stages, backward, rpn="rpn_head")
    # the forward's total holds the stages timed inside it
    stages["forward, rest"] = forward - sum(
        v for k, v in stages.items() if k not in ("clip+sgd", backward)
        and not k.endswith("backward"))
    return stages, wall / reps


def profile(train_step, batch, draw):
    """One step under ``torch.profiler``: summed kernel ms and the kernels
    by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        train_step(batch, 0, draw)
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
    parser = argparse.ArgumentParser(description="Where the training time "
                                     "goes on the GPU.")
    parser.add_argument("--config", default=CONFIG,
                        help="detector config (default: LOFT-FOA R50-FPN)")
    parser.add_argument("--roi-align-impl", default=None,
                        help="RoIAlign route (default: the config's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    cfg = Config.fromfile(args.config)
    if args.roi_align_impl:
        cfg.model.roi_align_impl = args.roi_align_impl
    model, _, train_step, generator = build_trainer(cfg,
                                                    torch.device("cuda"))
    draw = generator_draws(generator)
    batch = {k: torch.as_tensor(v).cuda() for k, v in synthetic_batch(
        proposals=2000 if model.takes_proposals else 0,
        semantic="semantic_head" in getattr(model, "roi_head", {})).items()}
    train_step(batch, 0, draw)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall = step_ms(train_step, batch, draw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stages, staged = stage_times(model, train_step, batch, draw)
    print(f"{os.path.basename(args.config)}: "
          f"train step 1024^2 B=2 bf16 autocast, roi_align_impl="
          f"{getattr(model, 'roi_align_impl', None)}: {wall:.1f} ms "
          f"(median of 5), peak memory {peak:.2f} GiB; stage times "
          f"(synchronised at each stage), {staged:.1f} ms a step:")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {ms:9.2f} ms  {100 * ms / staged:5.1f} %")
    kernels, rows = profile(train_step, batch, draw)
    print(f"profiler: CUDA kernels {kernels:.1f} ms a step, device idle "
          f"{100 * (1 - kernels / wall):.1f} % of the {wall:.1f} ms step")
    for ms, count, key in rows[:20]:
        print(f"  {ms:9.2f} ms  {count:7d}x  {key[:90]}")


if __name__ == "__main__":
    main()
