"""Where the serving time goes on the GPU.

Runs ``simple_test`` of a config (``--config``: the LOFT-FOA R50-FPN
config by default, or another detector the port builds, such as the Mask,
Cascade Mask or Dynamic R-CNN BONAI baselines or LOFT-FOA on HRNet-W32 +
HRFPN; 1024^2, B=2, bfloat16,
seeded random weights, or a trained ``.pth`` given with ``--checkpoint``,
loaded as the test CLI loads it) and prints

- each stage's time (host clock, the device synchronised at each stage's
  start and end): the backbone and the neck (named with their types:
  ResNet and FPN, or HRNet and HRFPN), RPN and proposals (with its NMS), the
  RoIAlign kernel of the route (B1, under the block rule for ``block``
  and under the strip rule for ``pallas``), each RoI head (a cascade's
  stage by stage), the R-CNN multi-class NMS (soft-NMS in the LOFT
  configs), and the rest;
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
from ..models.detectors import cascade_rcnn, two_stage

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..",
                      "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
# the detector modules whose functions the stages patch
DETECTOR_MODULES = (two_stage, cascade_rcnn)


def roi_heads(model):
    """``(name, module)`` of every RoI head: a cascade's stage heads one by
    one (``bbox_head.<i>``)."""
    for name, m in model.roi_head.items():
        if isinstance(m, torch.nn.ModuleList):
            yield from ((f"{name}.{i}", h) for i, h in enumerate(m))
        else:
            yield name, m


def trunk(model):
    """The backbone and the neck, named with their types (``backbone
    (HRNet)``)."""
    return {f"{k} ({type(m).__name__})": m
            for k, m in (("backbone", model.backbone), ("neck", model.neck))}


def patch_functions(names, totals):
    """Time each function ``names`` keys in every detector module that
    uses it; returns what :func:`restore_functions` puts back."""
    saved = []
    for mod in DETECTOR_MODULES:
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


def stage_times(model, batch, reps=3):
    """Mean over ``reps`` calls: ``{stage: ms}`` and the total ms a call."""
    totals = collections.defaultdict(float)
    patched = {
        "_rpn_and_proposals": ("rpn+proposals", model._rpn_and_proposals),
    }
    for attr, (name, fn) in patched.items():
        setattr(model, attr, _timed(name, fn, totals))
    heads = {**trunk(model), **dict(roi_heads(model))}
    for k, m in heads.items():
        m.forward = _timed(k, m.forward, totals)
    nms = dict(model.test_cfg["rcnn"].get("nms", {})).get("type", "nms")
    saved = patch_functions(
        {"roi_align_block": "roi_align_block (B1)",
         "roi_align_fused": "roi_align_fused (B1, strip rule)",
         "multiclass_nms": f"rcnn multiclass {nms}"}, totals)
    try:
        wall = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.simple_test(*batch)
            torch.cuda.synchronize()
            wall += (time.perf_counter() - t0) * 1e3
    finally:
        for attr in patched:
            delattr(model, attr)
        for m in heads.values():
            del m.forward
        restore_functions(saved)
    stages = {k: v / reps for k, v in totals.items()}
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
    model.simple_test(*batch)                         # warm-up
    wall = wall_ms(model, batch)
    stages, staged = stage_times(model, batch)
    print(f"{os.path.basename(args.config)}: "
          f"simple_test 1024^2 B=2 bf16, roi_align_impl="
          f"{model.roi_align_impl}, weights "
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
