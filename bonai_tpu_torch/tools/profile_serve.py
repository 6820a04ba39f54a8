"""Where the serving time goes on the GPU.

Runs ``simple_test`` of the LOFT-FOA R50-FPN config (1024^2, B=2,
bfloat16, seeded random weights) and prints

- each stage's time (host clock, the device synchronised at each stage's
  start and end): backbone+FPN, RPN and proposals (with its NMS), the
  RoIAlign kernel of the route (B1, under the block rule for ``block``
  and under the strip rule for ``pallas``), the
  three RoI heads, the R-CNN multi-class soft-NMS, and the rest;
- from ``torch.profiler`` over one call: the summed CUDA kernel time, the
  device's idle share against the wall time of an unprofiled call, and
  the kernels that take the most time.

Needs a CUDA device.  Run from the repository root:

    python -m bonai_tpu_torch.tools.profile_serve [--roi-align-impl pallas]
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
from ..models.detectors import two_stage

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..",
                      "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")


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
        "extract_feat": ("backbone+fpn", model.extract_feat),
        "_rpn_and_proposals": ("rpn+proposals", model._rpn_and_proposals),
    }
    for attr, (name, fn) in patched.items():
        setattr(model, attr, _timed(name, fn, totals))
    for k, m in model.roi_head.items():
        m.forward = _timed(k, m.forward, totals)
    names = {"roi_align_block": "roi_align_block (B1)",
             "roi_align_fused": "roi_align_fused (B1, strip rule)",
             "multiclass_nms": "rcnn multiclass soft-nms"}
    saved = {k: getattr(two_stage, k) for k in names}
    for k, name in names.items():
        setattr(two_stage, k, _timed(name, saved[k], totals))
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
        for m in model.roi_head.values():
            del m.forward
        for k, fn in saved.items():
            setattr(two_stage, k, fn)
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
    parser.add_argument("--roi-align-impl", default=None,
                        help="RoIAlign route (default: the config's)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    cfg = Config.fromfile(CONFIG)
    if args.roi_align_impl:
        cfg.model.roi_align_impl = args.roi_align_impl
    model = init_detector(cfg, seed=0)
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (1024, 1024, 3), np.uint8) for _ in range(2)]
    batch = prepare_batch(model, imgs)[:3]
    model.simple_test(*batch)                         # warm-up
    wall = wall_ms(model, batch)
    stages, staged = stage_times(model, batch)
    print(f"simple_test 1024^2 B=2 bf16, roi_align_impl="
          f"{model.roi_align_impl}: {wall:.1f} ms a call; stage "
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
