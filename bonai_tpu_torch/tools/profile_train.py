"""Where the training time goes on the GPU.

Builds a config (``--config``: the LOFT-FOA R50-FPN config by default, or
another detector the port builds, such as the Mask, Cascade Mask or
Dynamic R-CNN BONAI baselines or LOFT-FOA on HRNet-W32 + HRFPN) for
training with ``train_detector``'s
``build_trainer`` (seeded random float32 weights, channels-last, the
config's SGD and schedule), takes a few steps on the synthetic padded
batch of
:func:`synthetic_batch` (1024^2, B=2, 100 GTs) under bfloat16 autocast,
and prints

- the step time (host clock around a synchronised step, median of 5);
- each stage's time (the device synchronised at each stage's start and
  end): the backbone and the neck (named with their types), the RPN
  head, proposals (with their NMS), the RPN targets and loss, R-CNN assignment and sampling, the RoIAlign forward
  of the route (B1, under the block or the strip rule), each RoI head (a
  cascade's stage by stage), mask targets, the rest of the forward, clip
  + SGD, and what the step leaves after those (the backward, with the
  RoIAlign backward B2 inside);
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
from .profile_serve import (patch_functions, restore_functions, roi_heads,
                            trunk)

CONFIG = os.path.join(os.path.dirname(__file__), "..", "..",
                      "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")


def synthetic_batch(batch=2, size=1024, g=100, m=112, seed=0):
    """The padded batch of ``bench.py``'s training benchmark, from a numpy
    seed: normalised float images, ``g`` GT boxes of 10..``size/5`` px,
    random ``m``^2 instance masks, offsets within +-30 px."""
    r = np.random.RandomState(seed)
    xy1 = r.uniform(0, size * 0.6, (batch, g, 2)).astype(np.float32)
    wh = r.uniform(10, size * 0.2, (batch, g, 2)).astype(np.float32)
    return {
        "image": r.randn(batch, size, size, 3).astype(np.float32),
        "img_shape": np.full((batch, 2), float(size), np.float32),
        "gt_bboxes": np.concatenate([xy1, np.minimum(xy1 + wh, size - 1)],
                                    -1),
        "gt_labels": np.zeros((batch, g), np.int32),
        "gt_valid": np.ones((batch, g), bool),
        "gt_masks": (r.rand(batch, g, m, m) > 0.4).astype(np.uint8),
        "gt_offsets": r.uniform(-30, 30, (batch, g, 2)).astype(np.float32)}


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


def stage_times(model, train_step, batch, draw, reps=3):
    """Mean over ``reps`` steps: ``{stage: ms}`` and the total ms a step.
    The backward is what the step's total leaves after the forward and
    the update."""
    totals = collections.defaultdict(float)
    patched = {"forward_train": "forward"}
    for attr, name in patched.items():
        setattr(model, attr, _timed(name, getattr(model, attr), totals))
    heads = {**trunk(model), "rpn_head": model.rpn_head,
             **dict(roi_heads(model))}
    for name, m in heads.items():
        m.forward = _timed(name, m.forward, totals)
    saved = patch_functions(
        {"rpn_proposals": "proposals (NMS)",
         "rpn_loss": "rpn targets+loss",
         "assign_and_sample_rcnn": "rcnn assign+sample",
         "roi_align_block": "roi_align_block fwd (B1)",
         "roi_align_fused": "roi_align_fused fwd (B1, strip rule)",
         "mask_targets_from_instance_masks": "mask targets"}, totals)
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
        for attr in patched:
            delattr(model, attr)
        for m in heads.values():
            del m.forward
        restore_functions(saved)
        train_step_module.apply_gradients = saved_update
    stages = {k: v / reps for k, v in totals.items()}
    forward = stages.pop("forward")
    # the forward's total holds the stages timed inside it
    stages["forward, rest"] = forward - sum(
        v for k, v in stages.items() if k != "clip+sgd")
    stages["backward (incl. B2) + rest"] = (wall / reps - forward
                                                  - stages["clip+sgd"])
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
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in synthetic_batch().items()}
    train_step(batch, 0, draw)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall = step_ms(train_step, batch, draw)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stages, staged = stage_times(model, train_step, batch, draw)
    print(f"{os.path.basename(args.config)}: "
          f"train step 1024^2 B=2 bf16 autocast, roi_align_impl="
          f"{model.roi_align_impl}: {wall:.1f} ms (median of "
          f"5), peak memory {peak:.2f} GiB; stage times (synchronised at "
          f"each stage), {staged:.1f} ms a step:")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {ms:9.2f} ms  {100 * ms / staged:5.1f} %")
    kernels, rows = profile(train_step, batch, draw)
    print(f"profiler: CUDA kernels {kernels:.1f} ms a step, device idle "
          f"{100 * (1 - kernels / wall):.1f} % of the {wall:.1f} ms step")
    for ms, count, key in rows[:20]:
        print(f"  {ms:9.2f} ms  {count:7d}x  {key[:90]}")


if __name__ == "__main__":
    main()
