"""Micro-benchmark of the port's RoIAlign routes at the shapes of the LOFT
train step at 1024x1024, batch 2 (counterpart of
``tools/bench_roi_align.py`` at its defaults), C=256, bfloat16, sampling
ratio 2:

  bbox branch:   R=2048 RoIs, out 7x7
  mask branch:   R=512  RoIs, out 14x14
  offset branch: R=512  RoIs, out 7x7

Routes: ``gather`` (``multilevel_roi_align``, plain PyTorch), ``blocked``
(``roi_align_blocked``, plain PyTorch), ``pallas`` (``roi_align_strip``:
the window-64 strip kernel, forward only) and ``fused``
(``roi_align_fused``: the strip kernels' forward and backward).  For each
it prints the forward and the forward + backward time per call (CUDA
events over ``--iters`` calls after one warm-up); a route without a
gradient prints why.  Needs a CUDA device:

    python -m bonai_tpu_torch.tools.bench_roi_align [--iters 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

STRIDES = [4, 8, 16, 32]


def _time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    """Runs the benchmark; returns ``{(route, branch): (fwd_ms,
    fwd_bwd_ms or None)}``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roi_align times CUDA kernels: no CUDA device")
    from ..ops import (multilevel_roi_align, roi_align_blocked,
                       roi_align_fused, roi_align_strip)
    routes = {"gather": multilevel_roi_align, "blocked": roi_align_blocked,
              "pallas": roi_align_strip, "fused": roi_align_fused}

    B, S, C = 2, 1024, 256
    r = np.random.RandomState(0)
    feats = [torch.from_numpy(r.randn(B, S // s, S // s, C)).to(
        device="cuda", dtype=torch.bfloat16) for s in STRIDES]

    def rois_of(n, lo=32, hi=448):
        xy1 = r.uniform(0, S - hi, (n, 2))
        wh = r.uniform(lo, hi, (n, 2))
        b = r.randint(0, B, (n, 1))
        return torch.from_numpy(np.concatenate([b, xy1, xy1 + wh], -1)).to(
            device="cuda", dtype=torch.float32)

    branches = [("bbox", rois_of(2048), 7), ("mask", rois_of(512), 14),
                ("offset", rois_of(512), 7)]
    print(f"bench_roi_align: {torch.cuda.get_device_name(0)}, B={B}, "
          f"{S}^2, C={C}, bfloat16, {args.iters} calls", flush=True)
    results = {}
    for name, fn in routes.items():
        for bname, rois, osz in branches:
            def fwd():
                with torch.no_grad():
                    return fn(feats, rois, osz, STRIDES, sampling_ratio=2)
            tf = _time_ms(fwd, args.iters)
            line = f"{name:8s} {bname:7s} fwd {tf:8.3f} ms"
            levels = [f.detach().requires_grad_() for f in feats]

            def fwd_bwd():
                out = fn(levels, rois, osz, STRIDES, sampling_ratio=2)
                return torch.autograd.grad(out.float().square().sum(), levels)
            try:
                tg = _time_ms(fwd_bwd, args.iters)
                line += f"   fwd+bwd {tg:8.3f} ms"
            except RuntimeError as e:   # only B5, which has no gradient
                if fn is not roi_align_strip or "not differentiable" not in \
                        str(e):
                    raise
                tg = None
                line += f"   bwd FAILED: {type(e).__name__}: {str(e)[:160]}"
            results[name, bname] = (tf, tg)
            print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
