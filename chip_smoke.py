#!/usr/bin/env python3
"""Drives the bonai_tpu_torch serving path on one NVIDIA GPU and checks it.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build: every CUDA kernel of the path, from ``bonai_tpu_torch/csrc``, one
   ``nvcc`` per source, started together.
2. kernels: each kernel's wrapper at the shapes the serving path gives it
   (the block RoIAlign forward: bbox R=6000 at 7x7, mask R=4000 at 14x14,
   offset R=4000 at 7x7; C=256; float32 and bfloat16; pushed, border and
   invalid RoIs) against its plain PyTorch version: max abs error, kernel
   time (CUDA events, warm), plain time and the least time the card could
   take (the bound).
3. serve: ``init_detector`` on ``configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py``
   at full width with seeded random weights in bfloat16; two batched
   ``simple_test`` calls at 1024^2 with B=2 and one ``inference_detector``
   call on a random BGR image.  Launch counts are zeroed just before and
   read just after; outputs must be finite and of the right shapes, and a
   small float32 input must agree with the same model run through the
   kernels' plain versions.

Prints the card's name and power limit, the kernels' JSON line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside the repository.
"""

import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BATCH, SIZE, C = 2, 1024, 256
BRANCHES = (("bbox", 6000, 7), ("mask", 4000, 14), ("offset", 4000, 7))
STRIDES = [4, 8, 16, 32]


def _gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rois(n, gen):
    """Proposal-like RoIs on a 1024^2 tile: log-uniform sizes 4..700 px,
    one in twenty wide and flat (the block rule pushes those coarser),
    boxes over the border, one in ten invalid."""
    import torch
    c = torch.rand(n, 2, generator=gen) * SIZE
    wh = torch.exp(torch.empty(n, 2).uniform_(1.4, 6.55, generator=gen))
    flat = torch.rand(n, generator=gen) < 0.05
    wh[flat] = torch.stack([wh[flat, 0].clamp(min=200),
                            wh[flat, 0].clamp(min=200) / 8], 1)
    boxes = torch.cat([c - wh / 2, c + wh / 2], 1).clamp(-50, SIZE + 50)
    b = torch.randint(0, BATCH, (n, 1), generator=gen).float()
    valid = torch.rand(n, generator=gen) > 0.1
    return torch.cat([b, boxes], 1).cuda(), valid.cuda()


def kernel_phase():
    """The block RoIAlign kernel against its plain version at the serving
    shapes.  Returns its entry of the kernels line (per-batch sums over the
    three branches, bfloat16 as the serving path runs it)."""
    import torch
    from bonai_tpu_torch.ops.roi_align_block import (block_levels,
                                                     roi_align_block,
                                                     roi_align_block_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    levels32 = [torch.randn(BATCH, SIZE // s, SIZE // s, C, generator=gen)
                .cuda() for s in STRIDES]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype) for f in levels32]
        level_bytes = sum(f.numel() * f.element_size() for f in levels)
        for name, n, size in BRANCHES:
            rois, valid = _rois(n, gen)
            args = (levels, rois, size, STRIDES)
            got = roi_align_block(*args, roi_valid=valid)
            torch.cuda.synchronize()
            ref = roi_align_block_ref(*args, roi_valid=valid)
            diff = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= 1e-4 + 1e-4 * ref.abs()).all())
            else:       # one bf16 ulp relative
                ok = bool((diff <= ref.float().abs() * 2 ** -7 + 1e-6).all())
            pushed = int((block_levels(rois[:, 1:5], STRIDES)
                          > block_levels(rois[:, 1:5], STRIDES,
                                         window=10 ** 9)).sum())
            ms = _time_ms(lambda: roi_align_block(*args, roi_valid=valid), 20)
            plain_ms = _time_ms(
                lambda: roi_align_block_ref(*args, roi_valid=valid), 3)
            nbytes = (level_bytes + rois.numel() * 4 + valid.numel()
                      + got.numel() * got.element_size())
            # 4 corners x (multiply + add) per sample and channel, valid rows
            flops = int(valid.sum()) * size * size * 4 * 4 * 2 * C
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            t_ops = flops / H100_FP32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            print(f"kernel roi_align_block_fwd {str(dtype)[6:]} {name} "
                  f"R={n} {size}x{size}: max_abs_err={float(diff.max()):.3g} "
                  f"within_tol={ok} pushed={pushed} "
                  f"invalid={int((~valid).sum())} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})",
                  flush=True)
            if not ok:
                raise AssertionError(f"roi_align_block_fwd disagrees with "
                                     f"its plain version ({dtype}, {name})")
            if dtype == torch.bfloat16:
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["bound_ms"] += bound
                total["err"] = max(total["err"], float(diff.max()))
                total["bound_by"] = ("bytes" if t_bytes >= t_ops
                                     else "operations")
    return {"name": "roi_align_block_fwd", "route": "cuda",
            "source": "bonai_tpu_torch/csrc/roi_align_block_fwd.cu",
            "replaces": "bonai_tpu/ops/pallas_roi_align_block.py:152",
            "launches": None, "max_abs_err": total["err"],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
            "library_ms": None}


def _check_outputs(out, b, p):
    import torch
    shapes = {"det_bboxes": (b, p, 4), "det_scores": (b, p),
              "det_labels": (b, p), "det_valid": (b, p),
              "mask_probs": (b, p, 28, 28), "offsets": (b, p, 2)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)}, "
                                 f"expected {shape}")
        if out[key].is_floating_point() and not bool(
                torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    if not int(out["det_valid"].sum()):
        raise AssertionError("no valid detections")


def serve_phase():
    """Full-width LOFT-FOA R50-FPN serving through the port's entry points.
    Returns the launch counts of the run."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import (inference_detector, init_detector,
                                      prepare_batch)
    from bonai_tpu_torch.models.detectors import two_stage
    from bonai_tpu_torch.ops.roi_align_block import (roi_align_block,
                                                     roi_align_block_ref)

    t0 = time.time()
    model = init_detector(CONFIG, seed=0)      # cuda, bfloat16
    print(f"serve: init_detector {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"dtype {next(model.parameters()).dtype}", flush=True)
    max_per_img = model.test_cfg["rcnn"]["max_per_img"]
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(BATCH)]
    img, img_shape, scale, _ = prepare_batch(model, imgs)
    model.simple_test(img, img_shape, scale)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    roi_align_block.launches = 0
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.simple_test(img, img_shape, scale)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_outputs(out, BATCH, max_per_img)
    after_batches = roi_align_block.launches
    t0 = time.perf_counter()
    bbox, segm, offsets = inference_detector(
        model, r.randint(0, 256, (512, 640, 3), np.uint8))
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = roi_align_block.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: simple_test 1024^2 B={BATCH} ms per call "
          f"{[round(x, 1) for x in times]}, ms per image "
          f"{[round(x / BATCH, 1) for x in times]}; valid detections "
          f"{out['det_valid'].sum(1).tolist()}", flush=True)
    print(f"serve: inference_detector 512x640 -> 819x1024 incl. host "
          f"paste+RLE {single_ms:.1f} ms, {len(bbox[0])} detections; "
          f"peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)", flush=True)
    if after_batches != 3 * 2 or launches != 3 * 3:
        raise AssertionError(f"roi_align_block_fwd launched {after_batches} "
                             f"times in 2 batches and {launches} in all; "
                             f"3 per batch expected")
    if not (len(bbox[0]) == len(segm[0]) == len(offsets)
            and np.isfinite(bbox[0]).all() and np.isfinite(offsets).all()):
        raise AssertionError("inference_detector results are inconsistent")

    # a small float32 input: the three RoI branches' head outputs on the
    # model's own proposals, through the kernel and through its plain
    # version (same level rule and arithmetic; no NMS in between, so
    # float noise cannot reorder anything)
    model.float()
    small = [r.randint(0, 256, (256, 320, 3), np.uint8) for _ in range(2)]
    model.cfg.data.test.pipeline[1].img_scale = (320, 320)
    img, img_shape, _, _ = prepare_batch(model, small)
    with torch.inference_mode():
        feats = model.extract_feat(img)
        props, _, pvalid = model._rpn_and_proposals(
            feats, img_shape, dict(model.test_cfg["rpn"]))
        rois, rvalid = two_stage.boxes_to_rois(props, pvalid)
        for ext, head in (("bbox_extractor_cfg", "bbox_head"),
                          ("mask_extractor_cfg", "mask_head"),
                          ("offset_extractor_cfg", "offset_head")):
            def run():
                out = model.roi_head[head](model._roi_align_cfg(
                    getattr(model, ext), feats, rois, rvalid))
                return out if isinstance(out, tuple) else (out,)
            got = run()
            try:
                two_stage.roi_align_block = roi_align_block_ref
                ref = run()
            finally:
                two_stage.roi_align_block = roi_align_block
            err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
            scale = max(float(e.abs().max()) for e in ref)
            print(f"serve: small float32 input, {head} through the kernel "
                  f"vs its plain version: max abs diff {err:.3g} "
                  f"(outputs up to {scale:.3g})", flush=True)
            if not err <= 1e-4 * max(scale, 1.0):
                raise AssertionError(f"small input: {head} differs from "
                                     f"the plain path by {err}")
    return {"roi_align_block_fwd": launches}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bonai_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from bonai_tpu_torch.ops import _build

    card = _gpu_name_and_power()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.time()
    kernels = ["roi_align_block_fwd"]
    _build.build(kernels)
    print(f"build: {len(kernels)} kernel(s) in {time.time() - t0:.1f} s",
          flush=True)
    for name in kernels:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    entry = kernel_phase()
    counts = serve_phase()
    entry["launches"] = counts[entry["name"]]
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:               # any failed phase: no result line
        traceback.print_exc()
        sys.exit(1)
