#!/usr/bin/env python3
"""Drives the bonai_tpu_torch serving and training paths on one NVIDIA GPU
and checks them.

Run from the repository root, on a machine with a CUDA device and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which must pass:

1. build: every CUDA kernel of the paths, from ``bonai_tpu_torch/csrc``,
   one ``nvcc`` per source, started together.
2. kernels: each kernel's wrapper at the shapes the paths give it, against
   its plain PyTorch version, in float32 and bfloat16, with pushed, border
   and invalid RoIs: max abs error, kernel time (CUDA events, warm), plain
   time and the least time the card could take (the bound).  Serving
   shapes: bbox R=6000 at 7x7, mask R=4000 at 14x14, offset R=4000 at 7x7;
   training shapes: bbox R=2048 at 7x7, mask R=512 at 14x14, offset R=512
   at 7x7; C=256.  Each forward and its backward run on the same RoIs.
   - B1, the block RoIAlign forward, and B3, the strip one
     (``roi_align_impl='pallas'``), at the serving and training shapes;
   - B2 and B4, their backwards, at the training shapes, against autograd
     through the plain versions;
   - B5, the forward-only window-64 strip RoIAlign, at the training shapes.
3. serve: ``init_detector`` on ``configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py``
   at full width with seeded random weights in bfloat16, once with its
   ``roi_align_impl='block'`` and once with ``'pallas'``; two batched
   ``simple_test`` calls at 1024^2 with B=2 and one ``inference_detector``
   call on a random BGR image each.  Outputs must be finite and of the
   right shapes, and a small float32 input must agree with the same model
   run through the kernels' plain versions.
4. train: ``train_detector`` on the same config at full width, seeded
   random float32 weights, bfloat16 autocast, the config's train settings
   and optimizer, on a synthetic padded batch (B=2, 1024^2, 100 GTs, 112^2
   masks, offsets within +-30 px): 1 warm-up and 5 timed steps with
   ``'block'``, 1 and 3 with ``'pallas'``.  Every loss and gradient norm
   must be finite and the trainable weights must move.  On a small float32
   input, the FPN-level gradients of the RoI branches' losses through the
   kernels must agree with the plain path.
5. bench: ``bonai_tpu_torch.tools.bench_roi_align.main(["--iters", "3"])``,
   the entry point of B5.

Every launch count is zeroed just before each serve, train and bench run
and read just after: the route's forward kernel must launch 3 times per
batch or step, its backward kernel 3 times per training step, no other
kernel at all; the bench must launch B5.

Prints the card's name and power limit, the kernels' JSON line, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside the repository.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BATCH, SIZE, C = 2, 1024, 256
SERVE_BRANCHES = (("bbox", 6000, 7), ("mask", 4000, 14), ("offset", 4000, 7))
TRAIN_BRANCHES = (("bbox", 2048, 7), ("mask", 512, 14), ("offset", 512, 7))
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


def _bound_ms(nbytes, flops):
    """The least time for ``nbytes`` of device memory traffic and
    ``flops`` float32 operations, and which of the two sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _rois(n, gen):
    """Proposal-like RoIs on a 1024^2 tile: log-uniform sizes 4..700 px,
    one in twenty wide and flat (the block and strip rules push those
    coarser), boxes over the border, one in ten invalid."""
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


class _Sums:
    """Per-batch sums of one kernel's numbers over the three branches."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.err = 0.0
        self.bound_by = None

    def add(self, ms, plain_ms, bound, bound_by, err):
        self.ms += ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.err = max(self.err, err)
        self.bound_by = bound_by


def _kernels():
    """The port's RoIAlign kernels: name -> (wrapper, which counts the
    kernel's launches; plain version of the function; level rule, or
    ``None`` for the gather rule)."""
    from bonai_tpu_torch.ops import (block_levels, roi_align_block,
                                     roi_align_block_backward,
                                     roi_align_block_ref, roi_align_fused,
                                     roi_align_fused_backward,
                                     roi_align_fused_ref, roi_align_strip,
                                     roi_align_strip_ref, strip_levels)
    return {
        "roi_align_block_fwd": (roi_align_block, roi_align_block_ref,
                                block_levels),
        "roi_align_fused_fwd": (roi_align_fused, roi_align_fused_ref,
                                strip_levels),
        "roi_align_strip_fwd": (roi_align_strip, roi_align_strip_ref, None),
        "roi_align_block_bwd": (roi_align_block_backward,
                                roi_align_block_ref, block_levels),
        "roi_align_fused_bwd": (roi_align_fused_backward,
                                roi_align_fused_ref, strip_levels),
    }


def _zero_counts():
    for fn, _, _ in _kernels().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, (fn, _, _) in _kernels().items()}


def _check_counts(counts, expected, what):
    """``counts`` must equal ``expected`` for the named kernels and be 0
    for every other."""
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want}")


def _cells_read(name, shapes, rois, size, valid):
    """The distinct level cells that forward kernel ``name`` must read for
    these RoIs: the corners of nonzero weight of the valid RoIs' samples
    (B5's window-cut corners have weight zero)."""
    import torch
    from bonai_tpu_torch.ops.roi_align import corner_plan
    from bonai_tpu_torch.ops.roi_align_strip import strip_corner_plan
    level_rule = _kernels()[name][2]
    if level_rule is None:
        corners, weights = strip_corner_plan(shapes, rois, size, STRIDES)
        weights = [w * valid[:, None, None] for w in weights]
    else:
        corners, weights = corner_plan(
            shapes, rois, level_rule(rois[:, 1:5], STRIDES), size, STRIDES,
            roi_valid=valid)
    return int(torch.unique(torch.cat(
        [c[w != 0] for c, w in zip(corners, weights)])).numel())


def _forward_kernel(name, levels32, branches, seed, label):
    """One forward kernel against its plain version; returns the bfloat16
    per-batch sums.  ``seed`` draws the RoIs (the same seed, the same RoIs
    for every kernel).  The bound's bytes are the level cells this run's
    RoIs read (``_cells_read``), the RoIs and the output."""
    import torch
    fn, ref_fn, level_rule = _kernels()[name]
    gen = torch.Generator().manual_seed(seed)
    sums = _Sums()
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype) for f in levels32]
        shapes = [tuple(f.shape) for f in levels]
        cell_bytes = C * levels[0].element_size()
        for branch, n, size in branches:
            rois, valid = _rois(n, gen)
            args = (levels, rois, size, STRIDES)
            with torch.no_grad():
                got = fn(*args, roi_valid=valid)
                torch.cuda.synchronize()
                ref = ref_fn(*args, roi_valid=valid)
            diff = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= 1e-4 + 1e-4 * ref.abs()).all())
            else:       # one bf16 ulp relative
                ok = bool((diff <= ref.float().abs() * 2 ** -7 + 1e-6).all())
            pushed = "" if level_rule is None else " pushed=%d" % int((
                level_rule(rois[:, 1:5], STRIDES)
                > level_rule(rois[:, 1:5], STRIDES, window=10 ** 9)).sum())

            def kernel():
                with torch.no_grad():
                    return fn(*args, roi_valid=valid)

            def plain():
                with torch.no_grad():
                    return ref_fn(*args, roi_valid=valid)
            ms = _time_ms(kernel, 20)
            plain_ms = _time_ms(plain, 3)
            cells = _cells_read(name, shapes, rois, size, valid)
            nbytes = (cells * cell_bytes + rois.numel() * 4 + valid.numel()
                      + got.numel() * got.element_size())
            # 4 corners x (multiply + add) per sample and channel, valid rows
            flops = int(valid.sum()) * size * size * 4 * 4 * 2 * C
            bound, bound_by = _bound_ms(nbytes, flops)
            print(f"kernel {name} {label} {str(dtype)[6:]} "
                  f"{branch} R={n} {size}x{size}: "
                  f"max_abs_err={float(diff.max()):.3g} within_tol={ok}"
                  f"{pushed} invalid={int((~valid).sum())} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by}; {cells} cells read)", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({label}, {dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, plain_ms, bound, bound_by, float(diff.max()))
    return sums


def _backward_kernel(name, levels32, seed):
    """One backward kernel at the training shapes against autograd through
    the plain version; returns the bfloat16 per-step sums."""
    import torch
    fn, ref_fn, level_rule = _kernels()[name]
    gen = torch.Generator().manual_seed(seed)
    sums = _Sums()
    for dtype in (torch.float32, torch.bfloat16):
        levels = [f.to(dtype, copy=True).requires_grad_()
                  for f in levels32]
        shapes = [tuple(f.shape) for f in levels]
        grad_bytes = sum(f.numel() * f.element_size() for f in levels)
        for branch, n, size in TRAIN_BRANCHES:
            rois, valid = _rois(n, gen)
            lvl = level_rule(rois[:, 1:5], STRIDES).to(torch.int32)
            cot = torch.randn(n, size, size, C, generator=gen).to(
                device="cuda", dtype=dtype)

            def kernel():
                return fn(cot, shapes, STRIDES, rois, lvl, valid)
            got = kernel()
            torch.cuda.synchronize()
            out = ref_fn(levels, rois, size, STRIDES, roi_valid=valid)

            def plain():
                return torch.autograd.grad(out, levels, cot,
                                           retain_graph=True)
            ref = plain()
            ok, err = True, 0.0
            for g, e in zip(got, ref):
                top = float(e.float().abs().max())
                diff = (g.float() - e.float()).abs()
                err = max(err, float(diff.max()))
                if dtype == torch.float32:      # 1e-4 of the level's largest
                    ok &= float(diff.max()) <= 1e-4 * top
                else:       # one bf16 ulp, plus float32 summation order
                    ok &= bool((diff <= e.float().abs() * 2 ** -7
                                + 1e-5 * top).all())
            ms = _time_ms(kernel, 20)
            plain_ms = _time_ms(plain, 3)
            # the output gradient read once, the level gradients written once
            nbytes = (cot.numel() * cot.element_size() + grad_bytes
                      + rois.numel() * 4 + lvl.numel() * 4 + valid.numel())
            # 4 corners x (multiply + add) per sample and channel, valid rows
            flops = int(valid.sum()) * size * size * 4 * 4 * 2 * C
            bound, bound_by = _bound_ms(nbytes, flops)
            print(f"kernel {name} train {str(dtype)[6:]} {branch} "
                  f"R={n} {size}x{size}: max_abs_err={err:.3g} "
                  f"within_tol={ok} invalid={int((~valid).sum())} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by})", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, plain_ms, bound, bound_by, err)
            del out
    return sums


def kernel_phase():
    """Every kernel against its plain version.  Returns the bfloat16
    per-batch (per-step) sums by kernel: ``(name, "serve")`` and ``(name,
    "train")`` for the forwards, ``(name, "train")`` for the backwards.
    The forwards of one set of shapes, and the backwards, share their
    RoIs."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    levels32 = [torch.randn(BATCH, SIZE // s, SIZE // s, C, generator=gen)
                .cuda() for s in STRIDES]
    sums = {}
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd"):
        sums[name, "serve"] = _forward_kernel(name, levels32, SERVE_BRANCHES,
                                              1, "serve")
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd",
                 "roi_align_strip_fwd"):
        sums[name, "train"] = _forward_kernel(name, levels32, TRAIN_BRANCHES,
                                              2, "train")
    for name in ("roi_align_block_bwd", "roi_align_fused_bwd"):
        sums[name, "train"] = _backward_kernel(name, levels32, 3)
    return sums


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


# per route: the detector module's name of the wrapper, its forward and
# backward kernels
ROUTES = {"block": ("roi_align_block", "roi_align_block_fwd",
                    "roi_align_block_bwd"),
          "pallas": ("roi_align_fused", "roi_align_fused_fwd",
                     "roi_align_fused_bwd")}


def _config(impl):
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(CONFIG)
    cfg.model.roi_align_impl = impl
    return cfg


def _plain_route(impl):
    """The plain version of route ``impl``'s wrapper, taking the wrapper's
    arguments."""
    ref_fn = _kernels()[ROUTES[impl][1]][1]

    def plain(levels, rois, output_size, featmap_strides, backward=None,
              **kw):
        return ref_fn(levels, rois, output_size, featmap_strides, **kw)
    return plain


def serve_phase(impl):
    """Full-width LOFT-FOA R50-FPN serving through the port's entry points
    with ``roi_align_impl=impl``.  Returns the forward kernel's launch count
    of the run."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import (inference_detector, init_detector,
                                      prepare_batch)
    from bonai_tpu_torch.models.detectors import two_stage
    attr, fwd_name, _ = ROUTES[impl]

    t0 = time.time()
    model = init_detector(_config(impl), seed=0)      # cuda, bfloat16
    print(f"serve ({impl}): init_detector {time.time() - t0:.1f} s, "
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

    _zero_counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.simple_test(img, img_shape, scale)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_outputs(out, BATCH, max_per_img)
    _check_counts(_counts(), {fwd_name: 3 * 2}, f"serve ({impl}), 2 batches")
    t0 = time.perf_counter()
    bbox, segm, offsets = inference_detector(
        model, r.randint(0, 256, (512, 640, 3), np.uint8))
    single_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve ({impl}): simple_test 1024^2 B={BATCH} ms per call "
          f"{[round(x, 1) for x in times]}, ms per image "
          f"{[round(x / BATCH, 1) for x in times]}; valid detections "
          f"{out['det_valid'].sum(1).tolist()}", flush=True)
    print(f"serve ({impl}): inference_detector 512x640 -> 819x1024 incl. "
          f"host paste+RLE {single_ms:.1f} ms, {len(bbox[0])} detections; "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"launches {counts}", flush=True)
    _check_counts(counts, {fwd_name: 3 * 3}, f"serve ({impl}), 3 batches")
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
    kernel_fn = getattr(two_stage, attr)
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
            launched = kernel_fn.launches
            got = run()
            if kernel_fn.launches != launched + 1:
                raise AssertionError(f"small input: {head} did not run "
                                     f"{fwd_name}")
            try:
                setattr(two_stage, attr, _plain_route(impl))
                ref = run()
            finally:
                setattr(two_stage, attr, kernel_fn)
            err = max(float((g - e).abs().max()) for g, e in zip(got, ref))
            scale = max(float(e.abs().max()) for e in ref)
            print(f"serve ({impl}): small float32 input, {head} through the "
                  f"kernel vs its plain version: max abs diff {err:.3g} "
                  f"(outputs up to {scale:.3g})", flush=True)
            if not err <= 1e-4 * max(scale, 1.0):
                raise AssertionError(f"small input: {head} differs from "
                                     f"the plain path by {err}")
    return counts[fwd_name]


def _roi_grad_check(model, impl):
    """On a small float32 input, one step's RoI branches: the FPN-level
    gradients of their losses through the kernels against the plain
    version's backward fed the same output gradients (the heads between
    them are the same run, so a ReLU flipped by float noise cannot differ
    between the two).  The two sum each level cell's contributions in
    another order, so each element is held to 1e-4 of the sum of its
    contributions' magnitudes (the plain backward of the output
    gradients' magnitudes: the bilinear weights are not negative).  The
    branches' contributions cancel to a net gradient far smaller than
    that sum, which a bound on the net gradient alone ignores."""
    import torch
    from bonai_tpu_torch.core.samplers import generator_draws
    from bonai_tpu_torch.models.detectors import two_stage
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    attr, fwd_name, bwd_name = ROUTES[impl]
    kernel_fn = getattr(two_stage, attr)
    plain = _plain_route(impl)
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in synthetic_batch(size=320, g=12, seed=1).items()}
    with torch.no_grad():
        feats = [f.detach().requires_grad_()
                 for f in model.extract_feat(batch["image"])]
        props, _, pvalid = model._rpn_and_proposals(
            feats, batch["img_shape"], dict(model.train_cfg["rpn_proposal"]))
    calls = []

    def recorded(levels, rois, output_size, featmap_strides, **kw):
        out = kernel_fn(levels, rois, output_size, featmap_strides, **kw)
        out.retain_grad()
        calls.append((rois, output_size, kw, out))
        return out

    _zero_counts()
    try:
        setattr(two_stage, attr, recorded)
        losses = model._roi_forward_train(
            feats, props, pvalid, batch,
            generator_draws(torch.Generator(device="cuda").manual_seed(0)))
    finally:
        setattr(two_stage, attr, kernel_fn)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    _check_counts(_counts(), {fwd_name: 3, bwd_name: 3},
                  f"train ({impl}), small input")
    levels = [f.detach().requires_grad_() for f in feats[:len(STRIDES)]]
    mags = [f.detach().requires_grad_() for f in feats[:len(STRIDES)]]
    for rois, output_size, kw, out in calls:
        ref = plain(levels, rois, output_size, STRIDES, **kw)
        err = float((out - ref).abs().max())
        if not err <= 1e-4 * max(float(ref.abs().max()), 1.0):
            raise AssertionError(f"small input: RoI features differ from "
                                 f"the plain version by {err}")
        ref.backward(out.grad)
        plain(mags, rois, output_size, STRIDES, **kw).backward(
            out.grad.abs())
    for s, f, e, m in zip(STRIDES, feats, levels, mags):
        diff = (f.grad - e.grad).abs()
        top = float(e.grad.abs().max())
        ratio = float((diff / m.grad.clamp(min=1e-30)).max())
        print(f"train ({impl}): small float32 input, FPN stride {s} "
              f"gradient of the RoI losses through the kernels vs the plain "
              f"version: max abs diff {float(diff.max()):.3g} (gradients up "
              f"to {top:.3g}, sums of contribution magnitudes up to "
              f"{float(m.grad.max()):.3g}; largest diff over its element's "
              f"sum {ratio:.3g})", flush=True)
        if not bool((diff <= 1e-4 * m.grad).all()):
            raise AssertionError(f"small input: the stride-{s} gradient "
                                 f"differs from the plain path by "
                                 f"{ratio:.3g} of an element's sum")
    if not float(levels[0].grad.abs().max()) > 0:
        raise AssertionError("small input: no gradient reached the FPN")


def train_phase(impl, steps):
    """Full-width LOFT-FOA R50-FPN training through ``train_detector`` with
    ``roi_align_impl=impl`` for ``steps`` steps (1 warm-up).  Returns the
    forward and backward kernels' launch counts of the run and the median
    warm step time."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.models.builder import build_detector
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    _, fwd_name, bwd_name = ROUTES[impl]

    cfg = _config(impl)
    batch = synthetic_batch()
    work_dir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    # one epoch of `steps` copies of the batch: no epoch checkpoint falls
    # between the timed steps
    model, hist = train_detector(cfg, [batch] * steps, work_dir, seed=0,
                                 max_steps=steps, log_interval=1)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    step_ms = [h["time"] * 1e3 for h in hist]
    print(f"train ({impl}): train_detector 1024^2 B={BATCH} bf16 autocast, "
          f"{steps} steps in {wall:.1f} s incl. set-up and the final "
          f"checkpoint; ms per step {[round(x, 1) for x in step_ms]}; "
          f"median of the {len(step_ms) - 1} warm steps "
          f"{statistics.median(step_ms[1:]):.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches "
          f"{counts}", flush=True)
    keys = [k for k in hist[0] if k.startswith("loss")]
    for h in hist:
        print(f"train ({impl}): step {h['iter']} lr {h['lr']:.3g} grad_norm "
              f"{h['grad_norm']:.4g} " + " ".join(
                  f"{k} {h[k]:.5g}" for k in keys), flush=True)
    if not all(np.isfinite(h[k]) for h in hist
               for k in keys + ["grad_norm"]):
        raise AssertionError("a loss or the gradient norm is not finite")
    _check_counts(counts, {fwd_name: 3 * steps, bwd_name: 3 * steps},
                  f"train ({impl}), {steps} steps")
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    start = dict(init.named_parameters())
    moved = frozen_moved = trainable = 0
    for name, p in model.named_parameters():
        changed = not torch.equal(p.detach().cpu(), start[name].detach())
        if p.requires_grad:
            trainable += 1
            moved += changed
        else:
            frozen_moved += changed
    print(f"train ({impl}): {moved} of {trainable} trainable parameter "
          f"tensors moved, {frozen_moved} frozen ones moved", flush=True)
    if moved != trainable or frozen_moved:
        raise AssertionError("the trainable weights did not all move, or "
                             "a frozen one did")
    shutil.rmtree(work_dir, ignore_errors=True)

    _roi_grad_check(model, impl)
    return {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
            "step_ms": statistics.median(step_ms[1:])}


def bench_phase():
    """The RoIAlign micro-benchmark, B5's entry point.  Returns B5's launch
    count of the run."""
    from bonai_tpu_torch.tools.bench_roi_align import main as bench
    _zero_counts()
    results = bench(["--iters", "3"])
    counts = _counts()
    print(f"bench: launches {counts}", flush=True)
    if not counts["roi_align_strip_fwd"]:
        raise AssertionError("bench_roi_align did not launch "
                             "roi_align_strip_fwd")
    for (route, branch), (fwd_ms, fwd_bwd_ms) in results.items():
        if (fwd_bwd_ms is None) != (route == "pallas") or not fwd_ms > 0:
            raise AssertionError(f"bench_roi_align {route} {branch}: fwd "
                                 f"{fwd_ms} ms, fwd+bwd {fwd_bwd_ms} ms")
    if len(results) != 4 * 3:
        raise AssertionError(f"bench_roi_align timed {sorted(results)}")
    return counts["roi_align_strip_fwd"]


def _entry(name, source, replaces, path, launches, sums, **extra):
    return {"name": name, "route": "cuda",
            "source": f"bonai_tpu_torch/csrc/{source}",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": sums.err, "ms": sums.ms,
            "plain_ms": sums.plain_ms, "bound_ms": sums.bound_ms,
            "bound_by": sums.bound_by, "library_ms": None, **extra}


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
    kernels = list(_kernels())
    _build.build(kernels)
    print(f"build: {len(kernels)} kernel(s) in {time.time() - t0:.1f} s",
          flush=True)
    for name in kernels:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    sums = kernel_phase()
    serve = {impl: serve_phase(impl) for impl in ("block", "pallas")}
    train = {impl: train_phase(impl, steps)
             for impl, steps in (("block", 6), ("pallas", 4))}
    bench_launches = bench_phase()
    for fwd, bwd, impl in (("B1", "B2", "block"), ("B3", "B4", "pallas")):
        f_name, b_name = ROUTES[impl][1:]
        print(f"train ({impl}): {bwd} {sums[b_name, 'train'].ms:.4f} ms per "
              f"step in 3 launches, "
              f"{100 * sums[b_name, 'train'].ms / train[impl]['step_ms']:.2f}"
              f" % of the {train[impl]['step_ms']:.1f} ms step; {fwd} at the "
              f"training shapes {sums[f_name, 'train'].ms:.4f} ms per step",
              flush=True)
    for what, a, b in (("serve", "roi_align_fused_fwd", "roi_align_block_fwd"),
                       ("train", "roi_align_fused_fwd", "roi_align_block_fwd"),
                       ("train", "roi_align_fused_bwd", "roi_align_block_bwd")):
        print(f"compare {what}: {a} {sums[a, what].ms:.4f} ms vs {b} "
              f"{sums[b, what].ms:.4f} ms (ratio "
              f"{sums[a, what].ms / sums[b, what].ms:.3f}; same RoIs, "
              f"bounds {sums[a, what].bound_ms:.4f} / "
              f"{sums[b, what].bound_ms:.4f} ms)", flush=True)

    def forward(name, source, replaces, impl):
        return _entry(name, source, replaces, f"serve and train ({impl})",
                      serve[impl], sums[name, "serve"],
                      train_launches=train[impl]["fwd"],
                      train_ms=sums[name, "train"].ms,
                      train_plain_ms=sums[name, "train"].plain_ms,
                      train_bound_ms=sums[name, "train"].bound_ms)
    entries = [
        forward("roi_align_block_fwd", "roi_align_block_fwd.cu",
                "bonai_tpu/ops/pallas_roi_align_block.py:152", "block"),
        _entry("roi_align_block_bwd", "roi_align_block_bwd.cu",
               "bonai_tpu/ops/pallas_roi_align_block.py:216", "train (block)",
               train["block"]["bwd"], sums["roi_align_block_bwd", "train"]),
        forward("roi_align_fused_fwd", "roi_align_fused_fwd.cu",
                "bonai_tpu/ops/pallas_roi_align_fused.py:127", "pallas"),
        _entry("roi_align_fused_bwd", "roi_align_fused_bwd.cu",
               "bonai_tpu/ops/pallas_roi_align_fused.py:181",
               "train (pallas)", train["pallas"]["bwd"],
               sums["roi_align_fused_bwd", "train"]),
        _entry("roi_align_strip_fwd", "roi_align_strip_fwd.cu",
               "bonai_tpu/ops/pallas_roi_align.py:113",
               "bonai_tpu_torch.tools.bench_roi_align", bench_launches,
               sums["roi_align_strip_fwd", "train"])]
    print(json.dumps({"kernels": entries}))
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
