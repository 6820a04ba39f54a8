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
   and invalid RoIs: max abs error, the wrapper's time (CUDA events over
   20 warm calls), the kernel's own device time over 20 such calls (CUDA
   events around each bare C launch), plain time and the least time the card could
   take (the bound).  Serving shapes: bbox R=6000 at 7x7, mask R=4000 at
   14x14, offset R=4000 at 7x7; training shapes: bbox R=2048 at 7x7, mask
   R=512 at 14x14, offset R=512 at 7x7; C=256.  Each forward and its
   backward run on the same RoIs.
   - B1, the RoIAlign forward kernel, under the block rule and under the
     strip rule (B3's function, ``roi_align_impl='pallas'``), at the
     serving and training shapes; the levels the kernel computes must
     equal the torch rule's on every RoI, and on RoIs at the rules' edges;
   - B2, the backward kernel, under both rules (B4's function under the
     strip rule) at the training shapes, against autograd through the
     plain versions; it must allocate nothing but the level gradients, in
     the output gradient's dtype;
   - B5, the forward-only window-64 strip RoIAlign: B1's kernel in its
     window-64 mode (the gather rule, the window cut and the y rule), at
     the training shapes; its levels must equal ``map_roi_levels``' on
     every RoI and on the gather rule's edges.
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
5. data: training from files.  The port's generator writes 8 train tiles
   of 1024^2 (seed 0: the first 8 of the acceptance set) into
   ``build/chip_smoke_data``; the loader of
   ``configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py`` (data paths
   pointed there) reads them once cold (PNG decode) and once warm (the
   decoded-image cache) in its thread mode, then twice in its process
   mode (the first pass starts the workers);
   ``train_detector(cfg, None, ...)`` then trains that config (its
   ``frozen_stages=-1``, bfloat16 autocast) 6 steps from the files.  Every
   loss must be finite, every trainable tensor (the stem and ``layer1``
   included) must move and no BatchNorm statistic may.
6. bench: ``bonai_tpu_torch.tools.bench_roi_align.main(["--iters", "3"])``,
   the entry point of B5.

Every launch count is zeroed just before each serve, train, data and bench
run and read just after: the route's forward kernel must launch 3 times per
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
SYNTH_CONFIG = os.path.join(
    REPO, "configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py")
DATA_DIR = os.path.join(REPO, "build", "chip_smoke_data")
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


def _block_module():
    """The module ``bonai_tpu_torch.ops.roi_align_block`` (the package's
    attribute of that name is its function)."""
    import importlib
    return importlib.import_module("bonai_tpu_torch.ops.roi_align_block")


def _device_ms(fn, reps, name):
    """The device time per call of kernel ``name`` over ``reps`` calls of
    ``fn`` (the calls ``_time_ms`` times): CUDA events recorded on the
    stream just before and just after each bare C launch (the ``ctypes``
    call), summed.  No profiler: a tracer left attached would slow every
    later launch of the serve and train phases."""
    import torch
    module = _block_module()
    events = []

    def timed(call):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = call(*args)
            end.record()
            events.append((start, end))
            return rc
        return run
    fn()
    torch.cuda.synchronize()
    saved = module._call
    module._call = timed(saved)
    try:
        for _ in range(reps):
            fn()
    finally:
        module._call = saved
    torch.cuda.synchronize()
    if len(events) != reps:
        raise AssertionError(f"{name}: {len(events)} launches in {reps} "
                             f"calls")
    return sum(a.elapsed_time(b) for a, b in events) / reps


class _Sums:
    """Per-batch sums of one kernel's numbers over the three branches."""

    def __init__(self):
        self.ms = self.device_ms = self.plain_ms = self.bound_ms = 0.0
        self.err = 0.0
        self.bound_by = None
        self.levels_checked = 0

    def add(self, ms, device_ms, plain_ms, bound, bound_by, err):
        self.ms += ms
        self.device_ms += device_ms
        self.plain_ms += plain_ms
        self.bound_ms += bound
        self.err = max(self.err, err)
        self.bound_by = bound_by


# per entry of ``_kernels``: the CUDA source that builds its kernel
# (``bonai_tpu_torch/csrc/<source>.cu``), the TPU kernel it replaces, and
# for the forwards, the level rule's arguments of ``launch_forward`` (the
# name of its ``level_rule`` in ``ops/roi_align_block.py``, window)
KERNELS = {
    "roi_align_block_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align_block.py:152",
                            ("BLOCK_RULE", 32)),
    "roi_align_fused_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align_fused.py:127",
                            ("STRIP_RULE", 40)),
    "roi_align_strip_fwd": ("roi_align_block_fwd",
                            "bonai_tpu/ops/pallas_roi_align.py:113",
                            ("WINDOW64_RULE", 64)),
    "roi_align_block_bwd": ("roi_align_block_bwd",
                            "bonai_tpu/ops/pallas_roi_align_block.py:216",
                            None),
    "roi_align_fused_bwd": ("roi_align_block_bwd",
                            "bonai_tpu/ops/pallas_roi_align_fused.py:181",
                            None),
}


def _window64(name):
    return KERNELS[name][2][0] == "WINDOW64_RULE"


def _kernels():
    """The port's RoIAlign wrappers: name -> (wrapper, which counts its
    kernel's launches; plain version of the function; level rule).  The
    block and the strip ('fused') route launch the same two kernels under
    their own rule and counters, the window-64 route ('strip') the forward
    kernel in its window-64 mode."""
    from bonai_tpu_torch.ops import (block_levels, roi_align_block,
                                     roi_align_block_backward,
                                     roi_align_block_ref, roi_align_fused,
                                     roi_align_fused_backward,
                                     roi_align_fused_ref, roi_align_strip,
                                     roi_align_strip_ref, strip_levels)
    from bonai_tpu_torch.ops.roi_align_strip import gather_levels
    return {
        "roi_align_block_fwd": (roi_align_block, roi_align_block_ref,
                                block_levels),
        "roi_align_fused_fwd": (roi_align_fused, roi_align_fused_ref,
                                strip_levels),
        "roi_align_strip_fwd": (roi_align_strip, roi_align_strip_ref,
                                gather_levels),
        "roi_align_block_bwd": (roi_align_block_backward,
                                roi_align_block_ref, block_levels),
        "roi_align_fused_bwd": (roi_align_fused_backward,
                                roi_align_fused_ref, strip_levels),
    }


def _edge_rois():
    """RoIs on the edges of the level rules, one float32 ulp below, at and
    above: max(w, h) = 112 * 2^k (the block push), w = 144 * 2^k (the strip
    push), sqrt(w * h) = 56 * 2^k and 56 * (2^k - 1e-6) (the gather rule),
    from the origin and from a fractional corner."""
    import numpy as np
    import torch
    rows = []
    for k in range(-2, 6):
        edges = [(112, "wide"), (112, "tall"), (144, "wide"), (56, "square"),
                 (56 * (1 - 1e-6 / 2.0 ** k), "square")]
        for edge, shape in edges:
            e = np.float32(edge * 2.0 ** k)
            for v in (np.nextafter(e, np.float32(0)), e,
                      np.nextafter(e, np.float32(np.inf))):
                w, h = {"wide": (v, v / 8), "tall": (v / 8, v),
                        "square": (v, v)}[shape]
                for x0, y0 in ((0.0, 0.0), (100.25, 37.5)):
                    rows.append([len(rows) % BATCH, x0, y0,
                                 np.float32(x0) + w, np.float32(y0) + h])
    return torch.tensor(np.array(rows, np.float32), device="cuda")


def _check_levels(name, levels, rois, size):
    """The levels that forward kernel ``name`` computes for ``rois`` must
    equal its torch rule's on the card; returns the RoIs checked."""
    import torch
    block = _block_module()
    rule, window = KERNELS[name][2]
    _, lvl = block.launch_forward(levels, rois, None, (size, size), STRIDES,
                                  2, getattr(block, rule), 56, window)
    want = _kernels()[name][2](rois[:, 1:5], STRIDES)
    if not torch.equal(lvl.long(), want):
        bad = (lvl.long() != want).nonzero()[:, 0]
        raise AssertionError(f"{name}: the kernel's levels differ from the "
                             f"torch rule's on {bad.numel()} RoIs, e.g. "
                             f"{rois[bad[:4]].tolist()}")
    return rois.shape[0]


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
    if _window64(name):
        corners, weights = strip_corner_plan(shapes, rois, size, STRIDES)
        weights = [w * valid[:, None, None] for w in weights]
    else:
        corners, weights = corner_plan(
            shapes, rois, _kernels()[name][2](rois[:, 1:5], STRIDES), size,
            STRIDES, roi_valid=valid)
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
            pushed = "" if _window64(name) else " pushed=%d" % int((
                level_rule(rois[:, 1:5], STRIDES)
                > level_rule(rois[:, 1:5], STRIDES, window=10 ** 9)).sum())
            sums.levels_checked += _check_levels(name, levels, rois, size)

            def kernel():
                with torch.no_grad():
                    return fn(*args, roi_valid=valid)

            def plain():
                with torch.no_grad():
                    return ref_fn(*args, roi_valid=valid)
            ms = _time_ms(kernel, 20)
            device_ms = _device_ms(kernel, 20, name)
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
                  f"ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by}; {cells} cells read)", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({label}, {dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, device_ms, plain_ms, bound, bound_by,
                         float(diff.max()))
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
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            got = kernel()
            torch.cuda.synchronize()
            # the level gradients are all the backward allocates: no float32
            # copy of the pyramid, no cast
            extra = torch.cuda.max_memory_allocated() - before
            if extra > grad_bytes + 2 ** 20 or any(
                    g.dtype != cot.dtype for g in got):
                raise AssertionError(f"{name} allocated {extra} bytes for "
                                     f"{grad_bytes} bytes of {dtype} "
                                     f"gradients")
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
            device_ms = _device_ms(kernel, 20, name)
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
                  f"ms={ms:.4f} device_ms={device_ms:.4f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} "
                  f"({bound_by}; allocated {extra} bytes for {grad_bytes} "
                  f"bytes of level gradients)", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version ({dtype}, {branch})")
            if dtype == torch.bfloat16:
                sums.add(ms, device_ms, plain_ms, bound, bound_by, err)
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
    edges = _edge_rois()
    for name in ("roi_align_block_fwd", "roi_align_fused_fwd",
                 "roi_align_strip_fwd"):
        checked = _check_levels(name, levels32, edges, 7) + sum(
            v.levels_checked for (n, _), v in sums.items() if n == name)
        print(f"kernel {name}: the kernel's levels equal the torch rule's "
              f"on {checked} RoIs ({edges.shape[0]} on the rules' edges)",
              flush=True)
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


def _synth_config():
    """The 2x synthetic recipe with its train data in ``DATA_DIR``."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(SYNTH_CONFIG)
    train = cfg.data.train
    train.ann_file = os.path.join(DATA_DIR, "train", "train.json")
    train.img_prefix = os.path.join(DATA_DIR, "train", "images") + "/"
    train.pipeline[0].cache_dir = os.path.join(DATA_DIR, "imgcache_train")
    return cfg


def _loader_rates(cfg, mode):
    """Images per second of two passes of the config's loader in ``mode``
    (one loader: the process mode's workers start in the first pass)."""
    from bonai_tpu_torch.apis.train import build_train_loader
    cfg.data.loader_mode = mode
    loader = build_train_loader(cfg)
    rates = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            n = sum(len(metas) for _, metas in loader)
            rates.append(n / (time.perf_counter() - t0))
        return rates, n
    finally:
        loader.close()
        del cfg.data["loader_mode"]


def data_phase(steps=6, tiles=8):
    """Training from files: generate, load, train ``steps`` steps of the
    synthetic recipe through ``train_detector(cfg, None, ...)``.  Returns
    the forward and backward kernels' launch counts, the median warm step
    time and the loader's rates."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.models.builder import build_detector
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_split
    _, fwd_name, bwd_name = ROUTES["block"]

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    write_split(DATA_DIR, "train", tiles, 0, SIZE)
    gen_s = (time.perf_counter() - t0) / tiles
    cfg = _synth_config()
    (cold, warm), n = _loader_rates(cfg, "thread")
    (start, warm_process), _ = _loader_rates(cfg, "process")
    print(f"data: generator {gen_s:.3f} s per 1024^2 tile ({tiles} tiles, "
          f"seed 0); loader ({cfg.data.workers_per_gpu} workers, batch "
          f"{cfg.data.samples_per_gpu}, {n} images a pass) thread mode "
          f"{cold:.1f} images/s cold (PNG decode), {warm:.1f} warm (cache); "
          f"process mode {start:.1f} while its workers start, "
          f"{warm_process:.1f} warm", flush=True)

    work_dir = os.path.join(REPO, "build", "chip_smoke_files")
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.time()
    model, hist = train_detector(cfg, None, work_dir, seed=0,
                                 max_steps=steps, log_interval=1)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    step_ms = [h["time"] * 1e3 for h in hist]
    wait_ms = [h["data_time"] * 1e3 for h in hist]
    median = statistics.median(step_ms[1:])
    print(f"data: train_detector from files, {SYNTH_CONFIG[len(REPO) + 1:]} "
          f"1024^2 B={cfg.data.samples_per_gpu} bf16 autocast, "
          f"frozen_stages={cfg.model.backbone.frozen_stages}, {steps} steps "
          f"in {wall:.1f} s incl. set-up and the final checkpoint; ms per "
          f"step {[round(x, 1) for x in step_ms]}; median of the "
          f"{len(step_ms) - 1} warm steps {median:.1f} ms; host wait for the "
          f"next batch, ms per step {[round(x, 1) for x in wait_ms]} (median "
          f"of the warm steps {statistics.median(wait_ms[1:]):.1f}); peak "
          f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"launches {counts}", flush=True)
    keys = [k for k in hist[0] if k.startswith("loss")]
    for h in hist:
        print(f"data: step {h['iter']} lr {h['lr']:.3g} grad_norm "
              f"{h['grad_norm']:.4g} " + " ".join(
                  f"{k} {h[k]:.5g}" for k in keys), flush=True)
    if not all(np.isfinite(h[k]) for h in hist
               for k in keys + ["grad_norm"]):
        raise AssertionError("a loss or the gradient norm is not finite")
    _check_counts(counts, {fwd_name: 3 * steps, bwd_name: 3 * steps},
                  f"train from files, {steps} steps")
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    start = init.state_dict()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    moved, still, stats_moved = [], [], []
    for name, v in model.state_dict().items():
        changed = not torch.equal(v.cpu(), start[name])
        if name.endswith(("running_mean", "running_var")):
            if changed:
                stats_moved.append(name)
        elif name in trainable:
            (moved if changed else still).append(name)
    print(f"data: {len(moved)} of {len(trainable)} trainable tensors moved "
          f"(stem and layer1 included: "
          f"{'backbone.conv1.weight' in moved and 'backbone.layer1.0.conv1.weight' in moved}"
          f"), {len(stats_moved)} BatchNorm statistics moved", flush=True)
    if still or stats_moved or len(trainable) != len(
            list(model.parameters())):
        raise AssertionError(f"not moved: {still[:4]}; BatchNorm statistics "
                             f"moved: {stats_moved[:4]}")
    shutil.rmtree(work_dir, ignore_errors=True)
    return {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
            "step_ms": median, "cold": cold, "warm": warm}


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


def _entry(name, path, launches, sums, label=None, **extra):
    """The kernels line's entry of ``KERNELS[name]`` (``label``: the name
    it is shown under, else ``name``)."""
    source, replaces, _ = KERNELS[name]
    return {"name": label or name, "route": "cuda",
            "source": f"bonai_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": sums.err, "ms": sums.ms,
            "device_ms": sums.device_ms, "plain_ms": sums.plain_ms,
            "bound_ms": sums.bound_ms, "bound_by": sums.bound_by,
            "library_ms": None, **extra}


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
    sources = sorted({source for source, *_ in KERNELS.values()})
    _build.build(sources)
    print(f"build: {len(sources)} source(s) in {time.time() - t0:.1f} s",
          flush=True)
    for name in sources:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    sums = kernel_phase()
    serve = {impl: serve_phase(impl) for impl in ("block", "pallas")}
    train = {impl: train_phase(impl, steps)
             for impl, steps in (("block", 6), ("pallas", 4))}
    files = data_phase()
    print(f"compare train: from files {files['step_ms']:.1f} ms a step vs "
          f"the repeated synthetic batch {train['block']['step_ms']:.1f} ms "
          f"(same route, this run); the loader gives "
          f"{files['cold']:.1f} images/s cold, {files['warm']:.1f} warm, "
          f"against {2e3 / files['step_ms']:.1f} images/s the step takes",
          flush=True)
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
                       ("train", "roi_align_strip_fwd", "roi_align_fused_fwd"),
                       ("train", "roi_align_fused_bwd", "roi_align_block_bwd")):
        print(f"compare {what}: {a} {sums[a, what].ms:.4f} ms vs {b} "
              f"{sums[b, what].ms:.4f} ms (ratio "
              f"{sums[a, what].ms / sums[b, what].ms:.3f}; same RoIs, "
              f"bounds {sums[a, what].bound_ms:.4f} / "
              f"{sums[b, what].bound_ms:.4f} ms)", flush=True)

    def forward(name, impl, label=None, **extra):
        return _entry(name, f"serve and train ({impl})", serve[impl],
                      sums[name, "serve"], label,
                      train_launches=train[impl]["fwd"], **extra,
                      train_ms=sums[name, "train"].ms,
                      train_device_ms=sums[name, "train"].device_ms,
                      train_plain_ms=sums[name, "train"].plain_ms,
                      train_bound_ms=sums[name, "train"].bound_ms)
    # B3 and B4 (the strip route) run on B1's and B2's kernels, B5 on B1's
    entries = [
        forward("roi_align_block_fwd", "block",
                train_from_files_launches=files["fwd"]),
        _entry("roi_align_block_bwd", "train (block)", train["block"]["bwd"],
               sums["roi_align_block_bwd", "train"],
               train_from_files_launches=files["bwd"]),
        forward("roi_align_fused_fwd", "pallas",
                "roi_align_block_fwd (strip rule)"),
        _entry("roi_align_fused_bwd", "train (pallas)",
               train["pallas"]["bwd"], sums["roi_align_fused_bwd", "train"],
               "roi_align_block_bwd (strip rule)"),
        _entry("roi_align_strip_fwd", "bonai_tpu_torch.tools.bench_roi_align",
               bench_launches, sums["roi_align_strip_fwd", "train"],
               "roi_align_block_fwd (window-64 rule)")]
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
