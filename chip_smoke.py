#!/usr/bin/env python3
"""Drives the bonai_tpu_torch serving, training (one card and
data-parallel) and test-and-score paths on the NVIDIA GPUs of one machine
(one is enough) and checks them.

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
   included) must move and no BatchNorm statistic may.  Its final
   checkpoint goes on to the eval phase.
6. eval: test and score that checkpoint.  The generator writes the first
   val scene of the acceptance set (seed 77, 2048^2) and its four 1024^2
   crops; the test CLI (``bonai_tpu_torch.tools.bonai_test``, ``--city
   config``, on the card) runs the config on the first crop to a pkl
   (``--max-images 1``: the 6-step weights leave about 1750 detections a
   crop to trace and overlay), and the evaluation CLI scores it per crop
   and ``--merge``d into the scene; ``run_inference`` is timed warm over
   the four crops.  The
   results must be well formed, P/R/F1 finite within [0, 1] and aEPE
   finite (the weights have had 6 steps); the inference ms per tile and
   the seconds of pkl -> records and of F1 are printed.  The planted
   check: the crop json's own roofs as results (full-size masks, score 1,
   the GT offsets) must score ``PLANTED``.
7. resume: chunked training through the host-RSS watchdog.  On the data
   phase's 8 tiles (4 steps an epoch) in process loader mode, ``python -m
   bonai_tpu_torch.tools.train_chunked`` with ``BONAI_MAX_RSS_GB`` below
   any process's RSS trains the 2x synthetic recipe 6 steps: the train CLI
   checkpoints and exits 75 at step 4 (its first log row, the first
   epoch's end), the wrapper resumes it once, and it ends at step 6.  An
   unbroken run of the same 6 steps logs every step; both run under
   ``--deterministic``, and the chunked run's logged losses and final
   weights must equal the unbroken run's to the bit.  ``host_rss_gb`` is
   printed at the start and the end.
8. ddp: data parallelism, every run started through
   ``bonai_tpu_torch.parallel.launch``.  (a) The rehearsal: two gloo
   ranks on one card (NCCL refuses two ranks on one device), each one
   step of the train phase's config on its image of the synthetic batch,
   float32, no autocast, deterministic, at a constant LR; the updated
   weights of both ranks must equal a one-process step (a process of its
   own) whose gradient is the mean of the two half-batch gradients, with
   the same draws, within 1e-4 of each tensor's largest update.  Both
   ranks share the card, so its step time is not a scaling figure.  (b)
   The CLI: ``bonai_tpu_torch.tools.train.main`` with ``--n-devices
   device_count()`` as every rank of a process group of that many ranks
   (NCCL, one rank per card, under DDP even for one card) trains 4 steps of the 2x synthetic recipe from the data phase's tiles;
   its step ms are printed against the data phase's (one process, no
   DDP); then ``run_inference`` of the eval phase's four crops is sharded
   over as many ranks and merged in dataset order.
9. loft: LOFT with the plain ``OffsetHead``
   (``configs/loft/loft_r50_fpn_2x_bonai.py``) at full width, seeded
   random weights, ``'block'`` route: one serve batch (B=2, 1024^2, bf16)
   and one ``inference_detector`` call, a small float32 input held to the
   plain route, and 3 steps on the repeated synthetic batch (finite
   losses, every trainable weight moves, the RoI branches' gradients
   held to the plain route).
10. rcnn: the R-CNN baselines on BONAI, each at full width with seeded
   random weights and ``roi_align_impl='block'`` (the config's key):
   ``configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py``,
   ``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py`` and
   ``configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py``, as the loft
   phase runs its config: one serve batch and one ``inference_detector``
   call (the results carry the model's heads: boxes and masks, or boxes
   alone), the small float32 input held to the plain route, and training
   on the repeated synthetic batch (6 steps of Mask R-CNN, 3 of the
   others).  The Mask R-CNN's 6-step checkpoint goes through the test CLI
   on the card (one of the eval phase's val crops; a pkl of ``(bbox,
   segm)`` 2-tuples) and the evaluation CLI, which prints roof and
   footprint F1.  COCO-style scoring: the Mask R-CNN's and the Dynamic
   R-CNN's checkpoints through the generic test CLI
   (``bonai_tpu_torch.tools.test``, ``--eval bbox segm`` and ``--eval
   bbox``) on that crop, with the AP keys and the seconds taken; the
   planted check: the four crops' own GTs as results (score 1, full-size
   RLE masks) must score ``bbox_mAP == segm_mAP == 1.0`` and VOC ``mAP ==
   1.0`` through ``CocoDataset.evaluate``.
11. hrnet: LOFT-FOA on HRNet-W32 + HRFPN
   (``configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py``) at full width,
   seeded random weights whose backbone BatchNorm statistics are those of
   a random batch (identity statistics let the fuse sums grow to head
   outputs of about 5e8), ``'block'``, as the loft phase runs its config:
   one serve batch and one ``inference_detector`` call, the small float32
   input held to the plain route, 3 steps on the repeated synthetic batch
   at the config's base LR, without its warmup (exactly ``conv2``/``bn2``,
   behind the gradient stop after ``layer1``, get no gradient, in this
   phase alone; they move by weight decay alone, which the warmup's LRs
   would leave under a float32 ulp, and bn2's zero bias stays 0), the RoI
   branches' gradients held to the plain route; then the backbone + neck
   time of a serve batch beside R50 + FPN's.
12. bench: ``bonai_tpu_torch.tools.bench_roi_align.main(["--iters", "3"])``,
   the entry point of B5.

Every launch count is zeroed just before each serve, train, data, eval and
bench run and read just after: the route's forward kernel must launch 3
times per batch or step, its backward kernel 3 times per training step, no
other kernel at all; the bench must launch B5.  The resume phase's runs are
processes of their own, which start from zero and log their counts; their
sum must be 3 launches of each kernel a step.  The ddp phase reads every
rank's counts: each rank launches B1 and B2 3 times a step, B1 3 times a
test batch.  The loft, hrnet and rcnn phases' counts are zeroed and read
like the serve and train phases', at one launch of each kernel per RoI
call a batch or step makes: 3 for LOFT (on either backbone), 2 for Mask
R-CNN (box and mask), 4 for Cascade Mask R-CNN (three box stages and the
mask), 1 for Dynamic R-CNN.

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
LOFT_CONFIG = os.path.join(REPO, "configs/loft/loft_r50_fpn_2x_bonai.py")
HRNET_CONFIG = os.path.join(REPO,
                            "configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py")
# the R-CNN baselines on BONAI (the rcnn phase): label, config, train steps
RCNN_CONFIGS = (
    ("mask_rcnn", "configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py", 6),
    ("cascade", "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py",
     3),
    ("dynamic", "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py", 3))
# the rcnn phase's checkpoints scored COCO-style by the test CLI: --eval,
# and the RoI calls of a batch
COCO_SCORED = {"mask_rcnn": (("bbox", "segm"), 2), "dynamic": (("bbox",), 1)}
DATA_DIR = os.path.join(REPO, "build", "chip_smoke_data")
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores
BATCH, SIZE, C = 2, 1024, 256
SERVE_BRANCHES = (("bbox", 6000, 7), ("mask", 4000, 14), ("offset", 4000, 7))
TRAIN_BRANCHES = (("bbox", 2048, 7), ("mask", 512, 14), ("offset", 512, 7))
STRIDES = [4, 8, 16, 32]
# TP/FP/FN of the planted check: the first val scene's crop json scored as
# its own results (tests/test_torch_port_eval.py asserts the same counts)
PLANTED = {"roof": (24, 1, 1), "footprint": (25, 0, 0)}
SCORED_CROPS = 1            # of the eval phase's 4 (see eval_phase)


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


def _branches(model):
    """``(extractor config, RoI head)`` of each RoIAlign call a batch makes:
    the box head (a cascade's every stage), then the mask and offset heads
    the model has."""
    import torch
    bbox = model.roi_head["bbox_head"]
    out = [(model.bbox_extractor_cfg, h) for h in (
        bbox if isinstance(bbox, torch.nn.ModuleList) else [bbox])]
    for head, ext in (("mask_head", "mask_extractor_cfg"),
                      ("offset_head", "offset_extractor_cfg")):
        if head in model.roi_head:
            out.append((getattr(model, ext), model.roi_head[head]))
    return out


def _check_outputs(out, b, p, model):
    import torch
    shapes = {"det_bboxes": (b, p, 4), "det_scores": (b, p),
              "det_labels": (b, p), "det_valid": (b, p)}
    if "mask_head" in model.roi_head:
        shapes["mask_probs"] = (b, p, 28, 28)
    if "offset_head" in model.roi_head:
        shapes["offsets"] = (b, p, 2)
    if set(out) != set(shapes):
        raise AssertionError(f"outputs {sorted(out)}, expected "
                             f"{sorted(shapes)}")
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


def _config(impl, config=CONFIG):
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(config)
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


def serve_phase(impl, config=CONFIG, calls=2, label=None, checkpoint=None):
    """Full-width serving of ``config`` (LOFT-FOA R50-FPN by default)
    through the port's entry points with ``roi_align_impl=impl``, seeded
    random weights or those of ``checkpoint``: ``calls`` timed batches,
    then one ``inference_detector`` call.  Returns the forward kernel's
    launch count of the run and its ms per call."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import (inference_detector, init_detector,
                                      prepare_batch)
    _, fwd_name, _ = ROUTES[impl]
    what = label or f"serve ({impl})"

    t0 = time.time()
    model = init_detector(_config(impl, config), checkpoint,  # cuda, bf16
                          seed=0)
    print(f"{what}: init_detector {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"dtype {next(model.parameters()).dtype}", flush=True)
    max_per_img = model.test_cfg["rcnn"]["max_per_img"]
    n_roi = len(_branches(model))
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(BATCH)]
    img, img_shape, scale, _ = prepare_batch(model, imgs)
    model.simple_test(img, img_shape, scale)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.simple_test(img, img_shape, scale)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_outputs(out, BATCH, max_per_img, model)
    _check_counts(_counts(), {fwd_name: n_roi * calls},
                  f"{what}, {calls} batches")
    t0 = time.perf_counter()
    res = inference_detector(model, r.randint(0, 256, (512, 640, 3),
                                              np.uint8))
    single_ms = (time.perf_counter() - t0) * 1e3
    bbox = res[0] if isinstance(res, tuple) else res
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: simple_test 1024^2 B={BATCH} ms per call "
          f"{[round(x, 1) for x in times]}, ms per image "
          f"{[round(x / BATCH, 1) for x in times]}; valid detections "
          f"{out['det_valid'].sum(1).tolist()}", flush=True)
    print(f"{what}: inference_detector 512x640 -> 819x1024 incl. "
          f"host paste+RLE {single_ms:.1f} ms, {len(bbox[0])} detections; "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"launches {counts}", flush=True)
    _check_counts(counts, {fwd_name: n_roi * (calls + 1)},
                  f"{what}, {calls + 1} batches")
    # (bbox, segm, offsets), (bbox, segm) or bbox alone
    parts = len(res) if isinstance(res, tuple) else 1
    if parts != 1 + ("mask_head" in model.roi_head) + (
            "offset_head" in model.roi_head):
        raise AssertionError(f"inference_detector gave {parts} parts")
    if not (np.isfinite(bbox[0]).all()
            and (parts < 2 or len(res[1][0]) == len(bbox[0]))
            and (parts < 3 or (len(res[2]) == len(bbox[0])
                               and np.isfinite(res[2]).all()))):
        raise AssertionError("inference_detector results are inconsistent")

    # a small float32 input: the three RoI branches' head outputs on the
    # model's own proposals, through the kernel and through its plain
    # version (same level rule and arithmetic; no NMS in between, so
    # float noise cannot reorder anything), in float32 throughout: cuDNN's
    # TF32 convolutions would round the two runs' RoI features, which
    # differ in their last bits, to 10-bit mantissas apart
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _small_input_check(model, impl, what, r)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return counts[fwd_name], statistics.median(times)


def _small_input_check(model, impl, what, r):
    """The RoI heads' outputs of a small float32 input on the model's own
    proposals, through route ``impl``'s kernel and through its plain
    version."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    from bonai_tpu_torch.models.detectors import two_stage
    attr, fwd_name, _ = ROUTES[impl]
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
        for i, (ext, module) in enumerate(_branches(model)):
            head = f"RoI call {i} ({type(module).__name__})"

            def run():
                out = module(model._roi_align_cfg(ext, feats, rois, rvalid))
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
            print(f"{what}: small float32 input, {head} through the "
                  f"kernel vs its plain version: max abs diff {err:.3g} "
                  f"(outputs up to {scale:.3g})", flush=True)
            if not err <= 1e-4 * max(scale, 1.0):
                raise AssertionError(f"small input: {head} differs from "
                                     f"the plain path by {err}")


def _roi_grad_check(model, impl, what):
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

    n_roi = len(_branches(model))
    _zero_counts()
    try:
        setattr(two_stage, attr, recorded)
        losses = model._roi_forward_train(
            feats, props, pvalid, batch,
            generator_draws(torch.Generator(device="cuda").manual_seed(0)))
    finally:
        setattr(two_stage, attr, kernel_fn)
    sum(v for k, v in losses.items() if not k.startswith("stat_")).backward()
    torch.cuda.synchronize()
    _check_counts(_counts(), {fwd_name: n_roi, bwd_name: n_roi},
                  f"{what}, small input")
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
        print(f"{what}: small float32 input, FPN stride {s} "
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


def train_phase(impl, steps, config=CONFIG, label=None, keep=False,
                warmup=True, load_from=None):
    """Full-width training of ``config`` (LOFT-FOA R50-FPN by default)
    through ``train_detector`` with ``roi_align_impl=impl`` for ``steps``
    steps (1 warm-up) on one card, from seeded random weights or those of
    ``load_from``, with the config's LR warmup or, without ``warmup``, at
    its base LR.  Every trainable tensor must get a gradient in some step,
    but for those behind HRNet's gradient stop after ``layer1``
    (``conv2``/``bn2``), which must get none, and every one must move.
    Returns the forward and backward kernels' launch counts of the run,
    the median warm step time, the peak memory, and with ``keep`` the
    final checkpoint, whose work directory the caller removes."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.engine import train_step as train_step_module
    from bonai_tpu_torch.models.builder import build_detector
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    from bonai_tpu_torch.utils.weights import load_mmdet_checkpoint
    _, fwd_name, bwd_name = ROUTES[impl]
    what = label or f"train ({impl})"

    cfg = _config(impl, config)
    if not warmup:
        cfg.lr_config.warmup = None
    batch = synthetic_batch()
    work_dir = os.path.join(REPO, "build", "chip_smoke_train" + (
        f"_{label.split()[0]}" if keep else ""))
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # which parameters had a nonzero gradient in some step (on the card,
    # no host read in the step)
    params, grad_seen = [], [None]
    update = train_step_module.apply_gradients

    def recording(optimizer, lr, max_norm=None):
        norm = update(optimizer, lr, max_norm)
        params[:] = [p for g in optimizer.param_groups for p in g["params"]]
        norms = torch.stack(torch._foreach_norm([p.grad for p in params]))
        grad_seen[0] = norms if grad_seen[0] is None else torch.maximum(
            grad_seen[0], norms)
        return norm
    _zero_counts()
    t0 = time.time()
    # one epoch of `steps` copies of the batch: no epoch checkpoint falls
    # between the timed steps
    train_step_module.apply_gradients = recording
    try:
        model, hist = train_detector(cfg, [batch] * steps, work_dir, seed=0,
                                     max_steps=steps, log_interval=1,
                                     n_devices=1, load_from=load_from)
    finally:
        train_step_module.apply_gradients = update
    torch.cuda.synchronize()
    grad_seen[0] = (grad_seen[0] > 0).tolist()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    wall = time.time() - t0
    step_ms = [h["time"] * 1e3 for h in hist]
    print(f"{what}: train_detector 1024^2 B={BATCH} bf16 autocast, "
          f"{steps} steps in {wall:.1f} s incl. set-up and the final "
          f"checkpoint; ms per step {[round(x, 1) for x in step_ms]}; "
          f"median of the {len(step_ms) - 1} warm steps "
          f"{statistics.median(step_ms[1:]):.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); launches "
          f"{counts}", flush=True)
    keys = [k for k in hist[0] if k.split(".")[-1].startswith("loss")]
    for h in hist:
        print(f"{what}: step {h['iter']} lr {h['lr']:.3g} grad_norm "
              f"{h['grad_norm']:.4g} " + " ".join(
                  f"{k} {h[k]:.5g}" for k in keys), flush=True)
    if not all(np.isfinite(h[k]) for h in hist
               for k in keys + ["grad_norm"]):
        raise AssertionError("a loss or the gradient norm is not finite")
    n_roi = len(_branches(model))
    _check_counts(counts, {fwd_name: n_roi * steps, bwd_name: n_roi * steps},
                  f"{what}, {steps} steps")
    init = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    init.init_weights(torch.Generator().manual_seed(0))
    if load_from:
        init.load_state_dict(load_mmdet_checkpoint(load_from))
    start = dict(init.named_parameters())
    # the trainable tensors without a gradient in any step: exactly those
    # upstream of HRNet's gradient stop after layer1, which weight decay
    # and momentum alone move, as in the JAX step; none in other models
    names = {id(p): n for n, p in model.named_parameters()}
    no_grad = {names[id(p)] for p, seen in zip(params, grad_seen[0])
               if not seen}
    behind_stop = {f"backbone.{n}" for n, p in
                   model.backbone.named_parameters()
                   if p.requires_grad and n.split(".")[0] in ("conv2", "bn2")
                   } if getattr(model.backbone, "stops_gradient",
                                False) else set()
    print(f"{what}: trainable tensors without a gradient in any step: "
          f"{sorted(no_grad) or 'none'}", flush=True)
    if no_grad != behind_stop:
        raise AssertionError(f"trainable tensors without a gradient in any "
                             f"step: {sorted(no_grad)}, expected "
                             f"{sorted(behind_stop)}")
    moved = frozen_moved = trainable = 0
    held = []
    for name, p in model.named_parameters():
        changed = not torch.equal(p.detach().cpu(), start[name].detach())
        if not p.requires_grad:
            frozen_moved += changed
            continue
        trainable += 1
        # weight decay alone scales bn2's bias, 0 at the start, by 0
        if name == "backbone.bn2.bias" and name in no_grad \
                and not start[name].any():
            moved += not changed
            held.append(name)
        else:
            moved += changed
    print(f"{what}: {moved} of {trainable} trainable parameter tensors "
          f"moved, or held at 0 without a gradient: {held or 'none'}; "
          f"{frozen_moved} frozen ones moved", flush=True)
    if moved != trainable or frozen_moved:
        stuck = [n for n, p in model.named_parameters() if p.requires_grad
                 and n not in held and torch.equal(p.detach().cpu(),
                                                   start[n].detach())]
        raise AssertionError(f"the trainable weights did not all move "
                             f"({stuck[:8]}, or {held} moved), or a frozen "
                             f"one did")
    out = {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
           "step_ms": statistics.median(step_ms[1:]),
           "peak_gib": peak / 2 ** 30}
    if keep:
        from bonai_tpu_torch.engine import latest_checkpoint
        out.update(checkpoint=latest_checkpoint(work_dir), work_dir=work_dir)
    else:
        shutil.rmtree(work_dir, ignore_errors=True)

    _roi_grad_check(model, impl, what)
    return out


def _synth_config(test=False):
    """The 2x synthetic recipe with its train data in ``DATA_DIR`` (and
    with ``test``, its test data the eval phase's val crops)."""
    from bonai_tpu_torch.config import Config
    cfg = Config.fromfile(SYNTH_CONFIG)
    train = cfg.data.train
    train.ann_file = os.path.join(DATA_DIR, "train", "train.json")
    train.img_prefix = os.path.join(DATA_DIR, "train", "images") + "/"
    train.pipeline[0].cache_dir = os.path.join(DATA_DIR, "imgcache_train")
    if test:
        cfg.data.test.ann_file = os.path.join(DATA_DIR, "val", "val.json")
        cfg.data.test.img_prefix = os.path.join(DATA_DIR, "val",
                                                "images") + "/"
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
                                 max_steps=steps, log_interval=1,
                                 n_devices=1)
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
    keys = [k for k in hist[0] if k.split(".")[-1].startswith("loss")]
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
    from bonai_tpu_torch.engine import latest_checkpoint
    return {"fwd": counts[fwd_name], "bwd": counts[bwd_name],
            "step_ms": median, "cold": cold, "warm": warm,
            "checkpoint": latest_checkpoint(work_dir), "work_dir": work_dir}


def _planted_pkl(ann_file, path):
    """A results pkl built from a crop json itself: per image its roofs
    filled into full-size masks (RLE), its roof boxes with score 1 and its
    GT offsets."""
    import pickle
    import numpy as np
    from bonai_tpu_torch.datasets import mask_utils
    with open(ann_file) as f:
        ds = json.load(f)
    results, names = [], []
    for im in ds["images"]:
        anns = [a for a in ds["annotations"] if a["image_id"] == im["id"]]
        dets = np.array([[a["bbox"][0], a["bbox"][1],
                          a["bbox"][0] + a["bbox"][2],
                          a["bbox"][1] + a["bbox"][3], 1.0] for a in anns],
                        np.float32).reshape(-1, 5)
        rles = [mask_utils.encode_mask(mask_utils.poly_to_mask(
            a["segmentation"], im["height"], im["width"])) for a in anns]
        offsets = np.array([a["offset"] for a in anns],
                           np.float32).reshape(-1, 2)
        results.append(([dets], [rles], offsets))
        names.append(im["file_name"])
    with open(path, "wb") as f:
        pickle.dump(dict(results=results, filenames=names), f)


def _scores(summary):
    """The evaluation CLI's summary must hold finite P/R/F1 within [0, 1]
    and a finite aEPE (-1 when nothing matched)."""
    import math
    for name in ("roof", "footprint"):
        for k in ("precision", "recall", "f1"):
            v = summary[f"{name}_{k}"]
            if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                raise AssertionError(f"{name}_{k} = {v}")
    if not math.isfinite(summary["aEPE"]):
        raise AssertionError(f"aEPE = {summary['aEPE']}")
    return (f"roof P/R/F1 {summary['roof_precision']:.4f}/"
            f"{summary['roof_recall']:.4f}/{summary['roof_f1']:.4f} (TP/FP/FN "
            f"{summary['roof_tp']}/{summary['roof_fp']}/"
            f"{summary['roof_fn']}), "
            f"footprint {summary['footprint_precision']:.4f}/"
            f"{summary['footprint_recall']:.4f}/{summary['footprint_f1']:.4f} "
            f"({summary['footprint_tp']}/{summary['footprint_fp']}/"
            f"{summary['footprint_fn']}), aEPE {summary['aEPE']:.4f} px "
            f"({summary['matched']} matched)")


def eval_phase(checkpoint, work_dir):
    """Test and score the data phase's checkpoint: the first val scene of
    the acceptance set (seed 77, 2048^2, four 1024^2 crops) through the
    test CLI on the card, then the evaluation CLI per crop and merged, and
    the planted check.  Removes ``work_dir`` (the checkpoint's) at the end.
    Returns B1's launches in the test CLI's run."""
    import pickle
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    from bonai_tpu_torch.evaluation import results_to_csv_records
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_scene_split
    _, fwd_name, _ = ROUTES["block"]

    t0 = time.perf_counter()
    write_scene_split(DATA_DIR, "val", 1, 77, scene_size=2048, crop=SIZE)
    gen_s = time.perf_counter() - t0
    crops = os.path.join(DATA_DIR, "val", "val.json")
    scenes = os.path.join(DATA_DIR, "val_originals", "val_originals.json")
    cfg = _synth_config(test=True)
    out_dir = os.path.join(REPO, "build", "chip_smoke_eval")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    pkl = os.path.join(out_dir, "results.pkl")

    # the 6-step weights leave about 1750 detections a crop at or above
    # 0.4 (chip_smoke, PR 7): tracing and overlaying them takes about 30 s
    # a crop on the host, so the test CLI runs and scores one crop
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, checkpoint, "--out", pkl,
                               "--city", "config", "--max-images",
                               str(SCORED_CROPS)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    results, names = payload["results"], payload["filenames"]
    batch = cfg.data.samples_per_gpu
    batches = -(-SCORED_CROPS // batch)
    if len(results) != SCORED_CROPS or len(names) != 4:
        raise AssertionError(f"test CLI: {len(results)} results, "
                             f"{len(names)} file names")
    _check_counts(counts, {fwd_name: 3 * batches},
                  f"test CLI, {SCORED_CROPS} of {len(names)} tiles in "
                  f"{batches} batch(es)")
    for res in results:
        boxes, masks, offsets = res[0][0], res[1][0], res[2]
        if not (boxes.shape[1:] == (5,) and len(masks) == len(boxes)
                == len(offsets) and np.isfinite(boxes).all()
                and np.isfinite(offsets).all()
                and all(m["size"] == [SIZE, SIZE] for m in masks)):
            raise AssertionError("the test CLI's results are malformed")
    score_thr = 0.4
    n_dets = [len(r[0][0]) for r in results]
    n_above = sum(int((r[0][0][:, 4] >= score_thr).sum()) for r in results)

    # warm: the model and the loader again, run_inference timed alone
    model = init_detector(cfg, checkpoint, dtype=torch.bfloat16)
    loader = build_dataloader(build_dataset(dict(cfg.data.test,
                                                 test_mode=True)),
                              samples_per_gpu=batch, shuffle=False,
                              train=False)
    t0 = time.perf_counter()
    run_inference(model, loader, progress=False)
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    loader.close()
    del model
    t0 = time.perf_counter()
    records = results_to_csv_records(results, names, score_thr=score_thr)
    records_s = time.perf_counter() - t0
    print(f"eval: generator {gen_s:.1f} s for 1 val scene (seed 77, 2048^2, "
          f"{len(names)} crops); test CLI {cli_s:.1f} s (model build, "
          f"--max-images {SCORED_CROPS}: {batches} batch of {batch}, bf16); "
          f"launches {counts}", flush=True)
    print(f"eval: detections at or above score_thr {score_thr}: {n_above} "
          f"(of {sum(n_dets)} on the {SCORED_CROPS} scored crop(s))",
          flush=True)
    print(f"eval: inference {infer_ms:.1f} ms per 1024^2 tile "
          f"(run_inference warm over the {len(names)} crops: loader, "
          f"simple_test, paste + RLE)", flush=True)
    print(f"eval: pkl -> records {records_s:.2f} s "
          f"({sum(map(len, records.values()))} records)", flush=True)

    for what, argv in (("per crop", ["--gt-json", crops]),
                       ("merged", ["--merge", "--gt-json", scenes])):
        t0 = time.perf_counter()
        summary = bonai_evaluation.main([pkl, *argv])
        eval_s = time.perf_counter() - t0
        print(f"eval: {what}: {_scores(summary)}; evaluation CLI "
              f"{eval_s:.2f} s (F1 about {eval_s - records_s:.2f} s of it)",
              flush=True)

    planted = os.path.join(out_dir, "planted.pkl")
    _planted_pkl(crops, planted)
    summary = bonai_evaluation.main([planted, "--gt-json", crops])
    got = {name: tuple(summary[f"{name}_{k}"] for k in ("tp", "fp", "fn"))
           for name in ("roof", "footprint")}
    print(f"eval: planted (the crop json's own roofs): {_scores(summary)}",
          flush=True)
    if got != PLANTED or summary["aEPE"] != 0.0:
        raise AssertionError(f"planted check: {got}, aEPE {summary['aEPE']}"
                             f", expected {PLANTED}, aEPE 0")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts[fwd_name]


RESUME_STEPS = 6        # 4 steps an epoch over the data phase's 8 tiles
RESUME_LOG = 4          # the watchdog checks at the first epoch's end


def _train_cli(module, work_dir, cfg_path, *args, env=None):
    """``python -m bonai_tpu_torch.tools.<module>`` to ``RESUME_STEPS`` steps
    in one process, on one card of any host (``train_chunked`` takes the
    work dir as its second argument); returns the finished process with
    its output."""
    where = [work_dir] if module == "train_chunked" else ["--work-dir",
                                                          work_dir]
    proc = subprocess.run(
        [sys.executable, "-m", f"bonai_tpu_torch.tools.{module}", cfg_path,
         *where, "--max-steps", str(RESUME_STEPS), "--n-devices", "1",
         *args], cwd=REPO,
        capture_output=True, text=True, env=dict(os.environ, **(env or {})))
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc


def _run_end(proc, work_dir):
    """The run's log rows, final checkpoint and summed kernel launches (one
    ``kernel launches`` log line per process)."""
    import torch
    from bonai_tpu_torch.engine import latest_checkpoint
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpt = torch.load(latest_checkpoint(work_dir), map_location="cpu",
                      weights_only=True)
    launches = {}
    for line in proc.stderr.splitlines():
        if "kernel launches " in line:
            for k, v in json.loads(line.split("kernel launches ")[1]).items():
                launches[k] = launches.get(k, 0) + v
    return rows, ckpt, launches


def _max_diff(a, b):
    return max(float((x.float() - b["state_dict"][k].float()).abs().max())
               for k, x in a["state_dict"].items())


def resume_phase():
    """Chunked training through the watchdog: ``train_chunked`` with
    ``BONAI_MAX_RSS_GB`` below any process's RSS trains the 2x synthetic
    recipe on the data phase's 8 tiles in process loader mode; the run
    checkpoints and exits 75 at step 4 (the first epoch's end, its first
    log row), the wrapper resumes it once and it ends at step 6.  Its
    logged losses and final weights must equal an unbroken run's of the
    same steps: both run under ``--deterministic``, so to the bit.
    Returns the summed kernel launches of the chunked run."""
    cfg = _synth_config()
    cfg.data.loader_mode = "process"
    cfg.log_config.interval = RESUME_LOG
    out = os.path.join(REPO, "build", "chip_smoke_resume")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg_path = os.path.join(out, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    whole_dir, chunked_dir = (os.path.join(out, d)
                              for d in ("unbroken", "chunked"))
    t0 = time.perf_counter()
    whole = _train_cli("train", whole_dir, cfg_path, "--deterministic",
                       "--options", "log_config.interval=1")
    t1 = time.perf_counter()
    chunked = _train_cli("train_chunked", chunked_dir, cfg_path,
                         "--deterministic", env={"BONAI_MAX_RSS_GB": "0.001"})
    t2 = time.perf_counter()
    lines = chunked.stdout.splitlines()
    restarts = sum("RSS-limit restart (rc=75)" in x for x in lines)
    if restarts != 1 or lines[-1] != "[train_chunked] complete":
        raise AssertionError(f"train_chunked: {restarts} restarts, last line "
                             f"{lines[-1]!r}")
    rows_w, ckpt_w, _ = _run_end(whole, whole_dir)
    rows_c, ckpt_c, launches = _run_end(chunked, chunked_dir)
    import torch
    preempt = torch.load(os.path.join(chunked_dir, "checkpoints",
                                      f"step_{RESUME_LOG}.pth"),
                         map_location="cpu", weights_only=True)["meta"]
    print(f"resume: train_chunked, {RESUME_STEPS} steps of "
          f"{SYNTH_CONFIG[len(REPO) + 1:]} (process loader, "
          f"--deterministic), BONAI_MAX_RSS_GB=0.001: exit 75 at step "
          f"{preempt['step']} (the end of epoch {preempt['epoch']}), "
          f"{restarts} restart, complete at step {ckpt_c['step']} in "
          f"{t2 - t1:.1f} s; unbroken run {t1 - t0:.1f} s; launches "
          f"{launches}", flush=True)
    print(f"resume: host_rss_gb of the unbroken run at step "
          f"{rows_w[0]['iter']} (start) {rows_w[0]['host_rss_gb']}, at step "
          f"{rows_w[-1]['iter']} (end) {rows_w[-1]['host_rss_gb']}; the "
          f"chunked run's first process at step {rows_c[0]['iter']} "
          f"{rows_c[0]['host_rss_gb']} (preempt_rss "
          f"{preempt['preempt_rss']:.3f})", flush=True)
    keys = [k for k in rows_c[0] if k.startswith("loss")]
    same = {r["iter"]: r for r in rows_w}
    for rc in rows_c:
        rw = same[rc["iter"]]
        print(f"resume: step {rc['iter']} unbroken / chunked " + " ".join(
            f"{k} {rw[k]:.4f}/{rc[k]:.4f}" for k in keys), flush=True)
    diff = _max_diff(ckpt_c, ckpt_w)
    print(f"resume: final weights, chunked vs unbroken: max abs diff {diff!r}"
          f" over {len(ckpt_w['state_dict'])} tensors", flush=True)
    if ([r["iter"] for r in rows_c] != [RESUME_LOG]
            or any(rc[k] != same[rc["iter"]][k] for rc in rows_c
                   for k in keys) or diff != 0.0
            or not ckpt_c["step"] == ckpt_w["step"] == RESUME_STEPS):
        raise AssertionError("the chunked run differs from the unbroken one")
    shutil.rmtree(out, ignore_errors=True)
    return launches


DDP_STEPS = 4           # the CLI run of the ddp phase


def _rehearsal_config():
    """The full-width LOFT-FOA config of the serve and train phases in
    float32 (no autocast) at a constant LR, so that each tensor's update
    stands far above its float32 rounding."""
    cfg = _config("block")
    cfg.compute_dtype = "float32"
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    return cfg


def _by_kernel(launches):
    """Wrapper launch counts (``ops.launch_counts()``) by the kernel names
    of ``_kernels``."""
    return {name: launches.get(fn.__name__, 0)
            for name, (fn, _, _) in _kernels().items()}


def _sharded_test_rank(cfg, checkpoint, out):
    """A rank of the ddp phase's sharded test: the checkpoint in bfloat16
    on this rank's card and its eval shard through ``run_inference``; rank
    0 writes the merged results, and every rank's time and kernel
    launches, to ``out``."""
    import pickle
    import torch
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis import init_detector, run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    from bonai_tpu_torch.ops import launch_counts
    rank, world_size = parallel.world()
    model = init_detector(cfg, checkpoint, dtype=torch.bfloat16)
    loader = build_dataloader(
        build_dataset(dict(cfg.data.test, test_mode=True)),
        samples_per_gpu=cfg.data.samples_per_gpu, shuffle=False,
        train=False, shard_id=rank, num_shards=world_size)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_inference(model, loader, progress=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    ranks = parallel.gather_objects((ms, launched))
    loader.close()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(dict(results=results, ranks=ranks), f)


# the train CLI as every rank of a process group of N cards (NCCL), so that
# it runs under DDP even on one card
CLI_RANKS = ("import sys; from bonai_tpu_torch import parallel; "
             "from bonai_tpu_torch.tools.train import main; "
             "sys.exit(parallel.launch(main, int(sys.argv[1]), 'cuda', "
             "sys.argv[3:], work_dir=sys.argv[2]))")


def ddp_phase(card, files_step_ms):
    """Data parallelism through ``bonai_tpu_torch.parallel.launch``:

    (a) the rehearsal: two gloo ranks on one card (NCCL refuses two ranks
    on one device), each one step of the full-width LOFT-FOA config on
    its image of the synthetic batch, float32, deterministic; the updated
    weights must equal a one-process step whose gradient is the mean of
    the two half-batch gradients, with the same draws, within 1e-4 of each
    tensor's largest update;
    (b) the CLI: ``tools/train.py``'s ``main`` with ``--n-devices
    device_count()`` in each rank of a NCCL group of one rank per card
    (under DDP even for one card) trains ``DDP_STEPS`` steps of the 2x synthetic recipe
    from the data phase's tiles, and ``run_inference`` over the eval
    phase's four crops is sharded over the same number of ranks.

    Every rank must launch B1 and B2 3 times a step (B1 3 times a test
    batch).  Returns the launch counts per rank of each run."""
    import pickle
    import numpy as np
    import torch
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis.train import rank_launches
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.parallel.rehearsal import rehearse
    from bonai_tpu_torch.tools.profile_train import synthetic_batch
    _, fwd_name, bwd_name = ROUTES["block"]
    out = os.path.join(REPO, "build", "chip_smoke_ddp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # (a) two gloo ranks on one card against the mean of the halves
    report = rehearse(_rehearsal_config(), synthetic_batch(), out,
                      timeout=600)
    ranks = report["ranks"]
    counts = [_by_kernel(r["counts"]) for r in ranks]
    for r, c in enumerate(counts):
        _check_counts(c, {fwd_name: 3, bwd_name: 3},
                      f"ddp rehearsal rank {r}, 1 step")
    m = ranks[0]["metrics"]
    print(f"ddp: rehearsal, 2 gloo ranks on one card ({card}), "
          f"{os.path.basename(CONFIG)} full width float32, one image each: "
          f"launch to exit {report['launch_s']:.1f} s, step ms per rank "
          f"{[round(r['ms'], 1) for r in ranks]} (first step, cold; not a "
          f"scaling figure: both ranks share the card); loss {m['loss']:.5g}"
          f" grad_norm {m['grad_norm']:.5g}; weights vs the mean-of-halves "
          f"step: largest diff {report['worst']:.3g} of a tensor's largest "
          f"update ({report['moved']} of {report['tensors']} tensors "
          f"moved); launches per rank {counts}", flush=True)

    # (b) the CLI over every card, then sharded testing
    n = torch.cuda.device_count()
    cfg = _synth_config(test=True)
    cfg_path = os.path.join(out, os.path.basename(SYNTH_CONFIG))
    cfg.dump(cfg_path)
    work_dir = os.path.join(out, "wd")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RANKS, str(n), out, cfg_path,
         "--work-dir", work_dir, "--n-devices", str(n), "--max-steps",
         str(DDP_STEPS), "--options", "log_config.interval=1"], cwd=REPO,
        capture_output=True, text=True)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train --n-devices {n} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    cli_counts = [_by_kernel(c) for c in rank_launches(proc.stderr)]
    if len(cli_counts) != n or [r["iter"] for r in rows] != list(
            range(1, DDP_STEPS + 1)):
        raise AssertionError(f"train --n-devices {n}: launches of "
                             f"{len(cli_counts)} ranks, rows "
                             f"{[r['iter'] for r in rows]}")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows):
        raise AssertionError("train --n-devices: a loss is not finite")
    for r, c in enumerate(cli_counts):
        _check_counts(c, {fwd_name: 3 * DDP_STEPS, bwd_name: 3 * DDP_STEPS},
                      f"train --n-devices {n}, rank {r}, {DDP_STEPS} steps")
    strides = proc.stderr.count("Grad strides do not match bucket view")
    step_ms = [r["time"] * 1e3 for r in rows]
    print(f"ddp: train --n-devices {n} (NCCL, one rank per card, "
          f"{card}), {DDP_STEPS} steps of the 2x synthetic recipe from "
          f"files, global batch {cfg.data.samples_per_gpu * n}: "
          f"{cli_s:.1f} s incl. start-up; ms per step "
          f"{[round(x, 1) for x in step_ms]}, median of the warm steps "
          f"{statistics.median(step_ms[1:]):.1f} against "
          f"{files_step_ms:.1f} in the data phase (one process, no DDP); "
          f"losses {[r['loss'] for r in rows]}; 'grad strides do not match "
          f"bucket view' warnings: {strides}; launches per rank "
          f"{cli_counts}", flush=True)

    pkl = os.path.join(out, "sharded.pkl")
    t0 = time.perf_counter()
    rc = parallel.launch(_sharded_test_rank, n, "cuda", cfg,
                         latest_checkpoint(work_dir), pkl, work_dir=out,
                         timeout=600)
    if rc:
        raise AssertionError(f"the sharded test's ranks exited {rc}")
    infer_s = time.perf_counter() - t0
    with open(pkl, "rb") as f:
        got = pickle.load(f)
    results, infer = got["results"], got["ranks"]
    if len(results) != 4 or not all(
            np.isfinite(res[0][0]).all() and len(res[0][0]) == len(res[1][0])
            == len(res[2]) for res in results):
        raise AssertionError("sharded run_inference: malformed results")
    infer_counts = [_by_kernel(c) for _, c in infer]
    per_rank = -(-4 // n)
    batches = -(-per_rank // cfg.data.samples_per_gpu)
    for r, c in enumerate(infer_counts):
        _check_counts(c, {fwd_name: 3 * batches},
                      f"sharded run_inference, rank {r}")
    print(f"ddp: run_inference of the 4 val crops sharded over {n} rank(s) "
          f"({card}): {infer_s:.1f} s incl. start-up and model load; "
          f"run_inference ms per rank {[round(t, 1) for t, _ in infer]}; "
          f"detections per crop {[len(res[0][0]) for res in results]}; "
          f"launches per rank {infer_counts}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return dict(rehearsal=counts, cli=cli_counts, test=infer_counts)


def loft_phase():
    """LOFT with the plain ``OffsetHead`` (``configs/loft/
    loft_r50_fpn_2x_bonai.py``) at full width with seeded random weights
    and the ``'block'`` route: serving (one batch, B=2, 1024^2, bf16, then
    ``inference_detector``; a small float32 input against the plain
    route), and 3 training steps on the repeated synthetic batch.  Returns
    the launch counts."""
    serve, _ = serve_phase("block", LOFT_CONFIG, calls=1, label="loft serve")
    train = train_phase("block", 3, LOFT_CONFIG, label="loft train")
    return dict(serve=serve, train=train)


def _trunk_ms(models, reps=5):
    """Backbone + neck ms of a 1024^2 B=2 bfloat16 batch for each of
    ``models`` (label -> model), timed in turns (a, b, b, a), the median of
    ``reps`` synchronised calls each."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import prepare_batch
    r = np.random.RandomState(0)
    imgs = [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
            for _ in range(BATCH)]
    times = {k: [] for k in models}
    order = list(models) + list(models)[::-1]
    with torch.inference_mode():
        for label in order:
            model = models[label]
            img = prepare_batch(model, imgs)[0].to(
                next(model.parameters()).dtype)
            model.extract_feat(img)
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.extract_feat(img)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def _calibrated_weights(config, path):
    """Seeded random weights of ``config`` (``init_weights``, seed 0) with
    the stored statistics of every backbone BatchNorm set to those of its
    input on a random 1024^2 B=2 batch, so that each one's output has unit
    variance, as a trained network's has.  With identity statistics
    HRNet's fuse sums grow from module to module, to head outputs of about
    5e8.  Saves them to ``path`` as an mmdet ``.pth``."""
    import numpy as np
    import torch
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.models.backbones.resnet import FrozenBatchNorm2d
    model = init_detector(_config("block", config), seed=0,
                          dtype=torch.float32)
    r = np.random.RandomState(0)
    img = prepare_batch(model, [r.randint(0, 256, (SIZE, SIZE, 3), np.uint8)
                                for _ in range(BATCH)])[0]

    def calibrate(bn, args):
        bn.running_mean.copy_(args[0].mean((0, 2, 3)))
        bn.running_var.copy_(args[0].var((0, 2, 3)))
    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.backbone.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    with torch.no_grad():
        model.extract_feat(img)
    for h in hooks:
        h.remove()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()}}, path)
    print(f"calibrated the {len(hooks)} backbone BatchNorms of "
          f"{os.path.basename(config)} on a random batch", flush=True)
    del model
    torch.cuda.empty_cache()


def hrnet_phase(r50_serve_ms, r50_step_ms):
    """LOFT-FOA on HRNet-W32 + HRFPN (``configs/hrnet/
    loft_foa_hrnetv2p_w32_2x_bonai.py``) at full width with seeded random
    weights (``_calibrated_weights``) and the ``'block'`` route: serving
    (one batch, B=2, 1024^2, bf16, then ``inference_detector``; a small
    float32 input against the plain route), 3 training steps on the
    repeated synthetic batch, and the backbone + neck time of a serve
    batch beside LOFT-FOA R50-FPN's (``r50_*``: the serve and train
    phases' numbers of this run).  Returns the launch counts."""
    import torch
    from bonai_tpu_torch.apis import init_detector
    weights = os.path.join(REPO, "build", "chip_smoke_hrnet", "init.pth")
    _calibrated_weights(HRNET_CONFIG, weights)
    serve, serve_ms = serve_phase("block", HRNET_CONFIG, calls=1,
                                  label="hrnet serve", checkpoint=weights)
    # at the base LR: the warmup's first LRs (5e-6 to 2e-5) times the
    # weight decay (1e-4) move conv2/bn2 by less than a float32 ulp
    train = train_phase("block", 3, HRNET_CONFIG, label="hrnet train",
                        warmup=False, load_from=weights)
    shutil.rmtree(os.path.dirname(weights), ignore_errors=True)
    models = {"HRNet-W32 + HRFPN": init_detector(_config("block",
                                                         HRNET_CONFIG)),
              "R50 + FPN": init_detector(_config("block"))}
    trunk = _trunk_ms(models)
    del models
    torch.cuda.empty_cache()
    print(f"hrnet: serve {serve_ms:.1f} ms a B=2 call (LOFT-FOA R50-FPN "
          f"{r50_serve_ms:.1f} in this run); train median step "
          f"{train['step_ms']:.1f} ms (R50 {r50_step_ms:.1f}), peak "
          f"{train['peak_gib']:.2f} GiB; backbone + neck of a 1024^2 B=2 "
          f"bf16 batch " + ", ".join(f"{k} {v:.2f} ms"
                                      for k, v in trunk.items())
          + f"; B1 {serve} launches serving, B1 {train['fwd']} / B2 "
          f"{train['bwd']} training", flush=True)
    return dict(serve=serve, train=train)


def rcnn_phase():
    """The R-CNN baselines on BONAI (``RCNN_CONFIGS``: Mask R-CNN, Cascade
    Mask R-CNN, Dynamic R-CNN) at full width with seeded random weights and
    the ``'block'`` route: one serve batch (B=2, 1024^2, bf16) and one
    ``inference_detector`` call, a small float32 input held to the plain
    route, and training on the repeated synthetic batch (6 steps of Mask
    R-CNN, 3 of the others; the RoI branches' gradients held to the plain
    route).  Then the test and evaluation CLIs on the Mask R-CNN's 6-step
    checkpoint, on the first of the eval phase's val crops.  Returns each
    config's launch counts and times."""
    out = {}
    for label, config, steps in RCNN_CONFIGS:
        config = os.path.join(REPO, config)
        serve, serve_ms = serve_phase("block", config, calls=1,
                                      label=f"{label} serve")
        train = train_phase("block", steps, config, label=f"{label} train",
                            keep=label in COCO_SCORED)
        out[label] = dict(serve=serve, serve_ms=serve_ms, train=train)
    for label, config, _ in RCNN_CONFIGS:
        if label in COCO_SCORED:
            out[label]["coco_cli"] = rcnn_coco(
                label, os.path.join(REPO, config),
                out[label]["train"]["checkpoint"])
    coco_planted(os.path.join(REPO, RCNN_CONFIGS[0][1]))
    shutil.rmtree(out["dynamic"]["train"]["work_dir"], ignore_errors=True)
    train = out["mask_rcnn"]["train"]
    out["mask_rcnn"]["test_cli"] = rcnn_eval(
        os.path.join(REPO, RCNN_CONFIGS[0][1]), train["checkpoint"],
        train["work_dir"])
    for label, r in out.items():
        print(f"rcnn {label}: serve {r['serve_ms']:.1f} ms a B=2 call, B1 "
              f"{r['serve']} launches; train median step "
              f"{r['train']['step_ms']:.1f} ms, peak "
              f"{r['train']['peak_gib']:.2f} GiB, B1 {r['train']['fwd']} / "
              f"B2 {r['train']['bwd']} launches", flush=True)
    return out


def _crop_test_cfg(config):
    """``config`` with the ``'block'`` route and the eval phase's four val
    crops as its test set."""
    cfg = _config("block", config)
    cfg.data.test.update(
        ann_file=os.path.join(DATA_DIR, "val", "val.json"),
        img_prefix=os.path.join(DATA_DIR, "val", "images") + "/")
    return cfg


def rcnn_coco(label, config, checkpoint):
    """COCO-style scoring of an R-CNN baseline's checkpoint: the generic
    test CLI (``bonai_tpu_torch.tools.test``) on the card with ``--eval``
    of ``COCO_SCORED[label]`` on the first of the eval phase's val crops.
    Returns the forward kernel's launches in the run."""
    import math
    import torch
    from bonai_tpu_torch.config import Config
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.evaluation import evaluate_coco
    from bonai_tpu_torch.tools import test as test_cli
    _, fwd_name, _ = ROUTES["block"]
    kinds, calls = COCO_SCORED[label]
    out_dir = os.path.join(REPO, "build", "chip_smoke_coco")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(config))
    _crop_test_cfg(config).dump(cfg_path)
    _zero_counts()
    t0 = time.perf_counter()
    results, metrics = test_cli.main([
        cfg_path, checkpoint, "--out", os.path.join(out_dir, "r.pkl"),
        "--eval", *kinds, "--max-images", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {fwd_name: calls}, f"{label} COCO test CLI, "
                  "1 batch")
    ds = build_dataset(dict(Config.fromfile(cfg_path).data.test,
                            test_mode=True))
    t0 = time.perf_counter()
    if evaluate_coco(ds, results, metric_types=kinds) != metrics:
        raise AssertionError(f"{label} COCO scoring is not repeatable")
    score_s = time.perf_counter() - t0
    keys = [f"{k}_mAP{s}" for k in kinds for s in ("", "_50", "_75")]
    if len(results) != 1 or list(metrics) != keys or not all(
            math.isfinite(v) and (0.0 <= v <= 1.0 or v == -1.0)
            for v in metrics.values()):
        raise AssertionError(f"{label} COCO scoring: {len(results)} results, "
                             f"metrics {metrics}")
    boxes = results[0][0] if isinstance(results[0], tuple) else results[0]
    print(f"rcnn {label} coco: tools.test --eval {' '.join(kinds)} on 1 of "
          f"4 val crops, {len(boxes[0])} detections, {cli_s:.1f} s (model "
          f"build, test, scoring; the scoring alone {score_s:.2f} s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; launches {counts}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts[fwd_name]


def coco_planted(config):
    """The COCO planted check: the four val crops' own GTs as results
    (score 1, full-size RLE masks) must score ``bbox_mAP == segm_mAP ==
    1.0`` and VOC ``mAP == 1.0`` through ``CocoDataset.evaluate``."""
    import numpy as np
    from bonai_tpu_torch.datasets import build_dataset, mask_utils
    cfg = _crop_test_cfg(config)
    ds = build_dataset(dict(cfg.data.test, test_mode=True))
    results = []
    for i, info in enumerate(ds.data_infos):
        ann = ds.get_ann_info(i)
        dets = np.concatenate([ann["bboxes"], np.ones(
            (len(ann["bboxes"]), 1), np.float32)], 1)
        results.append(([dets], [[mask_utils.encode_mask(
            mask_utils.poly_to_mask(m, info["height"], info["width"]))
            for m in ann["masks"]]]))
    t0 = time.perf_counter()
    got = ds.evaluate(results, metric=["bbox", "segm", "mAP", "recall"])
    eval_s = time.perf_counter() - t0
    print(f"coco planted ({len(results)} crops, "
          f"{sum(len(r[0][0]) for r in results)} GTs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in got.items())
          + f"; {eval_s:.2f} s", flush=True)
    if not got["bbox_mAP"] == got["segm_mAP"] == got["mAP"] == 1.0:
        raise AssertionError(f"COCO planted check: {got}")


def rcnn_eval(config, checkpoint, work_dir):
    """The test CLI on the card with ``config`` and ``checkpoint`` on the
    first of the eval phase's val crops (a 2-tuple pkl: boxes and roof
    masks, no offsets), then the evaluation CLI on it.  Removes
    ``work_dir`` (the checkpoint's) at the end.  Returns B1's launches in
    the test CLI's run."""
    import numpy as np
    import torch
    from bonai_tpu_torch.tools import bonai_evaluation, bonai_test
    _, fwd_name, _ = ROUTES["block"]
    cfg = _crop_test_cfg(config)
    crops = cfg.data.test.ann_file
    out_dir = os.path.join(REPO, "build", "chip_smoke_rcnn_eval")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg_path = os.path.join(out_dir, os.path.basename(config))
    cfg.dump(cfg_path)
    pkl = os.path.join(out_dir, "results.pkl")
    _zero_counts()
    t0 = time.perf_counter()
    payload = bonai_test.main([cfg_path, checkpoint, "--out", pkl, "--city",
                               "config", "--max-images", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    _check_counts(counts, {fwd_name: 2}, "rcnn test CLI, 1 batch")
    results = payload["results"]
    if len(results) != 1:
        raise AssertionError(f"rcnn test CLI: {len(results)} results")
    for res in results:
        if not (isinstance(res, tuple) and len(res) == 2
                and res[0][0].shape[1:] == (5,)
                and len(res[1][0]) == len(res[0][0])
                and np.isfinite(res[0][0]).all()
                and all(m["size"] == [SIZE, SIZE] for m in res[1][0])):
            raise AssertionError("the rcnn test CLI's results are not "
                                 "(bbox, segm) 2-tuples")
    t0 = time.perf_counter()
    summary = bonai_evaluation.main([pkl, "--gt-json", crops])
    eval_s = time.perf_counter() - t0
    print(f"rcnn mask_rcnn eval: test CLI {cli_s:.1f} s (model build, 1 of "
          f"{len(payload['filenames'])} crops, bf16), "
          f"{len(results[0][0][0])} detections; evaluation CLI {eval_s:.1f} "
          f"s: {_scores(summary)}; launches {counts}", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(work_dir, ignore_errors=True)
    return counts[fwd_name]


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
    serve_runs = {impl: serve_phase(impl) for impl in ("block", "pallas")}
    serve = {impl: run[0] for impl, run in serve_runs.items()}
    train = {impl: train_phase(impl, steps)
             for impl, steps in (("block", 6), ("pallas", 4))}
    files = data_phase()
    test_cli_launches = eval_phase(files["checkpoint"], files["work_dir"])
    resume_launches = resume_phase()
    _check_counts({name: resume_launches.get(
        fn.__name__, 0) for name, (fn, _, _) in _kernels().items()},
        {"roi_align_block_fwd": 3 * RESUME_STEPS,
         "roi_align_block_bwd": 3 * RESUME_STEPS},
        f"chunked training, {RESUME_STEPS} steps in two processes")
    print(f"compare train: from files {files['step_ms']:.1f} ms a step vs "
          f"the repeated synthetic batch {train['block']['step_ms']:.1f} ms "
          f"(same route, this run); the loader gives "
          f"{files['cold']:.1f} images/s cold, {files['warm']:.1f} warm, "
          f"against {2e3 / files['step_ms']:.1f} images/s the step takes",
          flush=True)
    ddp = ddp_phase(card, files["step_ms"])
    loft = loft_phase()
    hrnet = hrnet_phase(serve_runs["block"][1], train["block"]["step_ms"])
    rcnn = rcnn_phase()
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
                train_from_files_launches=files["fwd"],
                test_cli_launches=test_cli_launches,
                train_chunked_launches=resume_launches["roi_align_block"],
                ddp_rehearsal_launches=[c["roi_align_block_fwd"]
                                        for c in ddp["rehearsal"]],
                ddp_cli_launches=[c["roi_align_block_fwd"]
                                  for c in ddp["cli"]],
                ddp_test_launches=[c["roi_align_block_fwd"]
                                   for c in ddp["test"]],
                loft_serve_launches=loft["serve"],
                loft_train_launches=loft["train"]["fwd"],
                hrnet_serve_launches=hrnet["serve"],
                hrnet_train_launches=hrnet["train"]["fwd"],
                **{f"rcnn_{k}_serve_launches": r["serve"]
                   for k, r in rcnn.items()},
                **{f"rcnn_{k}_train_launches": r["train"]["fwd"]
                   for k, r in rcnn.items()},
                rcnn_mask_rcnn_test_cli_launches=rcnn["mask_rcnn"][
                    "test_cli"],
                **{f"rcnn_{k}_coco_cli_launches": rcnn[k]["coco_cli"]
                   for k in COCO_SCORED}),
        _entry("roi_align_block_bwd", "train (block)", train["block"]["bwd"],
               sums["roi_align_block_bwd", "train"],
               train_from_files_launches=files["bwd"],
               train_chunked_launches=resume_launches[
                   "roi_align_block_backward"],
               ddp_rehearsal_launches=[c["roi_align_block_bwd"]
                                       for c in ddp["rehearsal"]],
               ddp_cli_launches=[c["roi_align_block_bwd"]
                                 for c in ddp["cli"]],
               loft_train_launches=loft["train"]["bwd"],
               hrnet_train_launches=hrnet["train"]["bwd"],
               **{f"rcnn_{k}_train_launches": r["train"]["bwd"]
                  for k, r in rcnn.items()}),
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
