"""bonai_tpu_torch CUDA kernels on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no
CPU mode) and skip without one.  They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The RoIAlign forward kernel (under the block and the strip level rule,
and in its window-64 mode) is held to its plain versions: float32 to 1e-4,
bfloat16 to one bf16 ulp (2**-7 relative).  The
backward kernel (under both rules) is held to autograd through the plain
version: float32 to 1e-4 of each level's largest gradient (the two sum in
different orders), bfloat16 to one bf16 ulp plus 1e-5 of the level's
largest gradient (both round once from float32 sums taken in different
orders).  The levels the forward kernel computes must equal the torch
rules' on every RoI, the rules' edges included.  The R-CNN baselines
(Mask, Cascade Mask and Dynamic R-CNN at tiny widths, ``'block'`` route)
launch the forward kernel once per RoI call of a serve batch and both
kernels once per RoI call of a training step, as does LOFT-FOA on HRNet +
HRFPN.  A two-rank data-parallel
step (gloo, both ranks on one card) must equal the step of the mean of
its two half-batch gradients within 1e-4 of each tensor's largest update.
"""

import numpy as np
import pytest
import torch

from torch_port_common import edge_rois, tiny_cfg

STRIDES = [4, 8, 16, 32]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fixture(seed, C, n=300, B=2, S=512):
    """Pyramid and RoIs with pushed (wide, tall), border and invalid
    rows."""
    r = np.random.RandomState(seed)
    feats = [torch.from_numpy(r.randn(B, S // s, S // s, C)
                              .astype(np.float32)).cuda() for s in STRIDES]
    xy = r.uniform(-20, S, (n, 2))
    wh = np.exp(r.uniform(1.4, 6.0, (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[:20] = [[8, 40, 248, 100]] * 10 + [[20, 4, 80, 250]] * 10
    rois = np.concatenate([r.randint(0, B, (n, 1)), boxes], 1)
    valid = r.uniform(size=n) > 0.1
    return (feats, torch.from_numpy(rois.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,C", [(7, 256), (14, 64)])
def test_block_kernel_matches_plain_version(dtype, out_size, C):
    _need_cuda()
    from bonai_tpu_torch.ops import roi_align_block, roi_align_block_ref
    feats, rois, valid = _fixture(out_size, C)
    args = ([f.to(dtype) for f in feats], rois, out_size, STRIDES)
    before = roi_align_block.launches
    got = roi_align_block(*args, roi_valid=valid)
    torch.cuda.synchronize()
    assert roi_align_block.launches == before + 1
    ref = roi_align_block_ref(*args, roi_valid=valid)
    assert got.dtype == dtype and got.shape == ref.shape
    assert not got[~valid].any()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= ref.float().abs() * 2 ** -7 + 1e-6).all())


@pytest.mark.cuda
def test_detector_runs_the_block_kernel():
    """On CUDA tensors the detector's three RoI branches go through the
    kernel: three launches per simple_test."""
    _need_cuda()
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.ops import roi_align_block
    cfg = tiny_cfg()
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = init_detector(cfg, device="cuda", dtype=torch.float32)
    r = np.random.RandomState(0)
    img, shape, scale, _ = prepare_batch(
        model, [r.randint(0, 255, (100, 128, 3), np.uint8)] * 2)
    before = roi_align_block.launches
    out = model.simple_test(img, shape, scale)
    torch.cuda.synchronize()
    assert roi_align_block.launches == before + 3
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.is_floating_point())


def _level_grads(fn, feats, dtype, rois, valid, out_size, cot):
    """Gradients of ``sum(fn(levels) * cot)`` with respect to each level."""
    levels = [f.to(dtype, copy=True).requires_grad_() for f in feats]
    out = fn(levels, rois, out_size, STRIDES, roi_valid=valid)
    torch.autograd.backward(out, cot.to(dtype))
    return out, [lv.grad for lv in levels]


def _check_level_grads(got, ref, dtype):
    """Each level's gradient against autograd through the plain version."""
    for g, e, s in zip(got, ref, STRIDES):
        assert g.dtype == dtype and g.shape == e.shape and g.is_contiguous()
        top = float(e.float().abs().max())
        assert top > 0, f"stride {s}: no gradient reached this level"
        diff = (g.float() - e.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-4 * top, (s, float(diff.max()))
        else:
            bound = e.float().abs() * 2 ** -7 + 1e-5 * top
            assert bool((diff <= bound).all()), (s, float(diff.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,C", [(7, 256), (14, 64)])
def test_block_backward_kernel_matches_plain_version(dtype, out_size, C):
    """Overlapping RoIs (repeated rows), RoIs the block rule pushes
    coarser, border and invalid RoIs, and a few large enough for the
    coarsest level."""
    _need_cuda()
    from bonai_tpu_torch.ops import (roi_align_block, roi_align_block_backward,
                                     roi_align_block_ref)
    feats, rois, valid = _fixture(out_size + 1, C)
    large = torch.tensor([[0, 20, 30, 500, 470], [1, 0, 40, 511, 511],
                          [1, -10, -10, 450, 480]], device="cuda")
    rois = torch.cat([rois, rois[:40], large])   # the same corners twice
    valid = torch.cat([valid, valid[:40], torch.ones(3, dtype=torch.bool,
                                                     device="cuda")])
    cot = torch.randn(rois.shape[0], out_size, out_size, C,
                      generator=torch.Generator().manual_seed(0)).cuda()
    before = roi_align_block_backward.launches
    out, got = _level_grads(roi_align_block, feats, dtype, rois, valid,
                            out_size, cot)
    torch.cuda.synchronize()
    assert roi_align_block_backward.launches == before + 1
    assert out.grad_fn is not None
    _, ref = _level_grads(roi_align_block_ref, feats, dtype, rois, valid,
                          out_size, cot)
    _check_level_grads(got, ref, dtype)


@pytest.mark.cuda
def test_block_backward_takes_channels_last_levels():
    """The detector hands the Function NHWC views of channels-last maps;
    the gradient comes back in that layout and the RoIs get none."""
    _need_cuda()
    from bonai_tpu_torch.ops import roi_align_block
    feats, rois, valid = _fixture(3, 64)
    maps = [f.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_() for f in feats]
    rois.requires_grad_()
    out = roi_align_block([m.permute(0, 2, 3, 1) for m in maps], rois, 7,
                          STRIDES, roi_valid=valid)
    out.float().square().sum().backward()
    assert rois.grad is None
    for m in maps:
        assert m.grad.is_contiguous(memory_format=torch.channels_last)
        assert bool(torch.isfinite(m.grad).all())


@pytest.mark.cuda
def test_train_step_runs_both_kernels(tmp_path):
    """One tiny training step on the card: the three RoI branches launch
    the forward and the backward kernel once each, and every gradient is
    finite."""
    _need_cuda()
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.ops import roi_align_block, roi_align_block_backward
    from torch_port_common import tiny_train_cfg, train_batch
    fwd, bwd = roi_align_block.launches, roi_align_block_backward.launches
    model, hist = train_detector(tiny_train_cfg(), [train_batch()],
                                 str(tmp_path), max_steps=1, log_interval=1,
                                 n_devices=1)
    assert roi_align_block.launches - fwd == 3
    assert roi_align_block_backward.launches - bwd == 3
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


# the R-CNN baselines: config, RoIAlign calls a batch or step makes
RCNN = {"mask_rcnn": ("MASK_RCNN_CONFIG", 2),
        "cascade": ("CASCADE_CONFIG", 4),
        "dynamic": ("DYNAMIC_CONFIG", 1)}


def _rcnn_cfg(family, train=False):
    import torch_port_common as tpc
    config, calls = RCNN[family]
    cfg = (tpc.tiny_train_cfg if train else tpc.tiny_cfg)(
        config=getattr(tpc, config))
    cfg.model.roi_align_impl = "block"
    return cfg, calls


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(RCNN))
def test_rcnn_serve_batch_runs_the_block_kernel(family):
    """One serve batch of each R-CNN baseline: one forward launch per RoI
    call (box stages and mask), finite outputs, a mask only where the
    model has a mask head."""
    _need_cuda()
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.ops import roi_align_block
    cfg, calls = _rcnn_cfg(family)
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = init_detector(cfg, device="cuda", dtype=torch.float32)
    r = np.random.RandomState(0)
    img, shape, scale, _ = prepare_batch(
        model, [r.randint(0, 255, (100, 128, 3), np.uint8)] * 2)
    before = roi_align_block.launches
    out = model.simple_test(img, shape, scale)
    torch.cuda.synchronize()
    assert roi_align_block.launches == before + calls
    assert ("mask_probs" in out) == (family != "dynamic")
    assert "offsets" not in out
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.is_floating_point())


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(RCNN))
def test_rcnn_train_step_runs_both_kernels(family, tmp_path):
    """One tiny training step of each R-CNN baseline on the card: both
    kernels once per RoI call, finite losses and weights."""
    _need_cuda()
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.ops import roi_align_block, roi_align_block_backward
    from torch_port_common import train_batch
    cfg, calls = _rcnn_cfg(family, train=True)
    fwd, bwd = roi_align_block.launches, roi_align_block_backward.launches
    model, hist = train_detector(cfg, [train_batch()], str(tmp_path),
                                 max_steps=1, log_interval=1, n_devices=1)
    assert roi_align_block.launches - fwd == calls
    assert roi_align_block_backward.launches - bwd == calls
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.cuda
def test_hrnet_loft_runs_the_block_kernels(tmp_path):
    """LOFT-FOA on HRNet + HRFPN at tiny widths on the card, ``'block'``:
    a serve batch launches the forward kernel once per RoI call (box, mask,
    offset), a training step both kernels as often; finite outputs, losses
    and weights, and ``conv2`` (behind the gradient stop) moved by weight
    decay."""
    _need_cuda()
    import torch_port_common as tpc
    from bonai_tpu_torch.apis import (init_detector, prepare_batch,
                                      train_detector)
    from bonai_tpu_torch.ops import roi_align_block, roi_align_block_backward
    cfg = tpc.tiny_cfg(config=tpc.HRNET_CONFIG)
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = init_detector(cfg, device="cuda", dtype=torch.float32)
    r = np.random.RandomState(0)
    img, shape, scale, _ = prepare_batch(
        model, [r.randint(0, 255, (100, 128, 3), np.uint8)] * 2)
    before = roi_align_block.launches
    out = model.simple_test(img, shape, scale)
    torch.cuda.synchronize()
    assert roi_align_block.launches == before + 3
    assert {"mask_probs", "offsets"} <= set(out)
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.is_floating_point())
    cfg = tpc.tiny_train_cfg(tpc.HRNET_CONFIG)
    # the base LR: the warmup's first LR times the weight decay would move
    # conv2 by less than a float32 ulp
    cfg.lr_config.warmup = None
    fwd, bwd = roi_align_block.launches, roi_align_block_backward.launches
    model, hist = train_detector(cfg, [tpc.train_batch()], str(tmp_path),
                                 max_steps=1, log_interval=1, n_devices=1)
    assert roi_align_block.launches - fwd == 3
    assert roi_align_block_backward.launches - bwd == 3
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    init = init_detector(cfg, device="cuda", dtype=torch.float32, seed=0)
    assert not torch.equal(model.backbone.conv2.weight,
                           init.backbone.conv2.weight)
    assert torch.equal(model.backbone.conv1.weight, init.backbone.conv1.weight)


def _strip_fixture(seed, C, n=300, B=2, S=512):
    """``_fixture`` plus RoIs for the strip rules: wide, flat ones kept at
    level 0 by the gather rule (window cut of the window-64 kernel; pushed
    by the fused one) and ones over the border in y."""
    feats, rois, valid = _fixture(seed, C, n, B, S)
    extra = torch.tensor([[0, 10, 50, 430, 55], [1, 60, 300, 500, 304],
                          [0, -10, -40, 80, 30], [1, 300, 480, 380, 560],
                          [1, 0, 0, 511, 511]], dtype=torch.float32,
                         device="cuda")
    return (feats, torch.cat([rois, extra]),
            torch.cat([valid, torch.ones(5, dtype=torch.bool,
                                         device="cuda")]))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "strip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,C", [(7, 256), (14, 64)])
def test_strip_kernels_match_plain_version(route, dtype, out_size, C):
    _need_cuda()
    from bonai_tpu_torch import ops
    fn = getattr(ops, f"roi_align_{route}")
    ref_fn = getattr(ops, f"roi_align_{route}_ref")
    feats, rois, valid = _strip_fixture(out_size + 2, C)
    args = ([f.to(dtype) for f in feats], rois, out_size, STRIDES)
    before = fn.launches
    got = fn(*args, roi_valid=valid)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = ref_fn(*args, roi_valid=valid)
    assert got.dtype == dtype and got.shape == ref.shape
    assert not got[~valid].any()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    else:
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= ref.float().abs() * 2 ** -7 + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size,C", [(7, 256), (14, 64)])
def test_fused_backward_kernel_matches_plain_version(dtype, out_size, C):
    """Overlapping RoIs, pushed, border and invalid RoIs, and RoIs on the
    coarsest level (narrower than the 48-cell strip)."""
    _need_cuda()
    from bonai_tpu_torch.ops import (roi_align_fused, roi_align_fused_backward,
                                     roi_align_fused_ref)
    feats, rois, valid = _strip_fixture(out_size + 3, C)
    large = torch.tensor([[0, 20, 30, 500, 470], [1, 0, 40, 511, 511],
                          [1, -10, -10, 450, 480]], device="cuda")
    rois = torch.cat([rois, rois[:40], large])
    valid = torch.cat([valid, valid[:40], torch.ones(3, dtype=torch.bool,
                                                     device="cuda")])
    cot = torch.randn(rois.shape[0], out_size, out_size, C,
                      generator=torch.Generator().manual_seed(1)).cuda()
    before = roi_align_fused_backward.launches
    out, got = _level_grads(roi_align_fused, feats, dtype, rois, valid,
                            out_size, cot)
    torch.cuda.synchronize()
    assert roi_align_fused_backward.launches == before + 1
    assert out.grad_fn is not None
    _, ref = _level_grads(roi_align_fused_ref, feats, dtype, rois, valid,
                          out_size, cot)
    _check_level_grads(got, ref, dtype)


@pytest.mark.cuda
def test_detector_pallas_route_runs_the_fused_kernel():
    """With roi_align_impl='pallas' the three RoI branches go through the
    strip forward kernel, and the block kernel does not run."""
    _need_cuda()
    from bonai_tpu_torch.apis import init_detector, prepare_batch
    from bonai_tpu_torch.ops import roi_align_block, roi_align_fused
    cfg = tiny_cfg()
    cfg.model.roi_align_impl = "pallas"
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    model = init_detector(cfg, device="cuda", dtype=torch.float32)
    r = np.random.RandomState(0)
    img, shape, scale, _ = prepare_batch(
        model, [r.randint(0, 255, (100, 128, 3), np.uint8)] * 2)
    fused, block = roi_align_fused.launches, roi_align_block.launches
    out = model.simple_test(img, shape, scale)
    torch.cuda.synchronize()
    assert roi_align_fused.launches - fused == 3
    assert roi_align_block.launches == block
    assert all(bool(torch.isfinite(v).all()) for v in out.values()
               if v.is_floating_point())


@pytest.mark.cuda
def test_train_step_pallas_route_runs_the_strip_kernels(tmp_path):
    """One tiny training step with roi_align_impl='pallas': the strip
    forward and backward kernels launch three times each, the block ones
    not at all."""
    _need_cuda()
    from bonai_tpu_torch.apis import train_detector
    from bonai_tpu_torch.ops import (roi_align_block, roi_align_fused,
                                     roi_align_fused_backward)
    from torch_port_common import tiny_train_cfg, train_batch
    cfg = tiny_train_cfg()
    cfg.model.roi_align_impl = "pallas"
    counts = (roi_align_fused.launches, roi_align_fused_backward.launches,
              roi_align_block.launches)
    model, hist = train_detector(cfg, [train_batch()], str(tmp_path),
                                 max_steps=1, log_interval=1, n_devices=1)
    assert roi_align_fused.launches - counts[0] == 3
    assert roi_align_fused_backward.launches - counts[1] == 3
    assert roi_align_block.launches == counts[2]
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_size", [7, 14])
def test_fused_kernels_past_the_strip_window(dtype, out_size):
    """RoIs over 48 cells wide at the coarsest level of a 2048-px-wide
    pyramid, wider than the forward's and the backward's 48-cell strip:
    their corners past the strip are read from (forward) and added into
    (backward) the level buffers directly."""
    _need_cuda()
    from bonai_tpu_torch.ops import (roi_align_fused, roi_align_fused_ref,
                                     strip_levels)
    r = np.random.RandomState(out_size)
    feats = [torch.from_numpy(r.randn(1, 256 // s, 2048 // s, 64)
                              .astype(np.float32)).cuda() for s in STRIDES]
    wide = np.array([[10, 20, 2000, 230], [100, 100, 1800, 140],
                     [-30, 0, 2100, 256], [300, 60, 1900, 61]], np.float32)
    xy = r.uniform(0, 2048, (40, 2)) * [1, 0.125]
    wh = np.exp(r.uniform(1.4, 6.0, (40, 2)))
    boxes = np.concatenate([wide, np.concatenate([xy, xy + wh], 1)])
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((len(boxes), 1)), boxes], 1).astype(np.float32)).cuda()
    valid = torch.ones(len(boxes), dtype=torch.bool, device="cuda")
    assert strip_levels(rois[:4, 1:5], STRIDES).tolist() == [3] * 4
    assert bool(((rois[:4, 3] - rois[:4, 1]) / STRIDES[-1] > 48).all())
    cot = torch.randn(len(boxes), out_size, out_size, 64,
                      generator=torch.Generator().manual_seed(2)).cuda()
    out, got = _level_grads(roi_align_fused, feats, dtype, rois, valid,
                            out_size, cot)
    ref_out, ref = _level_grads(roi_align_fused_ref, feats, dtype, rois,
                                valid, out_size, cot)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    else:
        diff = (out.float() - ref_out.float()).abs()
        assert bool((diff <= ref_out.float().abs() * 2 ** -7 + 1e-6).all())
    _check_level_grads(got, ref, dtype)


ROUTES = {"block": ("roi_align_block", "roi_align_block_backward",
                    "roi_align_block_ref", "block_levels"),
          "fused": ("roi_align_fused", "roi_align_fused_backward",
                    "roi_align_fused_ref", "strip_levels"),
          "strip": ("roi_align_strip", None, "roi_align_strip_ref", None)}


def _route(name):
    """The route's wrapper, backward (``None``: forward only), plain
    version and level rule."""
    from bonai_tpu_torch import ops
    from bonai_tpu_torch.ops.roi_align_strip import gather_levels
    fn, bwd, ref_fn, rule = [None if n is None else getattr(ops, n)
                             for n in ROUTES[name]]
    return fn, bwd, ref_fn, rule or gather_levels


def _forward(fn, feats, dtype, rois, valid, out_size, **kw):
    """The forward alone, for the forward-only route."""
    with torch.no_grad():
        return fn([f.to(dtype) for f in feats], rois, out_size, STRIDES,
                  roi_valid=valid, **kw)


def _touched(shapes, rois, valid, lvl, out_size):
    """Per level, a bool (B, Hl, Wl) map of the cells that a corner of
    nonzero weight of a valid RoI lands on."""
    from bonai_tpu_torch.ops.roi_align import corner_plan
    corners, weights = corner_plan(shapes, rois, lvl, out_size, STRIDES,
                                   roi_valid=valid)
    rows = torch.cat([c[w != 0] for c, w in zip(corners, weights)])
    flat = torch.zeros(sum(s[0] * s[1] * s[2] for s in shapes),
                       dtype=torch.bool, device=rois.device)
    flat[rows] = True
    sizes = [s[0] * s[1] * s[2] for s in shapes]
    return [m.reshape(s[:3]) for m, s in zip(flat.split(sizes), shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused", "strip"])
@pytest.mark.parametrize("n", [0, 1, 3000])
def test_kernels_at_roi_counts(route, n):
    """No RoI, one RoI and 3000 (more than a tile's RoI scan takes at a
    time), float32, C=64: the forward against the plain version, the level
    gradients against autograd through it; with no RoI every gradient is
    exactly zero, with one only its level's is not.  The forward-only
    window-64 route: its forward, launched once where there is an RoI."""
    _need_cuda()
    fn, bwd, ref_fn, _ = _route(route)
    feats, rois, valid = _fixture(n + 4, 64, n=max(n, 20))
    rois, valid = rois[:n].contiguous(), valid[:n].contiguous()
    if n == 1:
        valid[:] = True
    if bwd is None:
        before = fn.launches
        out = _forward(fn, feats, torch.float32, rois, valid, 7)
        torch.cuda.synchronize()
        assert fn.launches == before + bool(n)
        assert out.shape == (n, 7, 7, 64)
        torch.testing.assert_close(out, _forward(ref_fn, feats, torch.float32,
                                                 rois, valid, 7),
                                   rtol=1e-4, atol=1e-4)
        return
    cot = torch.randn(n, 7, 7, 64,
                      generator=torch.Generator().manual_seed(n)).cuda()
    before = bwd.launches
    out, got = _level_grads(fn, feats, torch.float32, rois, valid, 7, cot)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    assert out.shape == (n, 7, 7, 64)
    assert all(g.shape == f.shape for g, f in zip(got, feats))
    if n == 0:
        assert not any(bool(g.any()) for g in got)
        return
    ref_out, ref = _level_grads(ref_fn, feats, torch.float32, rois, valid, 7,
                                cot)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    for g, e in zip(got, ref):
        top = float(e.abs().max())
        assert float((g - e).abs().max()) <= 1e-4 * top
    touched = [bool(g.any()) for g in got]
    assert touched == [bool(e.any()) for e in ref]
    assert sum(touched) == 1 if n == 1 else sum(touched) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused", "strip"])
@pytest.mark.parametrize("sr", [1, 3, 5])
def test_kernels_at_other_sampling_ratios(route, sr):
    """The kernels' general sampling-ratio path (the detector uses 2; the
    window-64 route took at most 4 before its kernel became a mode of the
    forward), float32, out 7x7 and 14x14: forward and level gradients
    against the plain version (the window-64 route: its forward, on
    ``_strip_fixture``'s wide, flat and border RoIs too)."""
    _need_cuda()
    fn, bwd, ref_fn, _ = _route(route)
    feats, rois, valid = (_fixture if bwd else _strip_fixture)(50 + sr, 64)
    for out_size in (7, 14):
        if bwd is None:
            torch.testing.assert_close(
                _forward(fn, feats, torch.float32, rois, valid, out_size,
                         sampling_ratio=sr),
                _forward(ref_fn, feats, torch.float32, rois, valid, out_size,
                         sampling_ratio=sr), rtol=1e-4, atol=1e-4)
            continue
        cot = torch.randn(rois.shape[0], out_size, out_size, 64,
                          generator=torch.Generator().manual_seed(sr)).cuda()

        def grads(f):
            levels = [x.clone().requires_grad_() for x in feats]
            out = f(levels, rois, out_size, STRIDES, sampling_ratio=sr,
                    roi_valid=valid)
            torch.autograd.backward(out, cot)
            return out, [x.grad for x in levels]
        out, got = grads(fn)
        ref_out, ref = grads(ref_fn)
        torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
        for g, e in zip(got, ref):
            top = float(e.abs().max())
            assert float((g - e).abs().max()) <= 1e-4 * top


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused", "strip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_all_rois_invalid(route, dtype):
    """Every row invalid: zero outputs, and every level gradient exactly
    zero in the levels' dtype (the window-64 route: its output)."""
    _need_cuda()
    fn, bwd, _, _ = _route(route)
    feats, rois, valid = _fixture(21, 64)
    valid = torch.zeros_like(valid)
    if bwd is None:
        out = _forward(fn, feats, dtype, rois, valid, 7)
        assert out.dtype == dtype and not out.any()
        return
    cot = torch.randn(rois.shape[0], 7, 7, 64,
                      generator=torch.Generator().manual_seed(3)).cuda()
    out, got = _level_grads(fn, feats, dtype, rois, valid, 7, cot)
    assert out.dtype == dtype and not out.any()
    assert all(g.dtype == dtype and not g.any() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused"])
@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 256),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 64),
                                     (torch.float32, 64)])
def test_backward_across_tile_edges(route, dtype, C):
    """RoIs centred on the corners of the backward's 8-, 16- and 32-cell
    tiles at every level, in sizes from a fraction of a cell to the whole
    level: against autograd through the plain version, and every cell
    that no corner of nonzero weight of a valid RoI lands on is exactly
    zero."""
    _need_cuda()
    fn, _, ref_fn, rule = _route(route)
    r = np.random.RandomState(C)
    feats = [torch.from_numpy(r.randn(2, 512 // s, 512 // s, C)
                              .astype(np.float32)).cuda() for s in STRIDES]
    boxes = []
    for s in STRIDES:
        for k in (8, 16, 32):
            for size in (0.5, 3, 9, 20, 40):
                cx, cy = k * s * r.randint(1, max(2, 512 // (k * s)), 2)
                w, h = size * s * r.uniform(0.7, 1.4, 2)
                boxes.append([r.randint(0, 2), cx - w / 2, cy - h / 2,
                              cx + w / 2, cy + h / 2])
    rois = torch.tensor(boxes, dtype=torch.float32, device="cuda")
    valid = torch.from_numpy(r.uniform(size=len(boxes)) > 0.15).cuda()
    cot = torch.randn(len(boxes), 7, 7, C,
                      generator=torch.Generator().manual_seed(5)).cuda()
    _, got = _level_grads(fn, feats, dtype, rois, valid, 7, cot)
    _, ref = _level_grads(ref_fn, feats, dtype, rois, valid, 7, cot)
    _check_level_grads(got, ref, dtype)
    touched = _touched([f.shape for f in feats], rois, valid,
                       rule(rois[:, 1:5], STRIDES), 7)
    for g, m in zip(got, touched):
        assert not g[~m].any()
        assert bool(m.any())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused"])
def test_backward_writes_no_float32_pyramid(route):
    """bfloat16 training shapes: the backward returns bfloat16 level
    gradients, and allocates nothing beyond them (an earlier design zeroed a
    float32 copy of the pyramid, twice their size, and cast it)."""
    _need_cuda()
    fn, bwd, _, rule = _route(route)
    feats, rois, valid = _fixture(31, 256, n=512, S=1024)
    shapes = [tuple(f.shape) for f in feats]
    lvl = rule(rois[:, 1:5], STRIDES).to(torch.int32)
    cot = torch.randn(512, 7, 7, 256, generator=torch.Generator()
                      .manual_seed(6)).cuda().bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = bwd(cot, shapes, STRIDES, rois, lvl, valid)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    out_bytes = sum(g.numel() * g.element_size() for g in grads)
    assert all(g.dtype == torch.bfloat16 and g.shape == s
               for g, s in zip(grads, shapes))
    assert extra <= out_bytes + 2 ** 20, (extra, out_bytes)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["block", "fused", "strip"])
def test_kernel_levels_equal_the_torch_rule(route):
    """The level per RoI that the forward kernel computes equals the torch
    rule's on the card (block_levels, strip_levels, and map_roi_levels in
    the window-64 mode), on random RoIs and on the rules' edges."""
    _need_cuda()
    from bonai_tpu_torch.ops.roi_align_block import (BLOCK_RULE, STRIP_RULE,
                                                     WINDOW64_RULE,
                                                     launch_forward)
    _, _, _, rule = _route(route)
    feats, rois, valid = _fixture(41, 64, n=2000)
    rois = torch.cat([rois, torch.from_numpy(edge_rois()).cuda()])
    level_rule, window = {"block": (BLOCK_RULE, 32),
                          "fused": (STRIP_RULE, 40),
                          "strip": (WINDOW64_RULE, 64)}[route]
    _, lvl = launch_forward(feats, rois, None, (7, 7), STRIDES, 2,
                            level_rule, 56, window)
    torch.cuda.synchronize()
    want = rule(rois[:, 1:5], STRIDES)
    assert lvl.dtype == torch.int32
    assert torch.equal(lvl.long(), want), rois[lvl.long() != want]
    assert len(set(want.tolist())) == 4


@pytest.mark.cuda
def test_ddp_rehearsal_equals_the_mean_of_halves(tmp_path):
    """Two gloo ranks on one card (NCCL refuses two ranks on one device),
    each one step of the tiny 2x synthetic recipe in float32 on its image
    of a batch of two: both ranks' weights equal, within 1e-4 of each
    tensor's largest update, a one-process step whose gradient is the
    mean of the two half-batch gradients with the same draws; each rank
    launches B1 and B2 3 times."""
    _need_cuda()
    from bonai_tpu_torch.parallel.rehearsal import rehearse
    from torch_port_common import ddp_train_cfg, train_batch
    cfg = ddp_train_cfg()
    cfg.compute_dtype = "float32"
    cfg.model.roi_align_impl = "block"
    report = rehearse(cfg, train_batch(), str(tmp_path), timeout=300)
    assert report["worst"] <= 1e-4 and report["moved"] > 0
    for rank in report["ranks"]:
        assert rank["counts"]["roi_align_block"] == 3
        assert rank["counts"]["roi_align_block_backward"] == 3
