"""bonai_tpu_torch CUDA kernels on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no
CPU mode) and skip without one.  They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The RoIAlign forward kernels (block, fused strip, window-64 strip) are
held to their plain versions: float32 to 1e-4, bfloat16 to one bf16 ulp
(2**-7 relative).  The backward kernels (block, fused strip) are held to
autograd through the plain version: float32 to 1e-4 of each level's
largest gradient (float32 atomics sum in a varying order), bfloat16 to one
bf16 ulp plus 1e-5 of the level's largest gradient (both round once from
float32 sums taken in different orders).
"""

import numpy as np
import pytest
import torch

from torch_port_common import tiny_cfg

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
                                 str(tmp_path), max_steps=1, log_interval=1)
    assert roi_align_block.launches - fwd == 3
    assert roi_align_block_backward.launches - bwd == 3
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


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
                                 max_steps=1, log_interval=1)
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
