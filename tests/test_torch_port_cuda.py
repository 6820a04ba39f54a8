"""bonai_tpu_torch CUDA kernels on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no
CPU mode) and skip without one.  They import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The block RoIAlign kernel is held to its plain version: float32 to 1e-4,
bfloat16 to one bf16 ulp (2**-7 relative).
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
