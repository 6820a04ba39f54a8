"""bonai_tpu_torch RoIAlign against the JAX package.

The block-rule plain version (``roi_align_block_ref``, what the CUDA
kernel is held to on the card) against ``pallas_block_roi_align`` run in
interpret mode, the gather-rule ``multilevel_roi_align`` against the JAX
one, and the block level rule against ``_block_plan``.  float32,
tolerance 1e-4 (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread a process)

from bonai_tpu.ops.pallas_roi_align_block import (_block_plan,
                                                  pallas_block_roi_align,
                                                  prepare_block_levels)
from bonai_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel
from bonai_tpu_torch.ops import (block_levels, multilevel_roi_align,
                                 roi_align_block, roi_align_block_ref)
from bonai_tpu_torch.ops.roi_align_block import _check_inputs

STRIDES = [4, 8, 16, 32]


def _fixture(seed=0, B=2, S=256, C=32, n=24):
    """Random pyramid and RoIs: ordinary boxes, boxes the block rule pushes
    coarser (wide and flat), boxes over the image border, and invalid
    rows."""
    r = np.random.RandomState(seed)
    feats = [r.randn(B, S // s, S // s, C).astype(np.float32)
             for s in STRIDES]
    xy1 = r.uniform(0, S * 0.6, (n, 2))
    wh = r.uniform(16, S * 0.35, (n, 2))
    boxes = np.concatenate([xy1, np.minimum(xy1 + wh, S - 1)], 1)
    boxes[0] = [8, 40, 248, 100]          # w=240, h=60: pushed 1 -> 2
    boxes[1] = [20, 4, 80, 250]           # tall: pushed
    boxes[2] = [-12, -6, 60, 50]          # over the top-left border
    boxes[3] = [200, 210, 262, 259]       # over the bottom-right border
    b = r.randint(0, B, (n, 1))
    rois = np.concatenate([b, boxes], 1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[n // 2, n - 1]] = False
    return feats, rois, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("out_size", [7, 14])
def test_block_ref_matches_pallas_interpret(out_size):
    feats, rois, valid = _fixture()
    ref = pallas_block_roi_align([jnp.asarray(f) for f in feats],
                                 jnp.asarray(rois), out_size, STRIDES,
                                 sampling_ratio=2,
                                 roi_valid=jnp.asarray(valid),
                                 interpret=True)
    got = roi_align_block_ref([_t(f) for f in feats], _t(rois), out_size,
                              STRIDES, sampling_ratio=2,
                              roi_valid=_t(valid))
    assert got.shape == (len(rois), out_size, out_size, feats[0].shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert not got[~_t(valid)].any()


@pytest.mark.parametrize("out_size", [7, 14])
def test_plain_matches_jax_gather(out_size):
    feats, rois, valid = _fixture(seed=1)
    ref = jax_multilevel([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                         out_size, STRIDES, sampling_ratio=2,
                         roi_valid=jnp.asarray(valid))
    got = multilevel_roi_align([_t(f) for f in feats], _t(rois), out_size,
                               STRIDES, sampling_ratio=2,
                               roi_valid=_t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_block_levels_match_block_plan():
    feats, rois, valid = _fixture(seed=2, n=64)
    views, consts = prepare_block_levels([jnp.asarray(f) for f in feats],
                                         32)
    consts["true_heights"] = np.asarray([f.shape[1] for f in feats])
    consts["true_widths"] = np.asarray([f.shape[2] for f in feats])
    plan = _block_plan(jnp.asarray(rois), consts, STRIDES, (7, 7), 2, True,
                       56, 40, jnp.asarray(valid))
    lvl = block_levels(_t(rois[:, 1:5]), STRIDES)
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(plan["lvl"]))
    assert lvl[0] == 2 and lvl[1] > 0     # the push cases were pushed


def test_block_wrapper_takes_plain_version_on_cpu():
    feats, rois, valid = _fixture(seed=3, n=8)
    before = roi_align_block.launches
    args = ([_t(f) for f in feats], _t(rois), 7, STRIDES)
    got = roi_align_block(*args, roi_valid=_t(valid))
    ref = roi_align_block_ref(*args, roi_valid=_t(valid))
    assert torch.equal(got, ref)
    assert roi_align_block.launches == before


@pytest.mark.parametrize("case", ["odd_channels", "dtype", "layout",
                                  "rois_dtype", "valid_dtype", "levels"])
def test_block_wrapper_rejects_what_the_kernel_does_not_take(case):
    feats, rois, valid = _fixture(seed=4, n=4, C=8)
    feats = [_t(f) for f in feats]
    rois, valid = _t(rois), _t(valid)
    if case == "odd_channels":
        feats = [f[..., :7].contiguous() for f in feats]
    elif case == "dtype":
        feats = [f.half() for f in feats]
    elif case == "layout":
        feats = [f.permute(0, 2, 1, 3) for f in feats]
    elif case == "rois_dtype":
        rois = rois.double()
    elif case == "valid_dtype":
        valid = valid.int()
    else:
        feats = feats[:2]
    with pytest.raises((TypeError, ValueError)):
        _check_inputs(feats, rois, valid, len(STRIDES), True, 2)
