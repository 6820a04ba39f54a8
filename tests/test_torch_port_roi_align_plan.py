"""The RoI plan of bonai_tpu_torch's RoIAlign kernels, on the CPU.

``block_footprint`` is the plain version of the backward kernel's tile
test: the rectangle of level cells that an RoI's samples can touch.  It
must hold every corner of nonzero weight that ``corner_plan`` gives the
RoI, under the block and the strip level rule, for border RoIs, pushed
RoIs, RoIs wider than 28 cells at the coarsest level, tall RoIs that the
strip rule keeps fine, and invalid RoIs.  The wrappers on CPU tensors take
the plain versions, with and without ``roi_valid``, and agree with the JAX
functions.  float32; the gradients to 2e-4, as in
``test_torch_port_roi_align_strip.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonai_tpu.ops.pallas_roi_align_block import pallas_block_roi_align
from bonai_tpu.ops.pallas_roi_align_fused import pallas_multilevel_roi_align
from bonai_tpu_torch.ops import (block_levels, roi_align_block,
                                 roi_align_block_ref, roi_align_fused,
                                 strip_levels)
from bonai_tpu_torch.ops.roi_align import _level_samples, corner_plan
from bonai_tpu_torch.ops.roi_align_block import block_footprint

STRIDES = [4, 8, 16, 32]
RULES = {"block": block_levels, "strip": strip_levels}


def _rois(seed, H, W, n=60, B=2):
    """Random RoIs over an H x W image and the cases the kernels' tiles
    must handle: over the border, pushed coarser (wide, tall), wider than
    28 cells at the coarsest level, tall and narrow (the strip rule keeps
    it fine), smaller than a cell, and degenerate; one in five invalid."""
    r = np.random.RandomState(seed)
    xy = r.uniform(-40, max(H, W), (n, 2)) * [W / max(H, W), H / max(H, W)]
    wh = np.exp(r.uniform(0.5, 6.5, (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1)
    special = [[-30, -20, 60, 50], [W - 50, H - 40, W + 30, H + 25],
               [8, 40, 248, 100], [20, 4, 80, 250], [10, 20, W - 40, 230],
               [-30, 0, W + 60, H], [300, 4, 310, H - 6], [60, 60, 60.5, 61],
               [100, 100, 100, 100], [90, 120, 80, 110]]
    boxes = np.concatenate([boxes, special]).astype(np.float32)
    rois = np.concatenate([r.randint(0, B, (len(boxes), 1)), boxes], 1)
    valid = r.uniform(size=len(boxes)) > 0.2
    return (torch.from_numpy(rois.astype(np.float32)),
            torch.from_numpy(valid))


def _shapes(H, W, B=2, C=8):
    return [(B, H // s, W // s, C) for s in STRIDES]


@pytest.mark.parametrize("rule", ["block", "strip"])
@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("sr,H,W", [(1, 512, 512), (2, 512, 512),
                                    (3, 512, 512), (2, 256, 2048)])
def test_footprint_holds_every_corner(rule, out_size, sr, H, W):
    """Every corner of nonzero weight of every RoI, valid or not, lies in
    its footprint, which lies in its level."""
    rois, _ = _rois(sr + out_size + W, H, W)
    shapes = _shapes(H, W)
    lvl = RULES[rule](rois[:, 1:5], STRIDES)
    foot = block_footprint(shapes, rois, lvl, out_size, STRIDES, sr)
    corners, weights = corner_plan(shapes, rois, lvl, out_size, STRIDES, sr)
    base, Hl, Wl, _, _ = _level_samples(shapes, rois, lvl, out_size, STRIDES,
                                        sr, True)
    assert foot.shape == (len(rois), 4)
    assert bool((foot[:, 0] >= 0).all() and (foot[:, 1] < Hl).all())
    assert bool((foot[:, 2] >= 0).all() and (foot[:, 3] < Wl).all())
    assert bool((foot[:, 0] <= foot[:, 1]).all()
                and (foot[:, 2] <= foot[:, 3]).all())
    for idx, w in zip(corners, weights):
        cell = idx - base[:, None, None]
        y, x = cell // Wl[:, None, None], cell % Wl[:, None, None]
        inside = ((y >= foot[:, 0, None, None]) & (y <= foot[:, 1, None, None])
                  & (x >= foot[:, 2, None, None])
                  & (x <= foot[:, 3, None, None]))
        assert bool((inside | (w == 0)).all())
    if W > H:       # the wide pyramid reaches past 28 cells at level 3
        wide = (lvl == 3) & (foot[:, 3] - foot[:, 2] > 28)
        assert bool(wide.any())


@pytest.mark.parametrize("rule", ["block", "strip"])
def test_footprint_of_an_inner_roi_is_its_corners(rule):
    """For RoIs inside their level the footprint is the box of their
    corners of nonzero weight (one cell more at the high end where the
    last sample lies on a cell and its high corner weighs zero)."""
    r = np.random.RandomState(3)
    xy = r.uniform(40, 300, (40, 2))
    boxes = np.concatenate([xy, xy + r.uniform(4, 200, (40, 2))], 1)
    rois = torch.from_numpy(np.concatenate(
        [np.zeros((40, 1)), boxes], 1).astype(np.float32))
    shapes = _shapes(512, 512, B=1)
    lvl = RULES[rule](rois[:, 1:5], STRIDES)
    foot = block_footprint(shapes, rois, lvl, 7, STRIDES, 2)
    corners, weights = corner_plan(shapes, rois, lvl, 7, STRIDES, 2)
    base, _, Wl, _, _ = _level_samples(shapes, rois, lvl, 7, STRIDES, 2,
                                       True)
    for i in range(len(rois)):
        cells = torch.cat([c[i][w[i] != 0] for c, w in zip(corners, weights)])
        cells = cells - base[i]
        y, x = cells // Wl[i], cells % Wl[i]
        assert [int(foot[i, 0]), int(foot[i, 2])] == [int(y.min()),
                                                      int(x.min())]
        assert 0 <= int(foot[i, 1] - y.max()) <= 1
        assert 0 <= int(foot[i, 3] - x.max()) <= 1
    empty = block_footprint(shapes, rois[:0], lvl[:0], 7, STRIDES, 2)
    assert empty.shape == (0, 4)


def _pyramid(seed, C=8):
    r = np.random.RandomState(seed)
    return [r.randn(2, 256 // s, 256 // s, C).astype(np.float32)
            for s in STRIDES]


@pytest.mark.parametrize("route", ["block", "fused_rmw", "fused_scatter"])
def test_cpu_wrappers_without_roi_valid_match_jax(route):
    """``roi_valid=None`` (every row valid) on the CPU: the wrappers' plain
    versions and their gradients against the JAX functions (the block and
    the strip Pallas kernels in interpret mode; ``'scatter'`` is the JAX
    package's scatter backward)."""
    feats = _pyramid(7)
    rois, _ = _rois(11, 256, 256, n=12)
    rois = rois.numpy()
    cot = np.random.RandomState(8).randn(len(rois), 7, 7, 8).astype(
        np.float32)
    if route == "block":
        def jax_fn(fs):
            return pallas_block_roi_align(fs, jnp.asarray(rois), 7, STRIDES,
                                          sampling_ratio=2, interpret=True)

        def port_fn(levels):
            return roi_align_block(levels, torch.from_numpy(rois), 7,
                                   STRIDES, sampling_ratio=2)
    else:
        backward = route.split("_")[1]

        def jax_fn(fs):
            return pallas_multilevel_roi_align(
                fs, jnp.asarray(rois), 7, STRIDES, sampling_ratio=2,
                interpret=True, backward=backward)

        def port_fn(levels):
            return roi_align_fused(levels, torch.from_numpy(rois), 7,
                                   STRIDES, sampling_ratio=2,
                                   backward=backward)
    jfeats = [jnp.asarray(f) for f in feats]
    ref_out = np.asarray(jax_fn(jfeats))
    ref = jax.grad(lambda fs: jnp.sum(jax_fn(fs) * cot))(jfeats)
    levels = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = port_fn(levels)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-4,
                               atol=1e-4)
    for f, e, s in zip(levels, ref, STRIDES):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(e), rtol=2e-4,
                                   atol=2e-4, err_msg=f"stride {s}")
    if route == "block":
        assert torch.equal(out, roi_align_block_ref(
            levels, torch.from_numpy(rois), 7, STRIDES))
