"""The RoI plan of bonai_tpu_torch's RoIAlign kernels, on the CPU.

``block_footprint`` is the plain version of the backward kernel's tile
test: the rectangle of level cells that an RoI's samples can touch.  It
must hold every corner of nonzero weight that ``corner_plan`` gives the
RoI, under the block and the strip level rule, for border RoIs, pushed
RoIs, RoIs wider than 28 cells at the coarsest level, tall RoIs that the
strip rule keeps fine, and invalid RoIs.

``strip_bin_lists`` is the plain version of the forward kernel's per-bin
lists in its window-64 mode (``roi_align_strip`` on the card): pooled, they
give ``roi_align_strip_ref`` (float32, 1e-5); the window start from the
first and last x sample is the least ``x0`` of all samples; a list holds
at most ``2*sr`` cells, and every corner of nonzero weight of a bin is one
of its rows times one of its columns.  The kernel's gather rule in its
float32 operations equals ``map_roi_levels`` on the rule's edges.

The wrappers on CPU tensors take the plain versions, with and without
``roi_valid``, and agree with the JAX functions.  float32; the gradients
to 2e-4, as in ``test_torch_port_roi_align_strip.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonai_tpu.ops.pallas_roi_align import pallas_roi_align
from bonai_tpu.ops.pallas_roi_align_block import pallas_block_roi_align
from bonai_tpu.ops.pallas_roi_align_fused import pallas_multilevel_roi_align
from bonai_tpu_torch.ops import (block_levels, map_roi_levels,
                                 roi_align_block, roi_align_block_ref,
                                 roi_align_fused, roi_align_strip,
                                 roi_align_strip_ref, strip_levels)
from bonai_tpu_torch.ops.roi_align import (_level_samples, corner_plan,
                                           flatten_levels)
from bonai_tpu_torch.ops.roi_align_block import block_footprint
from bonai_tpu_torch.ops.roi_align_strip import (strip_bin_lists,
                                                 strip_corner_plan)
from torch_port_common import edge_rois

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


def _strip_rois(seed, H=512, W=512):
    """``_rois`` plus the window-64 rule's cases: wide, flat RoIs that the
    gather rule keeps at level 0 although they span more than 64 cells
    there (one across the whole image), and RoIs over the top, bottom,
    left and right borders."""
    rois, _ = _rois(seed, H, W)
    extra = np.array([[8, 40, 448, 45], [-30, 200, W + 20, 204],
                      [20, 60, 300, 63], [100, -20, 160, 30],
                      [200, H - 10, 260, H + 30], [-40, 300, 20, 360],
                      [W - 20, 100, W + 40, 160]], np.float32)
    extra = np.concatenate([np.ones((len(extra), 1), np.float32), extra], 1)
    return torch.cat([rois, torch.from_numpy(extra)])


def _levels(seed, H=512, W=512, C=8):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(2, H // s, W // s, C).astype(np.float32))
            for s in STRIDES]


SRS = [1, 2, 3, 5]


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("sr", SRS)
def test_strip_lists_pool_to_the_plain_version(sr, out_size):
    """Each bin pooled from its row and column lists (sum of Wy * Wx * v,
    times 1 / (sr*sr), as the kernel) equals roi_align_strip_ref."""
    levels = _levels(sr)
    rois = _strip_rois(sr + out_size)
    lists = strip_bin_lists([f.shape for f in levels], rois, out_size,
                            STRIDES, sr)
    base, _, Wl, _, _ = _level_samples([f.shape for f in levels], rois,
                                       lists["lvl"], out_size, STRIDES, sr,
                                       True)
    (yc, yw, _), (xc, xw, _) = lists["y"], lists["x"]
    idx = (base[:, None, None, None, None]
           + yc.clamp(min=0)[:, :, None, :, None]
           * Wl[:, None, None, None, None]
           + xc.clamp(min=0)[:, None, :, None, :])
    w = yw[:, :, None, :, None] * xw[:, None, :, None, :]
    got = (w[..., None] * flatten_levels(levels)[idx]).sum((3, 4)) * (
        1.0 / (sr * sr))
    ref = roi_align_strip_ref(levels, rois, out_size, STRIDES, sr)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("sr", SRS)
def test_strip_window_start_is_the_least_x0(sr, out_size):
    """The window start that the kernel takes from the first and the last
    x sample equals ``min(x0.amin(), max(Wl - 64, 0))`` over all samples,
    for RoIs flipped in x (x2 < x1) too; the fixture reaches the window cut
    and the ``Wl - 64`` cap."""
    shapes = [f.shape for f in _levels(0)]
    rois = _strip_rois(2 * sr + out_size)
    lists = strip_bin_lists(shapes, rois, out_size, STRIDES, sr)
    _, _, Wl, _, xs = _level_samples(shapes, rois, lists["lvl"], out_size,
                                     STRIDES, sr, True)
    Wf = Wl.float()[:, None]
    x0 = torch.minimum(torch.floor(torch.minimum(xs.clamp(min=0.0), Wf - 1.0)),
                       (Wf - 2.0).clamp(min=0.0)).long()
    least = x0.amin(1)
    assert torch.equal(lists["start"], torch.minimum(least, (Wl - 64).clamp(
        min=0)))
    assert bool(((lists["lvl"] == 0) & (x0[:, -1] - lists["start"] >= 64))
                .any())
    assert bool((lists["start"] < least).any())
    assert bool((rois[:, 3] < rois[:, 1]).any())
    assert set(lists["lvl"].tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("sr", SRS)
def test_strip_lists_hold_every_corner(sr, out_size):
    """No list holds more than ``2*sr`` cells, and the distinct corners of
    nonzero weight of each bin in ``strip_corner_plan`` are exactly its
    rows times its columns."""
    shapes = [f.shape for f in _levels(0)]
    rois = _strip_rois(3 * sr + out_size)
    lists = strip_bin_lists(shapes, rois, out_size, STRIDES, sr)
    ny, nx = lists["y"][2], lists["x"][2]
    assert lists["y"][0].shape[-1] == 2 * sr and int(ny.max()) <= 2 * sr
    assert int(nx.max()) <= 2 * sr and int(nx.max()) > sr
    corners, weights = strip_corner_plan(shapes, rois, out_size, STRIDES, sr)
    R = rois.shape[0]

    def per_bin(t):
        return torch.stack([c.reshape(R, out_size, sr, out_size, sr)
                            for c in t], -1).permute(0, 1, 3, 2, 4, 5).reshape(
                                R, out_size, out_size, -1)
    cells = torch.where(per_bin(weights) != 0, per_bin(corners), -1)
    cells = cells.sort(-1).values
    distinct = (cells[..., 0] >= 0).long() + (
        (cells[..., 1:] != cells[..., :-1]) & (cells[..., 1:] >= 0)).sum(-1)
    assert torch.equal(ny[:, :, None] * nx[:, None, :], distinct)


def test_kernel_gather_rule_equals_map_roi_levels():
    """The gather rule as the forward kernel computes it (``roi_level``
    without the push, csrc/roi_align_block_common.cuh): in float32, the
    square root of the clamped product times the reciprocal of
    finest_scale rounded to float32, plus 1e-6, log2, floor, clamped to the
    pyramid.  In numpy it equals ``map_roi_levels`` on the gather rule's
    edges (sqrt(wh) = 56 * 2^k and 56 * (2^k - 1e-6), one ulp below, at and
    above) and on random RoIs; a true division would not."""
    boxes = np.concatenate([edge_rois(), _strip_rois(4).numpy()])[:, 1:5]
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    scale = np.sqrt(np.maximum(w * h, np.float32(0)))
    inv = np.float32(1) / np.float32(56)

    def level(v):
        return np.clip(np.floor(np.log2(v + np.float32(1e-6))), 0, 3)
    want = level(scale * inv)
    np.testing.assert_array_equal(map_roi_levels(torch.from_numpy(boxes),
                                                 4).numpy(), want)
    assert set(want.tolist()) == {0, 1, 2, 3}
    assert (level(scale / np.float32(56)) != want).any()


def _pyramid(seed, C=8):
    r = np.random.RandomState(seed)
    return [r.randn(2, 256 // s, 256 // s, C).astype(np.float32)
            for s in STRIDES]


@pytest.mark.parametrize("route", ["block", "fused_rmw", "fused_scatter",
                                   "strip"])
def test_cpu_wrappers_without_roi_valid_match_jax(route):
    """``roi_valid=None`` (every row valid) on the CPU: the wrappers' plain
    versions and their gradients against the JAX functions (the block and
    the strip Pallas kernels in interpret mode; ``'scatter'`` is the JAX
    package's scatter backward; the window-64 kernel, forward only, to 1e-4
    relative and 1e-5 absolute as in ``test_torch_port_roi_align_strip``)."""
    feats = _pyramid(7)
    rois, _ = _rois(11, 256, 256, n=12)
    rois = rois.numpy()
    if route == "strip":
        ref = pallas_roi_align([jnp.asarray(f) for f in feats],
                               jnp.asarray(rois), 7, STRIDES,
                               sampling_ratio=2, interpret=True)
        got = roi_align_strip([torch.from_numpy(f) for f in feats],
                              torch.from_numpy(rois), 7, STRIDES,
                              sampling_ratio=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
        return
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
