"""bonai_tpu_torch's strip RoIAlign routes against the JAX package.

- ``roi_align_fused`` (``roi_align_impl='pallas'``; its plain version on
  the CPU) against ``pallas_multilevel_roi_align`` run in interpret mode,
  its level rule against the JAX push, and its gradient (``'rmw'`` through
  the plain version, ``'scatter'``) against ``jax.grad`` through the JAX
  backwards;
- ``roi_align_strip`` against ``pallas_roi_align`` in interpret mode, with
  that kernel's window cut and y rule;
- ``roi_align_blocked`` against ``multilevel_roi_align_blocked``;
- the wrappers on the CPU, and the tiny detector with ``'blocked'`` and
  ``'pallas'`` against the JAX detector built the same way.

float32.  Tolerances: forwards 1e-4 (``roi_align_strip``: 1e-4 relative,
1e-5 absolute), gradients 2e-4, as the JAX package's own tests of these
kernels hold them to the gather RoIAlign (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonai_tpu.ops.pallas_roi_align import pallas_roi_align
from bonai_tpu.ops.pallas_roi_align_fused import (_plan,
                                                  pallas_multilevel_roi_align)
from bonai_tpu.ops.roi_align import multilevel_roi_align as jax_gather
from bonai_tpu.ops.roi_align import prepare_flat_levels
from bonai_tpu.ops.roi_align_blocked import multilevel_roi_align_blocked
from bonai_tpu_torch.ops import (map_roi_levels, roi_align_blocked,
                                 roi_align_fused, roi_align_fused_backward,
                                 roi_align_fused_ref, roi_align_strip,
                                 roi_align_strip_ref, strip_levels)
from bonai_tpu_torch.ops.roi_align_block import _check_inputs
import torch_port_common as tpc
from torch_port_common import (jax_forward_train_draws, jax_model,
                               port_model, t, tiny_train_cfg, train_batch)

STRIDES = [4, 8, 16, 32]


def _pyramid(r, B, H, W, C):
    return [r.randn(B, H // s, W // s, C).astype(np.float32)
            for s in STRIDES]


def _fixture(seed=0, B=2, S=256, C=16, n=16):
    """Random pyramid and RoIs: ordinary boxes, wide flat boxes that the
    strip rule pushes coarser, a tall box it keeps, boxes over the image
    border, and invalid rows."""
    r = np.random.RandomState(seed)
    feats = _pyramid(r, B, S, S, C)
    xy1 = r.uniform(0, S * 0.6, (n, 2))
    wh = r.uniform(16, S * 0.35, (n, 2))
    boxes = np.concatenate([xy1, np.minimum(xy1 + wh, S - 1)], 1)
    boxes[0] = [8, 40, 248, 60]           # 60 cells wide at level 0: -> 1
    boxes[1] = [0, 100, 250, 110]         # 62 cells at level 0: -> 1
    boxes[2] = [20, 4, 60, 250]           # tall: the x rule keeps it
    boxes[3] = [-12, -6, 60, 50]          # over the top-left border
    boxes[4] = [200, 210, 262, 259]       # over the bottom-right border
    b = r.randint(0, B, (n, 1))
    rois = np.concatenate([b, boxes], 1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[n // 2, n - 1]] = False
    return feats, rois, valid


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("out_size", [7, 14])
def test_fused_matches_pallas_interpret(out_size):
    feats, rois, valid = _fixture()
    ref = pallas_multilevel_roi_align(_j(feats), jnp.asarray(rois), out_size,
                                      STRIDES, sampling_ratio=2,
                                      roi_valid=jnp.asarray(valid),
                                      interpret=True)
    got = roi_align_fused(_t(feats), t(rois), out_size, STRIDES,
                          sampling_ratio=2, roi_valid=t(valid))
    assert got.shape == (len(rois), out_size, out_size, feats[0].shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert not got[~t(valid)].any()
    lvl = strip_levels(t(rois[:, 1:5]), STRIDES)
    gather_lvl = map_roi_levels(t(rois[:, 1:5]), 4)
    assert lvl[0] == lvl[1] == 1 and gather_lvl[0] == gather_lvl[1] == 0
    assert lvl[2] == gather_lvl[2]


def test_strip_levels_match_jax_push():
    """Boxes around the push's thresholds (x-extents of 144, 288 and 576
    px, one cell more and less), degenerate ones, and random ones."""
    r = np.random.RandomState(5)
    feats = _pyramid(r, 1, 256, 256, 2)
    widths = np.array([144, 144.5, 143.5, 288, 288.25, 576, 577, 0, 3,
                       1000, 40, 2000], np.float32)
    heights = np.array([10, 4, 200, 30, 2, 5, 300, 50, 0, 20, 40, 60],
                       np.float32)
    x1 = r.uniform(0, 100, len(widths)).astype(np.float32)
    y1 = r.uniform(0, 100, len(widths)).astype(np.float32)
    edge = np.stack([np.zeros_like(x1), x1, y1, x1 + widths, y1 + heights], 1)
    xy = r.uniform(0, 200, (40, 2))
    wh = np.exp(r.uniform(0, 6.5, (40, 2)))
    rand = np.concatenate([np.zeros((40, 1)), xy, xy + wh], 1)
    rois = np.concatenate([edge, rand]).astype(np.float32)
    _, consts = prepare_flat_levels(_j(feats))
    plan = _plan(jnp.asarray(rois), consts, STRIDES, (7, 7), 2, True, 56, 40,
                 None)
    ref = np.searchsorted(-consts["widths"][:4], -np.asarray(plan["wl"]))
    got = strip_levels(t(rois[:, 1:5]), STRIDES)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(set(ref.tolist())) == 4


def _overlap_fixture():
    """``test_fused_overlapping_rois_backward`` of the JAX package:
    identical and nearly identical RoIs (rows repeated across RoIs)."""
    r = np.random.RandomState(4)
    feats = _pyramid(r, 1, 256, 256, 16)
    box = np.array([0.0, 40.0, 40.0, 140.0, 140.0], np.float32)
    rois = np.stack([box, box, box + [0, 1, 1, 1, 1], box,
                     box + [0, 2, 0, 2, 0]])
    return feats, rois, r.randn(5, 7, 7, 16).astype(np.float32)


def _narrow_fixture():
    """``test_rmw_backward_narrow_level_partial_overlap``: huge RoIs on an
    8-cell-wide coarsest level, narrower than the strip window."""
    r = np.random.RandomState(7)
    feats = _pyramid(r, 1, 256, 256, 16)
    rois = np.array([[0, 8, 8, 240, 240], [0, 16, 4, 250, 200],
                     [0, 4, 30, 200, 251]], np.float32)
    return feats, rois, r.randn(3, 7, 7, 16).astype(np.float32)


def _grads(feats, rois, cot, backward, valid=None):
    """The levels' gradients of ``sum(out * cot)`` in JAX (interpret
    mode) and in the port, with one ``backward``."""
    jv = None if valid is None else jnp.asarray(valid)

    def loss(fs):
        out = pallas_multilevel_roi_align(fs, jnp.asarray(rois), 7, STRIDES,
                                          sampling_ratio=2, roi_valid=jv,
                                          interpret=True, backward=backward)
        return jnp.sum(out * cot)
    ref = jax.grad(loss)(_j(feats))
    levels = [f.requires_grad_() for f in _t(feats)]
    out = roi_align_fused(levels, t(rois), 7, STRIDES, sampling_ratio=2,
                          roi_valid=None if valid is None else t(valid),
                          backward=backward)
    (out * t(cot)).sum().backward()
    return [f.grad.numpy() for f in levels], [np.asarray(g) for g in ref]


@pytest.mark.parametrize("fixture", [_overlap_fixture, _narrow_fixture],
                         ids=["overlap", "narrow_level"])
def test_fused_rmw_gradient_matches_jax(fixture):
    """The gradient of the plain version (what the backward kernel is held
    to on the card) against the JAX read-modify-write kernel."""
    got, ref = _grads(*fixture(), "rmw")
    for g, e, s in zip(got, ref, STRIDES):
        np.testing.assert_allclose(g, e, rtol=2e-4, atol=2e-4,
                                   err_msg=f"stride {s}")
    assert max(np.abs(g).max() for g in got) > 0


def test_fused_scatter_gradient_matches_jax():
    feats, rois, valid = _fixture(seed=1, n=12)
    cot = np.random.RandomState(2).randn(12, 7, 7, 16).astype(np.float32)
    before = roi_align_fused_backward.launches
    got, ref = _grads(feats, rois, cot, "scatter", valid)
    assert roi_align_fused_backward.launches == before
    for g, e, s in zip(got, ref, STRIDES):
        np.testing.assert_allclose(g, e, rtol=2e-4, atol=2e-4,
                                   err_msg=f"stride {s}")


def test_fused_past_the_coarsest_level():
    """Reference quirk: an RoI still wider than 36 cells at the coarsest
    level has its corners past the JAX kernel's 48-cell strip zeroed; the
    port reads them (the RoIAlign the rule means).  Needs a level 3 wider
    than 48 cells, i.e. an image over 1536 px wide."""
    r = np.random.RandomState(8)
    feats = _pyramid(r, 1, 64, 2048, 4)
    rois = np.array([[0, 50, 10, 1990, 60],      # 60 cells at level 3
                     [0, 100, 8, 400, 40],       # pushed to 2, fits
                     [0, 900, 20, 960, 60]], np.float32)
    ref = np.asarray(pallas_multilevel_roi_align(
        _j(feats), jnp.asarray(rois), 7, STRIDES, sampling_ratio=2,
        interpret=True))
    got = roi_align_fused_ref(_t(feats), t(rois), 7, STRIDES).numpy()
    assert strip_levels(t(rois[:, 1:5]), STRIDES)[0] == 3
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4, atol=1e-4)
    # the left five output columns read cells 0..46, inside the strip
    np.testing.assert_allclose(got[0, :, :5], ref[0, :, :5], rtol=1e-4,
                               atol=1e-4)
    assert np.abs(ref[0, :, 6]).max() < 1e-6 < np.abs(got[0, :, 6]).max()


def _strip_fixture(seed=9):
    """A 128 x 512 px pyramid (level 0 is 128 cells wide), a wide flat RoI
    that the gather rule keeps at level 0 (400 x 5 px: 100 cells, past
    the 64-cell window), RoIs over the border in y, random ones inside
    the image, and an invalid row."""
    r = np.random.RandomState(seed)
    feats = _pyramid(r, 2, 128, 512, 8)
    xy = r.uniform(0, 1, (8, 2)) * [300, 60]
    wh = r.uniform(20, 60, (8, 2)) * [2, 1]     # inside the image
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[0] = [40, 50, 440, 55]          # wide and flat: window cut
    boxes[1] = [-10, -30, 60, 40]         # over the top border
    boxes[2] = [400, 100, 470, 150]       # over the bottom border
    rois = np.concatenate([r.randint(0, 2, (8, 1)), boxes], 1)
    valid = np.ones(8, bool)
    valid[5] = False
    return feats, rois.astype(np.float32), valid


@pytest.mark.parametrize("out_size", [7, 14])
def test_strip_matches_pallas_interpret(out_size):
    feats, rois, valid = _strip_fixture()
    ref = np.asarray(pallas_roi_align(_j(feats), jnp.asarray(rois), out_size,
                                      STRIDES, sampling_ratio=2,
                                      roi_valid=jnp.asarray(valid),
                                      interpret=True))
    before = roi_align_strip.launches
    got = roi_align_strip(_t(feats), t(rois), out_size, STRIDES,
                          sampling_ratio=2, roi_valid=t(valid))
    assert roi_align_strip.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert not got[5].any()
    # the two quirks are real: the wide RoI (window cut) and the border
    # RoIs (y rule) differ from the RoIAlign of the gather route
    gather = np.asarray(jax_gather(_j(feats), jnp.asarray(rois), out_size,
                                   STRIDES, sampling_ratio=2))
    for i in (0, 1, 2):
        assert np.abs(ref[i] - gather[i]).max() > 1e-2, i
    np.testing.assert_allclose(ref[[3, 4, 6, 7]], gather[[3, 4, 6, 7]],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["square", "square_bf16", "gcd_fallback"])
def test_blocked_matches_jax(case):
    if case == "gcd_fallback":          # level widths 50, 25, 12, 6
        feats, rois, valid = _fixture(seed=10, S=200)
    else:
        feats, rois, valid = _fixture(seed=11)
    dtype = jnp.bfloat16 if case == "square_bf16" else jnp.float32
    jf = [jnp.asarray(f, dtype) for f in feats]
    ref = np.asarray(multilevel_roi_align_blocked(
        jf, jnp.asarray(rois), 7, STRIDES, sampling_ratio=2,
        roi_valid=jnp.asarray(valid)).astype(jnp.float32))
    levels = [torch.from_numpy(np.asarray(f.astype(jnp.float32))).to(
        torch.bfloat16 if case == "square_bf16" else torch.float32)
        for f in jf]
    got = roi_align_blocked(levels, t(rois), 7, STRIDES, sampling_ratio=2,
                            roi_valid=t(valid))
    assert got.dtype == levels[0].dtype
    got = got.float().numpy()
    if case == "square_bf16":           # one bf16 ulp
        assert np.all(np.abs(got - ref) <= np.abs(ref) * 2 ** -7 + 1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    gather = np.asarray(jax_gather(_j(feats), jnp.asarray(rois), 7, STRIDES,
                                   sampling_ratio=2,
                                   roi_valid=jnp.asarray(valid)))
    if case == "square":    # ly = 0: the RoIs over the border differ
        assert np.abs(got[3] - gather[3]).max() > 1e-2
    elif case == "gcd_fallback":
        np.testing.assert_allclose(got, gather, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    "fused_takes_plain_version", "strip_takes_plain_version",
    "unknown_backward", "strip_has_no_gradient", "sampling_ratio_over_4",
    "odd_channels", "half_levels"])
def test_wrappers_on_the_cpu(case):
    """On CPU tensors the wrappers run their plain versions (no launch);
    they reject what the kernels do not take, and take any sampling ratio
    from 1 up (the JAX functions do; the cap of 4 went with the strip
    kernel that staged 2*sr rows)."""
    feats, rois, valid = _fixture(seed=3, n=8, C=8)
    levels, rois, valid = _t(feats), t(rois), t(valid)
    args = (levels, rois, 7, STRIDES)
    counts = (roi_align_fused.launches, roi_align_fused_backward.launches,
              roi_align_strip.launches)
    if case == "fused_takes_plain_version":
        assert torch.equal(roi_align_fused(*args, roi_valid=valid),
                           roi_align_fused_ref(*args, roi_valid=valid))
    elif case == "strip_takes_plain_version":
        assert torch.equal(roi_align_strip(*args, roi_valid=valid),
                           roi_align_strip_ref(*args, roi_valid=valid))
    elif case == "unknown_backward":
        with pytest.raises(ValueError, match="backward"):
            roi_align_fused(*args, backward="chains")
    elif case == "strip_has_no_gradient":
        levels[0].requires_grad_()
        with pytest.raises(RuntimeError, match="not differentiable"):
            roi_align_strip(*args)
        with torch.no_grad():
            roi_align_strip(*args)
    elif case == "sampling_ratio_over_4":
        for name in ("roi_align_fused", "roi_align_strip"):
            _check_inputs(levels, rois, valid, 4, True, 5, name)
            with pytest.raises(ValueError, match="sampling_ratio"):
                _check_inputs(levels, rois, valid, 4, True, 0, name)
        assert torch.equal(
            roi_align_strip(*args, sampling_ratio=5, roi_valid=valid),
            roi_align_strip_ref(*args, sampling_ratio=5, roi_valid=valid))
    else:
        if case == "odd_channels":
            levels = [f[..., :7].contiguous() for f in levels]
        elif case == "half_levels":
            levels = [f.half() for f in levels]
        for name in ("roi_align_fused", "roi_align_strip"):
            with pytest.raises((TypeError, ValueError), match=name):
                _check_inputs(levels, rois, valid, 4, True, 2, name)
    assert (roi_align_fused.launches, roi_align_fused_backward.launches,
            roi_align_strip.launches) == counts


IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
          "loss_mask", "loss_offset")


@pytest.mark.parametrize("impl,how", [("blocked", "argument"),
                                      ("pallas", "argument"),
                                      ("pallas", "environment")])
def test_tiny_detector_route_matches_jax(impl, how, monkeypatch):
    """``simple_test`` and the ``forward_train`` losses of the tiny
    LOFT-FOA with the route chosen through ``build_detector`` or through
    ``BONAI_ROI_IMPL``, against the JAX detector built the same way (on
    the CPU ``'pallas'`` takes the gather rule in both; ``'blocked'`` is
    the blocked formulation in both).  Detections, scores and masks as in
    ``test_torch_port_detector.py``; losses to 1e-4 relative."""
    kw = {"roi_align_impl": impl}
    if how == "environment":
        monkeypatch.setenv("BONAI_ROI_IMPL", impl)
        kw = {}
    cfg = tiny_train_cfg()
    jm, variables = jax_model(cfg, **kw)
    pm = port_model(cfg, variables, **kw)
    assert jm.roi_align_impl == pm.roi_align_impl == impl
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    for key, tol in (("det_bboxes", 1e-3), ("det_scores", 1e-4),
                     ("mask_probs", 1e-4), ("offsets", 1e-3)):
        np.testing.assert_allclose(got[key].numpy()[valid],
                                   np.asarray(ref[key])[valid], rtol=1e-4,
                                   atol=tol, err_msg=key)

    batch = train_batch()
    key = jax.random.PRNGKey(3)
    ref = jax.device_get(jax.jit(lambda v, b: jm.apply(
        v, b, method="forward_train", rngs={"sampling": key}))(variables,
                                                               batch))
    with torch.no_grad():
        got = pm.forward_train({k: t(v) for k, v in batch.items()},
                               jax_forward_train_draws(jm, variables, key, 2))
    assert set(got) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
