"""``forward_dummy``, ``tools/get_flops.py``, the custom ops and
``tools/export_model.py`` of bonai_tpu_torch against the JAX package on the
CPU, at the tiny widths of ``torch_port_common``.

- ``forward_dummy`` of LOFT-FOA, Mask R-CNN, Cascade, HTC and one dense
  detector of every ``single_stage.py`` class against the JAX detector's
  ``__call__`` on the same weights and image: every output within 1e-5 of
  its largest value (NAS-FCOS's and CornerNet's 1e-4: their per-channel
  GroupNorms magnify float noise, as in ``test_torch_port_nas_ssd.py`` and
  ``test_torch_port_cornernet.py``).
- The parameter count equals JAX's count of ``variables['params']``
  exactly, on those models and on the full-width LOFT-FOA.
- The FLOP count of ``FlopCounterMode`` equals a count from forward hooks
  on every convolution and linear layer.
- The tiny LOFT-FOA exported on the CPU, saved and loaded in another
  process gives eager ``simple_test``'s outputs to the bit, and the JAX
  ``simple_test``'s at the serving tolerances of
  ``test_torch_port_detector.py`` (boxes and offsets 1e-3 px, scores and
  mask probabilities 1e-4); the new ops' fake implementations pass
  ``torch.library.opcheck``.
"""

import copy
import importlib
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common as tpc
from torch_port_common import (CASCADE_CONFIG, CONFIG, MASK_RCNN_CONFIG,
                               ROOT, dense_cfg, htc_cfg, jax_model,
                               nas_ssd_cfg, port_model, t, tiny_cfg)

# family: (tiny config, image size, tolerance)
FAMILIES = {
    "loft_foa": (lambda: tiny_cfg(), 128, 1e-5),
    "mask_rcnn": (lambda: tiny_cfg(config=MASK_RCNN_CONFIG), 128, 1e-5),
    "cascade": (lambda: tiny_cfg(config=CASCADE_CONFIG), 128, 1e-5),
    "htc": (lambda: htc_cfg(), 128, 1e-5),
    "retinanet": (lambda: dense_cfg("retinanet"), 160, 1e-5),
    "fcos": (lambda: dense_cfg("fcos"), 160, 1e-5),
    "atss": (lambda: dense_cfg("atss"), 160, 1e-5),
    "fsaf": (lambda: dense_cfg("fsaf"), 160, 1e-5),
    "gfl": (lambda: dense_cfg("gfl"), 160, 1e-5),
    "fovea": (lambda: dense_cfg("fovea"), 160, 1e-5),
    "free_anchor": (lambda: dense_cfg("free_anchor"), 160, 1e-5),
    "ssd": (lambda: nas_ssd_cfg("ssd"), 300, 1e-5),
    "reppoints": (lambda: dense_cfg("reppoints"), 160, 1e-5),
    "cornernet": (lambda: nas_ssd_cfg("cornernet"), 128, 1e-4),
    "nasfcos": (lambda: nas_ssd_cfg("nasfcos"), 160, 1e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _tiny_vgg():
    with tpc.tiny_vgg():
        yield


_MODELS = {}


def models(family):
    """``(cfg, JAX model, variables, port model)``, built once."""
    if family not in _MODELS:
        make, size, _ = FAMILIES[family]
        cfg = make()
        jm, variables = jax_model(cfg, seed=1, init_size=size)
        _MODELS[family] = (cfg, jm, variables, port_model(cfg, variables))
    return _MODELS[family]


def _leaves(x):
    """Tensors of a nested output, dicts in key order (as ``jax.tree``)."""
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [] if x is None else [x]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_dummy_matches_jax_call(family):
    """Every output of ``forward_dummy`` against the JAX ``__call__`` (the
    port's NCHW maps in the JAX package's NHWC), and the parameter count."""
    _, size, tol = FAMILIES[family]
    cfg, jm, variables, pm = models(family)
    img = np.random.RandomState(0).randn(1, size, size, 3).astype(np.float32)
    want = jax.tree_util.tree_leaves(tpc.jax_call(
        lambda v, x: jm.apply(v, x), variables, img))
    with torch.no_grad():
        got = _leaves(pm.forward_dummy(t(img)))
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        g = g.detach().float()
        if tuple(g.shape) != w.shape and g.dim() == 4:
            g = g.permute(0, 2, 3, 1)
        assert tuple(g.shape) == w.shape, (i, tuple(g.shape), w.shape)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-12),
            err_msg=f"output {i}")
    n_jax = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(variables["params"]))
    from bonai_tpu_torch.tools.get_flops import count_params
    assert count_params(pm) == n_jax


def test_full_width_params_equal_jax():
    """LOFT-FOA R50-FPN at its published widths, built on the CPU."""
    from bonai_tpu.models import build_detector as jax_build
    from bonai_tpu_torch import Config
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.tools.get_flops import count_params
    cfg = Config.fromfile(CONFIG)
    jm = jax_build(cfg.model, cfg.train_cfg, cfg.test_cfg,
                   compute_dtype="float32")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    n_jax = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(shapes["params"]))
    pm = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    assert count_params(pm) == n_jax > 40e6


def test_flops_equal_a_hook_count(tmp_path, capsys):
    """``FlopCounterMode`` over ``forward_dummy`` against forward hooks on
    every ``Conv2d``, ``ConvTranspose2d`` and ``Linear``: two FLOPs a
    multiply-add; and the CLI's three lines."""
    from bonai_tpu_torch.tools import get_flops
    _, _, _, pm = models("loft_foa")
    total = [0]

    def hook(m, inputs, out):
        x = inputs[0]
        if isinstance(m, torch.nn.Linear):
            total[0] += 2 * x.numel() // x.shape[-1] * m.in_features \
                * m.out_features
        elif isinstance(m, torch.nn.ConvTranspose2d):
            total[0] += 2 * x.numel() * m.out_channels // m.groups \
                * int(np.prod(m.kernel_size))
        else:
            total[0] += 2 * out.numel() * m.in_channels // m.groups \
                * int(np.prod(m.kernel_size))
    handles = [m.register_forward_hook(hook) for m in pm.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                 torch.nn.Linear))]
    try:
        flops = get_flops.count_flops(pm, (128, 96))
    finally:
        for h in handles:
            h.remove()
    assert flops == total[0] > 1e7
    # a bfloat16 model (as on the card) counts the same, its RoIs float32
    assert get_flops.count_flops(copy.deepcopy(pm).to(torch.bfloat16),
                                 (64, 64)) == get_flops.count_flops(pm,
                                                                    (64, 64))
    cfg = tiny_cfg()
    cfg.dump(str(tmp_path / "tiny.py"))
    get_flops.main([str(tmp_path / "tiny.py"), "--shape", "128", "96",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Input shape: (1, 128, 96, 3)"
    assert lines[1].startswith("Params: ") and lines[1].endswith(" M")
    assert lines[2].startswith(get_flops.LABEL + ": ")


def test_custom_ops_pass_opcheck():
    """The RoIAlign forward (each level rule) and backward ops and the NMS
    ops on CPU tensors (whose bodies are the plain versions): schema, fake
    implementation, autograd registration, traced dispatch."""
    rb = importlib.import_module("bonai_tpu_torch.ops.roi_align_block")
    from bonai_tpu_torch.core import nms
    g = torch.Generator().manual_seed(0)
    levels = [torch.randn(2, s, s, 8, generator=g, requires_grad=True)
              for s in (32, 16, 8, 4)]
    xy = torch.rand(20, 2, generator=g) * 90
    rois = torch.cat([torch.randint(0, 2, (20, 1), generator=g).float(), xy,
                      xy + torch.rand(20, 2, generator=g) * 60 + 2], 1)
    valid = torch.rand(20, generator=g) > 0.2
    strides = [4.0, 8.0, 16.0, 32.0]
    for rule, window in ((rb.BLOCK_RULE, 32), (rb.STRIP_RULE, 40),
                         (rb.WINDOW64_RULE, 64)):
        lv = levels if rule != rb.WINDOW64_RULE else [
            f.detach() for f in levels]     # no gradient in that mode
        torch.library.opcheck(rb.roi_align_levels_op, (
            lv, rois, valid, [7, 7], strides, 2, rule, 56, window,
            rule != rb.WINDOW64_RULE))
    out, lvl = rb.roi_align_levels_op([f.detach() for f in levels], rois,
                                      valid, [7, 7], strides, 2,
                                      rb.BLOCK_RULE, 56, 32, True)
    torch.library.opcheck(rb.roi_align_levels_backward_op, (
        torch.randn_like(out), [d for f in levels for d in f.shape], strides,
        rois, lvl, valid, 2, rb.BLOCK_RULE))
    assert torch.equal(out, rb.roi_align_block_ref(
        [f.detach() for f in levels], rois, 7, strides, roi_valid=valid))
    boxes = torch.rand(2, 50, 2, generator=g) * 50
    boxes = torch.cat([boxes, boxes + torch.rand(2, 50, 2, generator=g) * 30
                       + 1], -1)
    scores = torch.rand(2, 50, generator=g)
    torch.library.opcheck(nms._nms_op, (boxes, scores, 0.5, scores > 0.1,
                                        16))
    torch.library.opcheck(nms._soft_nms_op, (boxes, scores, 0.5, 0.5, 1e-3,
                                             "linear", 20, scores > 0.1))


def _compare_serving(got, ref):
    """``test_torch_port_detector.py``'s slot-by-slot comparison."""
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got["det_labels"].numpy()[valid],
                                  np.asarray(ref["det_labels"])[valid])
    for key, tol in (("det_bboxes", 1e-3), ("det_scores", 1e-4),
                     ("mask_probs", 1e-4), ("offsets", 1e-3)):
        np.testing.assert_allclose(got[key].numpy()[valid],
                                   np.asarray(ref[key])[valid], rtol=1e-4,
                                   atol=tol, err_msg=key)


_RELOAD = """
import sys
import torch
from bonai_tpu_torch.tools.export_model import load_exported
run = load_exported(sys.argv[1])
with torch.no_grad():
    out = run(torch.load(sys.argv[2]))
torch.save(out, sys.argv[3])
"""


def test_exported_simple_test_reloads_in_another_process(tmp_path):
    """The tiny LOFT-FOA exported by ``export_detector``, saved with
    ``torch.export.save`` and run from the file in a fresh process: eager
    ``simple_test`` to the bit, and JAX's within the serving tolerances;
    the graph holds the NMS ops (on the CPU the RoIAlign is the plain
    one)."""
    from bonai_tpu_torch.tools.export_model import export_detector
    cfg, jm, variables, pm = models("loft_foa")
    program = export_detector(pm, size=96, batch=2)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert {"bonai_tpu_torch.nms.default",
            "bonai_tpu_torch.soft_nms.default"} <= targets
    path = str(tmp_path / "loft.pt2")
    torch.export.save(program, path)
    img = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    torch.save(t(img), tmp_path / "img.pt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", _RELOAD, path,
                    str(tmp_path / "img.pt"), str(tmp_path / "out.pt")],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    got = torch.load(tmp_path / "out.pt")
    shp = np.full((2, 2), 96.0, np.float32)
    sf = np.ones(2, np.float32)
    eager = pm.simple_test(t(img), t(shp), t(sf))
    assert set(got) == set(eager)
    for k in eager:
        assert torch.equal(got[k], eager[k]), k
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, img, shp, sf)
    _compare_serving(got, ref)


def test_export_cli_writes_the_program(tmp_path, capsys):
    """``python -m bonai_tpu_torch.tools.export_model CONFIG none OUT
    --device cpu``: the ``.pt2`` of the config's detector in its
    ``compute_dtype``, which ``load_exported`` runs."""
    from bonai_tpu_torch.tools import export_model
    cfg = tiny_cfg()
    cfg.compute_dtype = "float32"
    cfg.dump(str(tmp_path / "tiny.py"))
    export_model.main([str(tmp_path / "tiny.py"), "none",
                       str(tmp_path / "m"), "--size", "64", "--device",
                       "cpu"])
    assert capsys.readouterr().out.startswith(f"wrote {tmp_path / 'm'}.pt2")
    out = export_model.load_exported(str(tmp_path / "m.pt2"))(
        torch.zeros(1, 64, 64, 3))
    assert out["det_bboxes"].shape == (1, 32, 4)
    assert out["mask_probs"].dtype == torch.float32
    assert osp.getsize(tmp_path / "m.pt2") > 1e5
