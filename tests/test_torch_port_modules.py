"""bonai_tpu_torch modules against the JAX package, one module at a time,
at the tiny LOFT-FOA widths with the same weights (carried across by
``state_dict_from_jax``) and the same inputs.  float32 on the CPU;
tolerances are stated per comparison (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import jax_model, port_model, t, tiny_cfg
from bonai_tpu_torch.models.roi_heads.offset_heads import foa_offset_fusion

IMG_SHAPE = np.array([[96, 96], [80, 90]], np.float32)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_cfg()
    jm, variables = jax_model(cfg)
    return cfg, jm, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)


def _apply(jm, variables, fn, *args):
    return jax.device_get(jm.apply(variables, *args, method=fn))


def test_backbone_fpn_match_jax(models, image):
    _, jm, variables, pm = models
    ref = _apply(jm, variables, lambda m, x: m.extract_feat(x),
                 jnp.asarray(image))
    with torch.no_grad():
        got = pm.extract_feat(t(image))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4)


def test_rpn_proposals_match_jax(models, image):
    """Same FPN features into both RPNs: the same valid proposals."""
    cfg, jm, variables, pm = models
    rpn_cfg = dict(cfg.test_cfg.rpn)
    feats = _apply(jm, variables, lambda m, x: m.extract_feat(x),
                   jnp.asarray(image))
    ref = _apply(jm, variables,
                 lambda m, f, s: m._rpn_and_proposals(f, s, rpn_cfg)[3:],
                 feats, jnp.asarray(IMG_SHAPE))
    with torch.no_grad():
        got = pm._rpn_and_proposals([t(f) for f in feats], t(IMG_SHAPE),
                                    rpn_cfg)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    v = ref[2]
    assert v.sum() > 20
    np.testing.assert_allclose(got[0].numpy()[v], ref[0][v], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy()[v], ref[1][v], rtol=1e-5,
                               atol=1e-5)


def test_roi_heads_match_jax(models):
    cfg, jm, variables, pm = models
    r = np.random.RandomState(1)
    roi7 = r.randn(12, 7, 7, 16).astype(np.float32)
    roi14 = r.randn(12, 14, 14, 16).astype(np.float32)
    heads = pm.roi_head
    with torch.no_grad():
        cls, reg = heads["bbox_head"](t(roi7))
        mask = heads["mask_head"](t(roi14))
        off = heads["offset_head"](t(roi7))
    j_cls, j_reg = _apply(jm, variables, lambda m, x: m.bbox_head_m(x),
                          jnp.asarray(roi7))
    np.testing.assert_allclose(cls.numpy(), j_cls, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), j_reg, rtol=1e-4, atol=1e-5)
    j_mask = _apply(jm, variables, lambda m, x: m.mask_head_m(x),
                    jnp.asarray(roi14))
    assert mask.shape == (12, 1, 28, 28)
    np.testing.assert_allclose(mask.numpy()[:, 0], j_mask[..., 0],
                               rtol=1e-4, atol=1e-5)
    j_off = _apply(jm, variables, lambda m, x: m.offset_head_m(x),
                   jnp.asarray(roi7))
    assert off.shape == (4, 12, 2)
    np.testing.assert_allclose(off.numpy(), j_off, rtol=1e-4, atol=1e-5)


def test_foa_offset_fusion_matches_jax():
    from bonai_tpu.models.roi_heads.offset_heads import \
        foa_offset_fusion as jax_fusion
    pred = np.random.RandomState(2).randn(4, 30, 2).astype(np.float32)
    rot = (0, 90, 180, 270)
    np.testing.assert_array_equal(foa_offset_fusion(t(pred), rot).numpy(),
                                  np.asarray(jax_fusion(pred, rot)))


def test_state_dict_from_jax_inverts_the_importer():
    """``mmdet_checkpoint_to_params`` of the converted state_dict gives
    back the JAX variables exactly (256-channel heads: the importer's
    first-FC reorder assumes C=256)."""
    from bonai_tpu.utils.torch_import import mmdet_checkpoint_to_params
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = tiny_cfg()
    m = cfg.model
    m.neck.out_channels = 256
    m.rpn_head.update(in_channels=256, feat_channels=32)
    m.roi_head.bbox_head.in_channels = 256
    m.roi_head.mask_head.in_channels = 256
    m.roi_head.offset_head.update(in_channels=256, conv_out_channels=256,
                                  num_convs=1)
    _, variables = jax_model(cfg)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(
        variables["params"], variables["batch_stats"]).items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats = mmdet_checkpoint_to_params(sd, zeros["params"],
                                               zeros["batch_stats"])
    got = jax.tree_util.tree_leaves_with_path({"params": params,
                                               "batch_stats": stats})
    ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(got) == len(ref)
    for path, leaf in got:
        np.testing.assert_array_equal(np.asarray(leaf), ref[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_port_imports_nothing_of_the_jax_side():
    """Every module of ``bonai_tpu_torch/`` and ``chip_smoke.py`` imports
    no ``jax``, ``flax``, ``cv2`` or ``bonai_tpu``, neither at the top of
    a file nor inside a function (the port runs on a machine that has
    none of them)."""
    import ast
    import os.path as osp
    from pathlib import Path
    from torch_port_common import ROOT
    banned = {"jax", "flax", "cv2", "bonai_tpu"}
    files = sorted(Path(ROOT, "bonai_tpu_torch").rglob("*.py"))
    files.append(Path(ROOT, "chip_smoke.py"))
    assert len(files) > 50
    assert {"bonai_tpu_torch/ops/saconv.py",
            "bonai_tpu_torch/models/necks/rfp.py",
            "bonai_tpu_torch/models/detectors/htc.py",
            "bonai_tpu_torch/models/dense_heads/reppoints_head.py",
            "bonai_tpu_torch/models/dense_heads/ga_rpn_head.py",
            "bonai_tpu_torch/models/dense_heads/fsaf_head.py",
            "bonai_tpu_torch/models/dense_heads/fovea_head.py",
            "bonai_tpu_torch/models/necks/nas_fpn.py",
            "bonai_tpu_torch/models/necks/nasfcos_fpn.py",
            "bonai_tpu_torch/models/dense_heads/ssd_head.py",
            "bonai_tpu_torch/models/dense_heads/corner_head.py",
            "bonai_tpu_torch/utils/color.py",
            "bonai_tpu_torch/native.py",
            "bonai_tpu_torch/utils/visualize.py",
            "bonai_tpu_torch/tools/export_model.py",
            "bonai_tpu_torch/tools/coco_error_analysis_f1.py"} <= {
        osp.relpath(p, ROOT) for p in files}
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            found += [f"{osp.relpath(path, ROOT)}:{node.lineno} {name}"
                      for name in names if name.split(".")[0] in banned]
    assert not found, found
