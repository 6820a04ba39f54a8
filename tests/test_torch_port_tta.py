"""Test-time augmentation in bonai_tpu_torch against the JAX package, on the
CPU in float32: ``flip_device_result`` and ``merge_flip_tta`` (exact score
ties included), ``tta_cfg_from_pipeline``, ``make_tta_step`` (detection
level) and ``TwoStageDetector.aug_test`` (proposal level) on the tiny
LOFT-FOA of ``torch_port_common`` with the same weights, at the default
views; ``run_inference(tta=...)`` at both levels on two 128^2 tiles (one
process, and sharded over two gloo ranks); the test CLI and the BONAI
test CLI with ``--aug-test`` at both levels; the tiny ``attr`` model and
the ``polar`` one (at scales (1.0, 0.5)) at both levels; the cascade; and
the detectors that refuse the proposal level.

Tolerances: the same valid detections; every output within 1e-4 of its
largest magnitude; RLE masks whose pixels differ only where the port's
pasted probability is within 1e-4 of the threshold.  Each JAX step is
compiled once (a module-scoped ``jax.jit``) and reused by the direct
comparison, ``run_inference`` and the CLIs.
"""

import os.path as osp
import pickle

import jax
import numpy as np
import pytest
import torch

from bonai_tpu.apis import test as jax_test
from bonai_tpu_torch.apis import test as port_test
from bonai_tpu_torch.datasets import build_dataloader, build_dataset
from test_torch_port_test_cli import _pasted
from torch_port_common import (SYNTH_CONFIG, attr_cfg, jax_model, polar_cfg,
                               port_model, synth_data, t, tiny_cfg)

SIZE = 128
IMG_SHAPE = np.array([[128, 128], [112, 120]], np.float32)
SCALE = np.array([1.0, 0.8], np.float32)
DEFAULT = dict(scales=(1.0,), flip=True,
               flip_directions=("horizontal", "vertical"))
SCALES = dict(scales=(1.0, 0.5), flip=False, flip_directions=())
SCALED = dict(scales=(1.0, 0.5), flip=True, flip_directions=("horizontal",))
HFLIP = dict(scales=(1.0,), flip=True, flip_directions=("horizontal",))
ONE_VIEW = dict(scales=(1.0,), flip=False, flip_directions=())


def _views(kw):
    return dict(scales=kw["scales"], flip_directions=(None,) + (
        kw["flip_directions"] if kw["flip"] else ()))


def _close(got, ref, what, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(
        float(np.abs(ref).max()) if ref.size else 0.0, 1e-12), err_msg=what)


def _same_outputs(got, ref, min_valid=4):
    """Every output of the valid detections within 1e-4 of its largest
    magnitude; the image-level ``angle`` whole."""
    assert set(got) == set(ref)
    valid = np.asarray(ref["det_valid"])
    np.testing.assert_array_equal(got["det_valid"].numpy(), valid)
    assert valid.sum() >= min_valid
    for k in ref:
        if k == "angle":
            _close(got[k].numpy(), ref[k], k)
        elif k != "det_valid":
            _close(got[k].numpy()[valid], np.asarray(ref[k])[valid], k)


class _JitApply:
    """A flax model whose ``apply`` is jitted per method: the same
    function, whose trace the JAX detection-level step reuses for every
    view of the same shapes."""

    def __init__(self, model):
        self._apply = jax.jit(model.apply, static_argnames=("method",))

    def apply(self, variables, *args, method=None):
        return self._apply(variables, *args, method=method)


class Family:
    """A tiny model in both packages, and its JAX test-time augmentation
    steps compiled once each."""

    def __init__(self, cfg, tweak=None):
        self.cfg = cfg
        self.jm, self.variables = jax_model(cfg)
        if tweak is not None:
            tweak(self.variables["params"])
        self.pm = port_model(cfg, self.variables)
        self._steps = {}

    def jax_step(self, mode, kw):
        """The JAX step compiled for the module's input shapes (two 128^2
        images), at XLA's lowest backend optimisation level: the same
        function, compiled in less time."""
        key = (mode, tuple(sorted(kw.items())))
        if key not in self._steps:
            if mode == "det":
                fn = jax_test.make_tta_step(_JitApply(self.jm), jit=False,
                                            **kw)
            else:
                views = _views(kw)

                def fn(v, i, s, f):
                    return self.jm.apply(v, i, s, f, method="aug_test",
                                         **views)
            self._steps[key] = jax.jit(fn).lower(
                self.variables, _image(), IMG_SHAPE, SCALE).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
        return self._steps[key]

    def jax_out(self, mode, kw, img=None, shp=IMG_SHAPE, sf=SCALE):
        img = _image() if img is None else img
        return jax.device_get(self.jax_step(mode, kw)(self.variables, img,
                                                      shp, sf))

    def port_out(self, mode, kw, img=None, shp=IMG_SHAPE, sf=SCALE):
        img = _image() if img is None else img
        run = port_test.tta_runner(self.pm, dict(kw, mode=mode))
        return run(t(img), t(shp), t(sf))


def _image(seed=11):
    return np.random.RandomState(seed).randn(2, SIZE, SIZE, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def foa():
    return Family(tiny_cfg(config=SYNTH_CONFIG))


# ---------------------------------------------------------------------------
# the merge functions
# ---------------------------------------------------------------------------

def _padded_out(seed, n=6):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, 90, (2, n, 2))
    wh = r.uniform(8, 30, (2, n, 2))
    return dict(
        det_bboxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        det_scores=np.round(r.uniform(0.1, 0.9, (2, n)), 1).astype(
            np.float32),
        det_labels=r.randint(0, 2, (2, n)).astype(np.int32),
        det_valid=r.rand(2, n) > 0.2,
        mask_probs=r.rand(2, n, 4, 4).astype(np.float32),
        offsets=r.uniform(-9, 9, (2, n, 2)).astype(np.float32))


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_flip_device_result_matches_jax(direction):
    out = _padded_out(0)
    got = port_test.flip_device_result({k: t(v) for k, v in out.items()},
                                       t(IMG_SHAPE), direction)
    ref = jax_test.flip_device_result(out, IMG_SHAPE, direction)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_merge_flip_tta_matches_jax_with_exact_ties():
    """Scores rounded to one decimal tie exactly within and across the
    two views (and a planted duplicate box of equal score): the kept
    order, the gathered outputs and the validity equal JAX's.  An
    image-level output cannot be concatenated along the detections: both
    raise ``ValueError``."""
    a, b = _padded_out(1), _padded_out(2)
    b["det_bboxes"][0, 0] = a["det_bboxes"][0, 0] + 0.5
    b["det_scores"][0, 0] = a["det_scores"][0, 0]
    b["det_labels"][0, 0] = a["det_labels"][0, 0]
    a["det_valid"][0, 0] = b["det_valid"][0, 0] = True
    scores = np.concatenate([a["det_scores"], b["det_scores"]], 1)
    assert len(np.unique(scores[0])) < scores.shape[1]      # ties
    got = port_test.merge_flip_tta({k: t(v) for k, v in a.items()},
                                   {k: t(v) for k, v in b.items()},
                                   iou_thr=0.5, max_per_img=9)
    ref = jax_test.merge_flip_tta(a, b, iou_thr=0.5, max_per_img=9)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    a["angle"], b["angle"] = np.ones(2, np.float32), np.ones(2, np.float32)
    with pytest.raises(ValueError):
        jax_test.merge_flip_tta(a, b)
    with pytest.raises(ValueError, match="angle"):
        port_test.merge_flip_tta({k: t(v) for k, v in a.items()},
                                 {k: t(v) for k, v in b.items()})


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    return synth_data(tmp_path_factory.mktemp("tta"), n=2, size=SIZE)


def _test_split_cfg(cfg, data):
    test = cfg.data.test
    test.update(ann_file=osp.join(data, "train", "train.json"),
                img_prefix=osp.join(data, "train", "images") + "/")
    test.pipeline[1].img_scale = (SIZE, SIZE)
    cfg.data.samples_per_gpu = 2
    cfg.compute_dtype = "float32"
    return cfg


@pytest.mark.parametrize("declared", [
    None, dict(flip=True, flip_direction=["horizontal"]),
    dict(img_scale=[(128, 128), (64, 64)])])
def test_tta_cfg_from_pipeline_matches_jax(tiles, declared):
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    test = dict(_test_split_cfg(tiny_cfg(config=SYNTH_CONFIG),
                                tiles).data.test, test_mode=True)
    if declared:
        test["pipeline"][1].update(declared)
    got = port_test.tta_cfg_from_pipeline(build_dataset(dict(test)))
    want = jax_test.tta_cfg_from_pipeline(jax_build_dataset(dict(test)))
    assert got == want
    if declared is None:
        assert got == dict(scales=[1.0], flip=True,
                           flip_directions=["horizontal", "vertical"])


# ---------------------------------------------------------------------------
# both levels on the tiny LOFT-FOA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "proposal"])
def test_tta_matches_jax(foa, mode):
    """``make_tta_step`` (``det``) and ``aug_test`` (``proposal``) at the
    default views (none, horizontal, vertical), on two images of different
    shapes and scale factors (both levels at scales (1.0, 0.5): the
    ``polar`` test)."""
    kw = DEFAULT
    ref = foa.jax_out(mode, kw)
    got = foa.port_out(mode, kw)
    _same_outputs(got, ref)
    assert set(got) == {"det_bboxes", "det_scores", "det_labels",
                        "det_valid", "mask_probs", "offsets"}


def test_flip_tta_of_a_mirrored_image_is_mirrored(foa):
    """On the port alone: flip TTA (none, horizontal) of a mirrored image
    gives the mirrored detections and offsets of the image's, at both
    levels: the set of views is closed under the flip."""
    img = _image(5)[:1]
    shp, sf = np.full((1, 2), float(SIZE), np.float32), np.ones(1,
                                                                np.float32)
    kw = dict(scales=(1.0,), flip=True, flip_directions=("horizontal",))
    for mode in ("det", "proposal"):
        outs = [foa.port_out(mode, kw, im, shp, sf)
                for im in (img, img[:, :, ::-1].copy())]
        rows = []
        for out, mirror in zip(outs, (False, True)):
            v = out["det_valid"][0].numpy()
            b = out["det_bboxes"][0].numpy()[v].astype(np.float64)
            o = out["offsets"][0].numpy()[v].astype(np.float64)
            if mirror:
                b = np.stack([SIZE - b[:, 2], b[:, 1], SIZE - b[:, 0],
                              b[:, 3]], -1)
                o = o * [-1, 1]
            s = out["det_scores"][0].numpy()[v]
            rows.append(np.concatenate([b, o, s[:, None]], 1))
        a, b = (r[np.lexsort(np.round(r, 2).T)] for r in rows)
        assert len(a) == len(b) > 0, mode
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=mode)


# ---------------------------------------------------------------------------
# run_inference, sharded, and the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(foa, tiles):
    """The JAX ``run_inference`` results at both levels on the two tiles,
    through the module's compiled steps, and the port's model, loader and
    config."""
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    cfg = _test_split_cfg(tiny_cfg(config=SYNTH_CONFIG), tiles)
    test = dict(cfg.data.test, test_mode=True)
    jds = jax_build_dataset(dict(test))
    ref = {mode: jax_test.run_inference(
        foa.jm, foa.variables, jax_build_dataloader(
            jds, 2, shuffle=False, train=False),
        eval_step=foa.jax_step(mode, DEFAULT), progress=False)
        for mode in ("det", "proposal")}
    loader = build_dataloader(build_dataset(dict(test)), 2, shuffle=False,
                              train=False)
    return dict(cfg=cfg, ref=ref, loader=loader)


def _results_match(got, ref, probs=None):
    """Per image: the same detections, boxes, scores and offsets within 1e-4
    of the largest; RLE pixels differ only where the port's pasted
    probability (``probs``: per image, its mask probabilities and boxes) is
    within 1e-4 of 0.5."""
    from bonai_tpu_torch.datasets import mask_utils
    assert len(got) == len(ref) == 2
    n = 0
    for i, ((gb, gs, go), (rb, rs, ro)) in enumerate(zip(got, ref)):
        assert gb[0].shape == rb[0].shape, i
        _close(gb[0], rb[0], f"boxes {i}")
        _close(go, ro, f"offsets {i}")
        for j, (gm, rm) in enumerate(zip(gs[0], rs[0])):
            diff = mask_utils.decode_mask(gm) != mask_utils.decode_mask(rm)
            if diff.any():
                assert probs is not None, (i, j)
                p = _pasted(probs[i][0][j], probs[i][1][j], SIZE, SIZE)
                assert np.abs(p[diff] - 0.5).max() <= 1e-4, (i, j)
            n += 1
    assert n > 4


def _port_probs(foa, loader, mode):
    """Per image of the loader: the port's TTA mask probabilities and
    boxes of its valid detections."""
    run = port_test.tta_runner(foa.pm, dict(DEFAULT, mode=mode))
    out = []
    for batch, _ in loader:
        o = run(*(torch.as_tensor(batch[k]) for k in ("image", "img_shape",
                                                      "scale_factor")))
        for i in range(o["det_valid"].shape[0]):
            v = o["det_valid"][i].numpy()
            out.append((o["mask_probs"][i].numpy()[v],
                        o["det_bboxes"][i].numpy()[v]))
    return out


@pytest.mark.parametrize("mode", ["det", "proposal"])
def test_run_inference_tta_matches_jax(foa, served, mode):
    got = port_test.run_inference(foa.pm, served["loader"], progress=False,
                                  tta=dict(DEFAULT, mode=mode))
    _results_match(got, served["ref"][mode],
                   _port_probs(foa, served["loader"], mode))


def test_sharded_run_inference_tta(foa, served, tmp_path):
    """Two gloo ranks, each its shard of the two tiles, proposal level: the
    merged list equals the one-process run's (boxes and offsets within
    1e-3 px, scores 1e-4, masks exact)."""
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.engine import save_checkpoint
    import torch_port_common as tpc
    ckpt = save_checkpoint(str(tmp_path / "wd"), 0, foa.pm,
                           torch.optim.SGD(foa.pm.parameters(), lr=0.1))
    tta = dict(DEFAULT, mode="proposal")
    want = port_test.run_inference(foa.pm, served["loader"], progress=False,
                                   tta=tta)
    rc = parallel.launch(tpc.infer_rank, 2, "cpu", served["cfg"], ckpt,
                         str(tmp_path / "r.pkl"), tta,
                         work_dir=str(tmp_path), timeout=300)
    assert rc == 0
    with open(tmp_path / "r.pkl", "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0][0][:, :4], w[0][0][:, :4], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g[0][0][:, 4], w[0][0][:, 4], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-3)
        assert g[1] == w[1]


@pytest.mark.parametrize("mode", ["det", "proposal"])
def test_test_clis_aug_test_match_jax(foa, served, tmp_path, mode):
    """``tools.test`` and ``tools.bonai_test`` with ``--aug-test`` (and
    ``--aug-test-mode proposal``) on a checkpoint of the tiny LOFT-FOA: the
    BONAI test pipeline declares no views, so both run horizontal and
    vertical flips at scale 1, and each pkl equals the JAX
    ``run_inference(tta=...)`` results."""
    from bonai_tpu_torch.engine import save_checkpoint
    from bonai_tpu_torch.tools import bonai_test
    from bonai_tpu_torch.tools import test as test_cli
    cfg_path = str(tmp_path / "tiny.py")
    served["cfg"].dump(cfg_path)
    ckpt = save_checkpoint(str(tmp_path / "wd"), 0, foa.pm,
                           torch.optim.SGD(foa.pm.parameters(), lr=0.1))
    flags = ["--aug-test"] + (["--aug-test-mode", mode] if mode != "det"
                              else [])
    probs = _port_probs(foa, served["loader"], mode)
    test_cli.main([cfg_path, ckpt, "--out", str(tmp_path / "a.pkl"),
                   "--device", "cpu", *flags])
    bonai_test.main([cfg_path, ckpt, "--out", str(tmp_path / "b.pkl"),
                     "--city", "config", "--device", "cpu", *flags])
    with open(tmp_path / "a.pkl", "rb") as f:
        generic = pickle.load(f)
    with open(tmp_path / "b.pkl", "rb") as f:
        payload = pickle.load(f)
    for results in (generic, payload["results"]):
        _results_match(results, served["ref"][mode], probs)


# ---------------------------------------------------------------------------
# the attribute and polar models, and the refusals
# ---------------------------------------------------------------------------

def test_attr_model_tta_matches_jax():
    """The tiny ``attr`` model: the detection level raises ``ValueError``
    (``merge_flip_tta`` cannot concatenate the image-level ``angle``, in
    the JAX package too: ``test_merge_flip_tta_matches_jax_with_exact_
    ties``); the proposal level over (none, horizontal) averages every
    attribute output over the views (``side_face_probs`` over the
    unflipped one only, the three ``*offsets`` keys with the flip's
    polarity)."""
    cfg = attr_cfg()
    cfg.test_cfg.rcnn.score_thr = 0.0

    def raise_heights(params):
        params["height_head"]["fc_height"]["bias"] += 2.0
    fam = Family(cfg, raise_heights)
    with pytest.raises(ValueError, match="angle"):
        fam.port_out("det", DEFAULT)
    ref = fam.jax_out("proposal", HFLIP)
    got = fam.port_out("proposal", HFLIP)
    _same_outputs(got, ref)
    assert {"angle", "heights", "side_face_probs", "offset_field_offsets",
            "offset_height_offsets"} <= set(got)


def test_polar_model_tta_matches_jax():
    """The tiny ``polar`` model at scales (1.0, 0.5): at the detection
    level with the horizontal flip (four views), at the proposal level
    without.  Two odd behaviours of the JAX package, kept: its ``offsets``
    are ``(length, angle)``, yet both packages flip them as ``(dx, dy)``
    (a horizontal view negates the length); and at the detection level a
    flipped view at a scale other than 1 is mirrored about the full
    canvas, so its boxes land off the image (ROADMAP.md queue C)."""
    fam = Family(polar_cfg())
    for mode, kw in (("det", SCALED), ("proposal", SCALES)):
        got = fam.port_out(mode, kw)
        _same_outputs(got, fam.jax_out(mode, kw))
        if mode == "det":
            assert float(got["det_bboxes"].max()) > SIZE
    one = fam.port_out("det", ONE_VIEW)
    flipped = port_test.flip_device_result(one, t(IMG_SHAPE))
    np.testing.assert_array_equal(flipped["offsets"][..., 0].numpy(),
                                  -one["offsets"][..., 0].numpy())


@pytest.mark.parametrize("family", ["retinanet", "rpn", "fast_rcnn", "htc"])
def test_proposal_level_refusals(family):
    """The detectors whose JAX ``aug_test`` does not run refuse the proposal
    level with ``ValueError`` naming the detector: the single-stage
    detectors (no ``aug_test`` in JAX), the RPN-only detector (no box head:
    ``AttributeError`` in JAX), Fast R-CNN (no RPN: ``TypeError``, shown
    here), HTC (no single mask head: flax's ``ScopeParamNotFoundError``;
    the RPN's and HTC's JAX failures are recorded in ROADMAP.md queue C).
    Fast R-CNN refuses the detection level too (its ``simple_test`` needs
    the proposals)."""
    from bonai_tpu.models.detectors.single_stage import \
        RetinaNet as JaxRetinaNet
    from bonai_tpu_torch.models import build_detector
    from torch_port_common import a7_cfg, dense_cfg, htc_cfg
    cfg = {"retinanet": lambda: dense_cfg("retinanet"),
           "rpn": lambda: a7_cfg("rpn"),
           "fast_rcnn": lambda: a7_cfg("fast_rcnn"),
           "htc": htc_cfg}[family]()
    if family == "fast_rcnn":
        fam = Family(cfg)
        with pytest.raises(TypeError):
            fam.jax_out("proposal", DEFAULT)
        pm = fam.pm
    else:
        pm = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg).eval()
    name = type(pm).__name__
    with pytest.raises(ValueError, match=name):
        pm.aug_test(t(_image()), t(IMG_SHAPE), t(SCALE), **_views(DEFAULT))
    if family == "retinanet":
        assert not hasattr(JaxRetinaNet, "aug_test")
    if family == "fast_rcnn":
        for mode in ("det", "proposal"):
            with pytest.raises(ValueError, match=name):
                port_test.tta_runner(pm, dict(DEFAULT, mode=mode))


def test_cascade_aug_test_matches_jax():
    """The JAX cascade's ``aug_test`` runs the trunk's single-head path:
    its first stage's head with its last stage's coder (ROADMAP.md queue
    C); so does the port, one unflipped view."""
    from torch_port_common import CASCADE_CONFIG
    fam = Family(tiny_cfg(config=CASCADE_CONFIG))
    _same_outputs(fam.port_out("proposal", ONE_VIEW),
                  fam.jax_out("proposal", ONE_VIEW))
