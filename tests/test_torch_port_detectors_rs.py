"""DetectoRS (``configs/detectors/detectors_cascade_rcnn_r50_1x_bonai.py``)
in bonai_tpu_torch against the JAX package, at the tiny widths of
``torch_port_common.detectors_cfg`` (both ResNet-50s at base 8, a
16-channel RFP) in float32 on the CPU: ``SAConv2d`` and its gradients at
stride 1 and 2, the SAC ResNet and the RFP's backbone copy, ``ASPP`` and
``RFP``, the detector's ``simple_test`` and one training step (the RFP
copy's stem and ``layer1`` moved by weight decay alone), the weights of
both new detectors, and both through the train CLI on two gloo ranks
(DDP) and the test CLI.

The random variables' SAC parameters are set near their trained scale
(``_tame``): with ``weight_beta`` of 0.1 every SAC conv adds about 0.1 of
its input window's sum to each output, and the two ResNet-50s grow the
losses past 1e13.

Tolerances: module outputs to 1e-5 of their largest value, gradients to
1e-4 of their tensor's largest, losses 1e-4 relative; detections as in
``test_torch_port_rcnn.py``.  The gate's bias gradient
(``neck.rfp_weight.bias``) is one sum over every pixel of the five
levels of terms of both signs: it is held to 1e-4 of the sum of their
magnitudes.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_port_rcnn import IMG_SHAPE, SCALE, compare_detections
from test_torch_port_trunks import LR, WD, _jax_step
import torch_port_common as tpc
from torch_port_common import (_random_tree, detectors_cfg, htc_cfg,
                               jax_forward_train_draws, jax_model,
                               port_model, t, train_batch)

SAC = dict(type="SAC", use_deform=False)
STAGE_WITH_SAC = (False, True, True, True)


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _tame(tree, r):
    """SAC parameters near a trained scale: ``weight_gamma`` about the
    kaiming std of its conv, ``weight_beta`` about 1e-3, ``weight_diff``
    about 1e-2 (see the module's docstring)."""
    for k, x in tree.items():
        if hasattr(x, "items"):
            _tame(x, r)
        elif k == "weight_gamma":
            tree[k] = (np.sqrt(2.0 / (9 * x.shape[-1])) * (
                1 + 0.1 * r.randn(*x.shape))).astype(np.float32)
        elif k in ("weight_beta", "weight_diff"):
            scale = 1e-3 if k == "weight_beta" else 1e-2
            tree[k] = (scale * r.randn(*x.shape)).astype(np.float32)
    return tree


def _variables(module, *args, seed=0, **kw):
    """Seeded random variables of a JAX module (``_random_tree``, tamed)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw),
                            jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)
    return {c: _tame(_random_tree(v, r), r) for c, v in shapes.items()}


def _sd(params, stats, prefix):
    """``state_dict_from_jax`` of a backbone's or a neck's variables,
    keyed relative to ``prefix`` (``backbone.`` or ``neck.``)."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    part = prefix[:-1]
    sd = state_dict_from_jax({"backbone": {}, "neck": {}, part: params},
                             {"backbone": {}, part: stats})
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("stride", [1, 2])
def test_saconv_matches_jax(stride):
    """Forward and every gradient (the input's too) with non-zero
    ``weight_diff``, contexts and switch: the population std, the switch
    on the zero-padded 5x5 pool at the stride, the rate-3 branch."""
    from bonai_tpu.ops.saconv import SAConv2d as JaxSAC
    from bonai_tpu_torch.ops.saconv import SAConv2d
    r = np.random.RandomState(stride)
    x = r.randn(2, 19, 17, 8).astype(np.float32)
    jm = JaxSAC(features=12, stride=stride)
    variables = _variables(jm, x, seed=stride)
    params = variables["params"]
    params["switch"]["kernel"] = 0.3 * params["switch"]["kernel"]
    y, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), params, x)
    g = r.randn(*y.shape).astype(np.float32)
    dp, dx = vjp(g)
    m = SAConv2d(8, 12, 3, stride)
    m.load_state_dict(_conv2_sd(params))
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    out = m(xt)
    (out * t(g).permute(0, 3, 1, 2)).sum().backward()
    _close(out.detach().permute(0, 2, 3, 1), y, what="output")
    _close(xt.grad.permute(0, 2, 3, 1), dx, rel=1e-4, what="input grad")
    want = _conv2_sd(dp)
    for name, p in m.named_parameters():
        _close(p.grad, want[name], rel=1e-4, what=name)


def _conv2_sd(params):
    """A JAX ``SAConv2d``'s variables as the port's, through
    ``state_dict_from_jax`` as a block's ``conv2``."""
    return {k[len("layer1.0.conv2."):]: v for k, v in _sd(
        {"layer1_0": {"conv2": params}}, {"layer1_0": {}},
        "backbone.").items()}


@pytest.mark.parametrize("copy", [False, True], ids=["sac", "rfp_copy"])
def test_sac_resnet_matches_jax(copy):
    """The SAC ResNet-50 at base 8 with ``output_img`` (the detector's
    backbone), and the RFP's copy: ``rfp_feats`` into the first block of
    stages 2-4 through ``rfp_conv``."""
    from bonai_tpu.models.backbones.resnet import ResNet as JaxResNet
    from bonai_tpu_torch.models.backbones.resnet import ResNet
    r = np.random.RandomState(3)
    x = r.randn(2, 64, 64, 3).astype(np.float32)
    feats = [None] + [r.randn(2, 8 // 2 ** i, 8 // 2 ** i, 16).astype(
        np.float32) for i in range(3)] if copy else None
    jm = JaxResNet(depth=50, base_channels=8, sac=SAC,
                   stage_with_sac=STAGE_WITH_SAC, output_img=not copy)
    variables = _variables(jm, x, rfp_feats=feats)
    want = jm.apply(variables, x, rfp_feats=feats)
    m = ResNet(50, base_channels=8, sac=SAC, stage_with_sac=STAGE_WITH_SAC,
               output_img=not copy, rfp_inplanes=16 if copy else None)
    m.load_state_dict(_sd(variables["params"], variables["batch_stats"],
                          "backbone."))
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2), None if not copy else [None] + [
            t(f).permute(0, 3, 1, 2) for f in feats[1:]])
    assert len(got) == len(want) == 4 + (not copy)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), w, what=f"output {i}")
    rfp = {n for n, _ in m.named_parameters() if "rfp_conv" in n}
    assert rfp == ({f"layer{s}.0.rfp_conv.{w}" for s in (2, 3, 4)
                    for w in ("weight", "bias")} if copy else set())


def test_aspp_matches_jax():
    from bonai_tpu.models.necks.rfp import ASPP as JaxASPP
    from bonai_tpu_torch.models.necks.rfp import ASPP
    x = np.random.RandomState(4).randn(2, 12, 10, 16).astype(np.float32)
    jm = JaxASPP(out_channels=4)
    variables = _variables(jm, x)
    m = ASPP(16, 4)
    m.load_state_dict({k[len("rfp_aspp."):]: v for k, v in _sd(
        {"rfp_aspp": variables["params"], "fpn": {}}, {}, "neck.").items()})
    with torch.no_grad():
        got = m(t(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), jm.apply(variables, x))


def test_rfp_matches_jax():
    """Two steps over the SAC copy: the shared FPN, ASPP and gate."""
    from bonai_tpu.models.necks.rfp import RFP as JaxRFP
    from bonai_tpu_torch.models.necks.rfp import RFP
    r = np.random.RandomState(5)
    rb = dict(type="DetectoRS_ResNet", depth=50, base_channels=8,
              frozen_stages=1, rfp_inplanes=16, sac=SAC,
              stage_with_sac=STAGE_WITH_SAC, conv_cfg=dict(type="ConvAWS"))
    inputs = [r.randn(2, 64, 64, 3).astype(np.float32)] + [
        r.randn(2, 16 // 2 ** i, 16 // 2 ** i, 32 * 2 ** i).astype(
            np.float32) for i in range(4)]
    jm = JaxRFP(in_channels=(32, 64, 128, 256), out_channels=16,
                rfp_backbone=rb, aspp_out_channels=4)
    variables = _variables(jm, inputs)
    want = jm.apply(variables, inputs)
    m = RFP((32, 64, 128, 256), 16, rfp_backbone=rb, aspp_out_channels=4)
    m.load_state_dict(_sd(variables["params"], variables["batch_stats"],
                          "neck."))
    with torch.no_grad():
        got = m([t(x).permute(0, 3, 1, 2) for x in inputs])
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), w, what=f"level {i}")


_MODELS = {}


def models():
    """``(cfg, JAX model, variables)`` of the tiny DetectoRS at the
    training sizes, its SAC parameters tamed, built once."""
    if not _MODELS:
        cfg = detectors_cfg(train=True)
        jm, variables = jax_model(cfg)
        _tame(variables["params"], np.random.RandomState(7))
        _MODELS["m"] = (cfg, jm, variables)
    return _MODELS["m"]


def test_simple_test_matches_jax():
    cfg, jm, variables = models()
    pm = port_model(cfg, variables)
    image = np.random.RandomState(0).randn(2, 96, 96, 3).astype(np.float32)
    ref = tpc.jax_call(lambda v, i, s, f: jm.apply(
        v, i, s, f, method="simple_test"), variables, image, IMG_SHAPE, SCALE)
    got = pm.simple_test(t(image), t(IMG_SHAPE), t(SCALE))
    assert set(got) == set(ref) == {"det_bboxes", "det_scores",
                                    "det_labels", "det_valid", "mask_probs"}
    compare_detections(got, ref)


@pytest.fixture(scope="module")
def step():
    """One training step of both packages from the same weights, batch
    and draws (LR 1, weight decay 1e-2, as ``test_torch_port_trunks.py``),
    with the port's gradients before the clip and the summed magnitudes of
    the gate's output gradients."""
    from bonai_tpu_torch.engine import build_optimizer, make_train_step
    from bonai_tpu_torch.engine import train_step as train_step_module
    cfg, jm, variables = models()
    batch = train_batch()
    key = jax.random.PRNGKey(5)
    max_norm = cfg.optimizer_config.grad_clip.max_norm \
        if cfg.optimizer_config.get("grad_clip") else None
    ref_losses, ref_grads, ref, frozen = _jax_step(cfg, jm, variables, batch,
                                                   key, max_norm)
    pm = port_model(cfg, variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    optimizer = build_optimizer(pm, dict(type="SGD", lr=LR, momentum=0.9,
                                         weight_decay=WD))
    grads, gate = {}, []

    def gate_grads(mod, args, out):
        out.register_hook(lambda g: gate.append(float(g.abs().sum())))
    pm.neck.rfp_weight.register_forward_hook(gate_grads)
    update = train_step_module.apply_gradients

    def recording(opt, lr, max_norm=None):
        grads.update({n: None if p.grad is None else p.grad.clone()
                      for n, p in pm.named_parameters()})
        return update(opt, lr, max_norm)
    train_step_module.apply_gradients = recording
    try:
        got = make_train_step(pm, optimizer, lambda s: LR,
                              max_norm=max_norm)(
            {k: t(v) for k, v in batch.items()}, 0,
            jax_forward_train_draws(jm, variables, key, 2, cascade=True))
    finally:
        train_step_module.apply_gradients = update
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return dict(ref_losses=ref_losses, ref_grads=ref_grads, ref=ref,
                frozen=frozen, got=got, grads=grads, pm=pm, before=before,
                gate=sum(gate), trained={n for n, p in pm.named_parameters()
                                         if id(p) in held})


def test_train_step_losses_match_jax(step):
    ref, got = step["ref_losses"], step["got"]
    assert set(ref) == {"loss_rpn_cls", "loss_rpn_bbox", "loss_mask"} | {
        f"s{i}.loss_{k}" for i in range(3) for k in ("cls", "bbox")}
    for k, v in ref.items():
        assert np.isfinite(float(got[k])) and float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)


def test_train_step_gradients_match_jax(step):
    """Every trainable tensor's gradient before the clip, SAC's and the
    RFP's among them; the copy's stem and ``layer1``, behind its gradient
    stops, get none (JAX: zeros)."""
    pm, ref, grads = step["pm"], step["ref_grads"], step["grads"]
    behind = {f"neck.rfp_modules.0.{n}" for n, p in
              pm.neck.rfp_modules[0].named_parameters()
              if n.split(".")[0] in ("conv1", "bn1", "layer1")}
    assert behind <= step["trained"] and len(behind) == 33
    checked = 0
    for name in sorted(step["trained"]):
        want, got = ref[name].numpy(), grads[name]
        if name in behind:
            assert got is None and not want.any(), name
            continue
        assert got is not None, name
        if name == "neck.rfp_weight.bias":
            assert abs(float(got.sum()) - float(want.sum())) \
                <= 1e-4 * step["gate"]
            continue
        _close(got, want, rel=1e-4, what=name)
        checked += 1
    assert checked > 250
    assert any("weight_diff" in n for n in step["trained"])


def test_train_step_updates_match_jax(step):
    """Every parameter's update against optax's over the JAX frozen mask:
    the main backbone's stem and ``layer1`` do not move; the RFP copy's,
    which the mask does not cover, move by weight decay alone; every other
    tensor by its gradient."""
    pm, ref, before = step["pm"], step["ref"], step["before"]
    names = {n for n, _ in pm.named_parameters()}
    assert step["trained"] == names - step["frozen"]
    assert all(n.startswith(("backbone.conv1.", "backbone.bn1.",
                             "backbone.layer1.")) for n in step["frozen"])
    decay = 0
    for name, p in pm.named_parameters():
        want = (ref[name] - before[name]).numpy()
        moved = (p.detach() - before[name]).numpy()
        if name not in step["trained"]:
            assert not want.any() and not moved.any(), name
            continue
        if step["grads"][name] is None:
            np.testing.assert_allclose(want, -LR * WD * before[name].numpy(),
                                       rtol=1e-3, atol=1e-9, err_msg=name)
            decay += 1
        _close(moved, want, rel=1e-4, what=name)
    assert decay == 33


def test_weights_round_trip(tmp_path):
    """Both detectors' JAX variables to mmdet's keys (HTC's
    ``roi_head.mask_head.<i>``, ``conv_res`` and ``semantic_head``;
    DetectoRS's SAC ``conv2``, ``neck.rfp_modules.0`` with its
    ``rfp_conv``, ``neck.rfp_aspp.aspp.<i>``, ``neck.rfp_weight``); the
    port loads them strictly, gives them back unchanged, and
    ``init_detector`` reads them from an mmdet-style ``.pth``.  An mmdet
    DetectoRS ``.pth`` also carries ``weight_gamma``/``weight_beta`` on its
    plain ConvAWS convs: they fold into the conv's weight (mmcv's
    standardisation), so that the conv gives the ConvAWS output."""
    import torch.nn.functional as F
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    for name, cfg in (("htc", htc_cfg()), ("detectors", detectors_cfg())):
        _, variables = jax_model(cfg)
        sd = state_dict_from_jax(variables["params"],
                                 variables["batch_stats"])
        pm = port_model(cfg, variables)
        for k, v in pm.state_dict().items():
            assert torch.equal(v, sd[k]), k
        keys = set(sd)
        if name == "htc":
            assert {"roi_head.mask_head.2.conv_res.conv.weight",
                    "roi_head.semantic_head.lateral_convs.4.conv.weight",
                    "roi_head.semantic_head.conv_embedding.conv.bias",
                    "roi_head.semantic_head.conv_logits.weight"} <= keys
            assert "roi_head.mask_head.0.conv_res.conv.weight" not in keys
        else:
            assert {"backbone.layer2.0.conv2.weight_diff",
                    "backbone.layer4.2.conv2.switch.bias",
                    "neck.rfp_modules.0.layer3.0.rfp_conv.weight",
                    "neck.rfp_modules.0.layer4.0.conv2.post_context.weight",
                    "neck.rfp_aspp.aspp.3.bias", "neck.rfp_weight.weight",
                    "neck.lateral_convs.0.conv.weight"} <= keys
            assert "backbone.layer1.0.conv2.weight_gamma" not in keys
            r = np.random.RandomState(0)
            aws = ("backbone.conv1", "backbone.layer2.0.conv1",
                   "neck.rfp_modules.0.layer3.1.conv3")
            for k in aws:
                out = sd[f"{k}.weight"].shape[0]
                sd[f"{k}.weight_gamma"] = torch.from_numpy(
                    r.uniform(0.5, 2.0, (out, 1, 1, 1)).astype(np.float32))
                sd[f"{k}.weight_beta"] = torch.from_numpy(
                    r.normal(0, 0.1, (out, 1, 1, 1)).astype(np.float32))
        pth = tmp_path / f"{name}.pth"
        torch.save({"state_dict": sd, "meta": {}}, pth)
        loaded = init_detector(cfg, str(pth), device="cpu",
                               dtype=torch.float32)
        got = loaded.state_dict()
        for k, v in got.items():
            if name == "detectors" and k[:-len(".weight")] in aws:
                continue
            assert torch.equal(v, sd[k]), k
        if name == "detectors":
            x = torch.from_numpy(r.randn(1, 3, 9, 9).astype(np.float32))
            w = sd["backbone.conv1.weight"]
            flat = w.reshape(w.shape[0], -1)
            std = torch.sqrt(flat.var(dim=1) + 1e-5)[:, None, None, None]
            mean = flat.mean(dim=1)[:, None, None, None]
            want = F.conv2d(x, sd["backbone.conv1.weight_gamma"] * (
                w - mean) / std + sd["backbone.conv1.weight_beta"],
                padding=3)
            _close(F.conv2d(x, got["backbone.conv1.weight"], padding=3),
                   want, what="folded ConvAWS conv")


@pytest.mark.parametrize("name", ["htc", "detectors"])
def test_train_cli_ddp_and_test_cli(name, tmp_path):
    """Two steps of the train CLI on two gloo ranks (DDP) from four 128^2
    synthetic tiles, which must not stall on the parameters a step leaves
    out of its graph: HTC's semantic logits (the BONAI pipeline loads no
    ``gt_semantic_seg``), the RFP copy's stem and ``layer1``; they move by
    weight decay alone.  Then the test CLI scores the checkpoint with
    ``--eval bbox segm``."""
    import json
    from bonai_tpu_torch.apis.train import may_leave_unused
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.tools import test as test_cli
    from bonai_tpu_torch.tools import train as train_cli
    from test_torch_port_single_stage_files import _tiles
    from torch_port_common import synth_data
    cfg = (htc_cfg if name == "htc" else detectors_cfg)(train=True)
    _tiles(cfg, synth_data(tmp_path / "data", n=4, size=128))
    cfg.data.update(max_gt=64, workers_per_gpu=0, samples_per_gpu=1)
    cfg.compute_dtype = "float32"
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.log_config = dict(interval=1)
    cfg_path = str(tmp_path / f"{name}.py")
    cfg.dump(cfg_path)
    start = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg)
    start.init_weights(torch.Generator().manual_seed(0))
    assert may_leave_unused(start)
    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--n-devices", "2", "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert "loss_semantic" not in rows[0]
    ckpt = latest_checkpoint(str(wd))
    trained = torch.load(ckpt, map_location="cpu",
                         weights_only=False)["state_dict"]
    key = ("roi_head.semantic_head.conv_logits.weight" if name == "htc"
           else "neck.rfp_modules.0.layer1.0.conv1.weight")
    # two SGD steps of weight decay alone, momentum 0.9
    a = cfg.optimizer.lr * cfg.optimizer.weight_decay
    np.testing.assert_allclose(
        trained[key].numpy(),
        start.state_dict()[key].numpy() * ((1 - a) ** 2 - 0.9 * a),
        rtol=1e-6)
    results, metrics = test_cli.main([cfg_path, ckpt, "--eval", "bbox",
                                      "segm", "--device", "cpu"])
    assert len(results) == 4 and all(len(r) == 2 for r in results)
    assert list(metrics) == [f"{k}_mAP{s}" for k in ("bbox", "segm")
                             for s in ("", "_50", "_75")]
