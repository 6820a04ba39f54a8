"""Training from files in bonai_tpu_torch.

- The synthetic recipe's backbone settings (``frozen_stages=-1,
  norm_eval=False``) against the JAX package: the tiny LOFT-FOA's losses
  (1e-4 relative) and every gradient, the stem's included (1e-4 of its
  tensor's largest magnitude), with the same weights, batch and sampler
  draws; the optimizer's parameters are the JAX optimizer's unfrozen ones
  at ``frozen_stages`` -1, 0 and 1; BatchNorm statistics do not move.
- ``python -m bonai_tpu_torch.tools.train`` at the tiny widths on the CPU,
  on tiles the port's generator wrote: finite ``train_log.jsonl`` rows, a
  checkpoint, and ``--resume-from`` continuing the iteration counter.
"""

import json

import jax
import numpy as np
import pytest
import torch

from torch_port_common import (jax_forward_train_draws, jax_model,
                               port_model, synth_data, synth_train_cfg, t,
                               tiny_train_cfg, train_batch)


def _cfg(frozen_stages=-1, norm_eval=False):
    cfg = tiny_train_cfg()
    cfg.model.backbone.update(frozen_stages=frozen_stages, norm_eval=norm_eval)
    return cfg


@pytest.fixture(scope="module")
def run():
    """JAX's and the port's losses and gradients of one batch at
    ``frozen_stages=-1, norm_eval=False``."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = _cfg()
    jm, variables = jax_model(cfg)
    batch = train_batch()
    key = jax.random.PRNGKey(3)

    def total(params, batch):
        losses = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          batch, method="forward_train",
                          rngs={"sampling": key})
        return sum(losses.values()), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"], batch)
    ref_grads = state_dict_from_jax(jax.device_get(grads),
                                    variables["batch_stats"])
    pm = port_model(cfg, variables)
    got = pm.forward_train({k: t(v) for k, v in batch.items()},
                           jax_forward_train_draws(jm, variables, key, 2))
    sum(got.values()).backward()
    return (jax.device_get(ref), {k: float(v.detach()) for k, v in got.items()},
            ref_grads, pm)


def test_losses_match_jax_with_the_stem_trained(run):
    ref, got, _, _ = run
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax_with_the_stem_trained(run):
    _, _, ref_grads, pm = run
    names = [n for n, p in pm.named_parameters()]
    assert all(p.requires_grad for p in pm.parameters())
    for name, p in pm.named_parameters():
        ref = ref_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    for stem in ("backbone.conv1.weight", "backbone.bn1.weight",
                 "backbone.layer1.0.conv1.weight"):
        assert stem in names
        assert float(pm.get_parameter(stem).grad.abs().max()) > 0, stem


@pytest.mark.parametrize("frozen_stages", [-1, 0, 1])
def test_optimizer_holds_what_jax_trains(frozen_stages):
    """The port's optimizer takes exactly the parameters the JAX
    optimizer's frozen mask leaves trainable."""
    from bonai_tpu.engine.optim import frozen_mask_from_model
    from bonai_tpu_torch.engine import build_optimizer
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = _cfg(frozen_stages)
    _, variables = jax_model(cfg)
    params = variables["params"]
    mask = jax.tree_util.tree_map(
        lambda f, p: np.full(p.shape, float(f), np.float32),
        frozen_mask_from_model(params, frozen_stages), params)
    frozen = {k for k, v in state_dict_from_jax(
        mask, variables["batch_stats"]).items()
        if not k.endswith(("running_mean", "running_var"))
        and bool(torch.as_tensor(v).all())}
    pm = port_model(cfg, variables)
    opt = build_optimizer(pm, cfg.optimizer)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    trained = {n for n, p in pm.named_parameters() if id(p) in held}
    assert trained == {n for n, _ in pm.named_parameters()} - frozen
    assert ("backbone.conv1.weight" in trained) == (frozen_stages < 0)


def test_batchnorm_statistics_stay_fixed():
    """One SGD step moves the stem and BN's affine parameters but no BN
    statistic (BatchNorm stays frozen whatever ``norm_eval`` says)."""
    from bonai_tpu_torch.apis.train import build_trainer
    from bonai_tpu_torch.core.samplers import generator_draws
    cfg = _cfg()
    model, _, step, gen = build_trainer(cfg, torch.device("cpu"), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(train_batch(), 400, generator_draws(gen))
    after = model.state_dict()
    for k, v in before.items():
        moved = not torch.equal(v, after[k])
        assert moved != k.endswith(("running_mean", "running_var")), k


def test_train_cli_from_files(tmp_path):
    from bonai_tpu_torch.tools.train import main
    data = synth_data(tmp_path / "data", n=4, size=128)
    synth_train_cfg(data).dump(str(tmp_path / "tiny.py"))
    wd = tmp_path / "wd"
    args = [str(tmp_path / "tiny.py"), "--work-dir", str(wd), "--device",
            "cpu"]
    main(args + ["--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in r if k.startswith("loss"))
        assert r["data_time"] >= 0 and r["lr"] > 0
    assert (wd / "checkpoints" / "step_2.pth").exists()
    assert (wd / "tiny.py").exists() and list(wd.glob("*.log"))
    main(args + ["--max-steps", "3", "--resume-from",
                 str(wd / "checkpoints" / "step_2.pth")])
    rows = (wd / "train_log.jsonl").read_text().splitlines()
    assert [json.loads(r)["iter"] for r in rows] == [1, 2, 3]
