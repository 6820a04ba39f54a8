"""The training slice of bonai_tpu_torch as a whole against the JAX
package: the tiny LOFT-FOA ``forward_train`` loss dict and the gradient of
every trainable parameter, with the same weights, batch and sampler draws
(the port is handed the uniforms of JAX's own key splits), and the port's
``train_detector`` on the CPU.

Both run in float32 on the CPU, where the detector's block RoIAlign takes
the gather path in both packages.  Tolerances: each loss to 1e-4
relative; each gradient to 1e-4 of its tensor's largest magnitude (sums
in another order through a few dozen layers).
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_common import (jax_forward_train_draws, jax_model,
                               port_model, t, tiny_train_cfg, train_batch)

LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
          "loss_mask", "loss_offset")


@pytest.fixture(scope="module")
def run():
    """JAX's and the port's losses and gradients of one batch, once."""
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg = tiny_train_cfg()
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


def test_forward_train_losses_match_jax(run):
    ref, got, _, _ = run
    assert set(got) == set(ref) == set(LOSSES)
    for k in LOSSES:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


def test_gradients_match_jax(run):
    """Every trainable parameter's gradient against ``jax.grad`` of the
    same loss; the frozen stem and ``layer1`` get none."""
    _, _, ref_grads, pm = run
    trainable = 0
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            assert name.startswith(("backbone.conv1", "backbone.bn1",
                                    "backbone.layer1.")), name
            continue
        trainable += 1
        ref = ref_grads[name].numpy()
        assert p.grad is not None, name
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert trainable > 50
    # the RoI branches' gradients reach the backbone
    assert float(pm.backbone.layer4[0].conv1.weight.grad.abs().max()) > 0


def _constant_lr_cfg(lr=0.01):
    cfg = tiny_train_cfg()
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.optimizer.lr = lr
    return cfg


def _uint8_batch(seed=1):
    """A batch whose image is uint8, as the train pipeline's
    ``Normalize(device=True)`` leaves it (the step normalises it)."""
    batch = train_batch(seed=seed)
    batch["image"] = np.random.RandomState(seed).randint(
        0, 256, batch["image"].shape).astype(np.uint8)
    return batch


def test_train_detector_lowers_the_loss(tmp_path):
    """Six steps on one repeated batch at a constant LR."""
    from bonai_tpu_torch.apis import train_detector
    _, hist = train_detector(_constant_lr_cfg(), [_uint8_batch()],
                             str(tmp_path), max_steps=6, device="cpu",
                             log_interval=1)
    assert [h["iter"] for h in hist] == list(range(1, 7))
    loss = [h["loss"] for h in hist]
    assert all(np.isfinite(loss)) and all(h["lr"] > 0 for h in hist)
    assert max(loss[-2:]) < 0.5 * loss[0], loss
    rows = (tmp_path / "train_log.jsonl").read_text().splitlines()
    assert len(rows) == 6 and '"loss_offset"' in rows[0]


@pytest.fixture
def deterministic():
    """PyTorch's deterministic CPU kernels: with several threads the
    gradient scatter of an indexing op sums in a varying order, and one
    ulp of weight can move a proposal across the NMS threshold a step
    later."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_checkpoint_resumes_and_loads(tmp_path, deterministic):
    """A checkpoint of step 2 resumes the step counter (and optimizer and
    sampler state: the resumed step 3 equals an unbroken run's), and
    ``init_detector`` loads its weights as they are."""
    from bonai_tpu_torch.apis import init_detector, train_detector
    from bonai_tpu_torch.engine import latest_checkpoint
    cfg, batches = _constant_lr_cfg(), [_uint8_batch()]
    _, straight = train_detector(cfg, batches, str(tmp_path / "a"),
                                 max_steps=3, device="cpu", log_interval=1)
    train_detector(cfg, batches, str(tmp_path / "b"), max_steps=2,
                   device="cpu", log_interval=1)
    ckpt = latest_checkpoint(str(tmp_path / "b"))
    assert ckpt.endswith("step_2.pth")
    model, resumed = train_detector(cfg, batches, str(tmp_path / "b"),
                                    max_steps=3, device="cpu",
                                    resume_from=ckpt, log_interval=1)
    assert [h["iter"] for h in resumed] == [3]
    np.testing.assert_allclose(resumed[0]["loss"], straight[-1]["loss"],
                               rtol=1e-5)
    loaded = init_detector(cfg, checkpoint=latest_checkpoint(
        str(tmp_path / "b")), device="cpu", dtype=torch.float32)
    ref = model.state_dict()
    for key, value in loaded.state_dict().items():
        assert torch.equal(value, ref[key]), key


def test_train_detector_without_a_gpu_raises(monkeypatch, tmp_path):
    from bonai_tpu_torch.apis import train_detector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detector(_constant_lr_cfg(), [], str(tmp_path))
