"""A dense single-stage detector from files in bonai_tpu_torch against the
JAX package, on the CPU at tiny size: ATSS (``configs/atss/
atss_r50_fpn_1x_bonai.py`` at the widths of ``torch_port_common
.dense_cfg``) trained 2 steps on four 128^2 synthetic tiles through the
train CLI from seeded weights (an mmdet-style ``.pth`` without the GN
towers' conv biases, as mmdetection saves them), then tested with the test
CLI and ``--eval bbox``.  The test CLI's results per image equal the JAX
package's test loop (``simple_test`` + ``results_to_host``) on the trained
weights: boxes within 1e-4 px, scores within 1e-5.
"""

import copy
import json

import numpy as np
import torch

from torch_port_common import dense_cfg, jax_model, synth_data

TILES = 4


def _tiles(cfg, data, size=128):
    """``cfg``'s train and test splits reading the synthetic tiles at
    ``size``^2."""
    for split in (cfg.data.train, cfg.data.test):
        split.ann_file = f"{data}/train/train.json"
        split.img_prefix = f"{data}/train/images/"
        for step in split.pipeline:
            if step.type in ("Resize", "MultiScaleFlipAug"):
                step.img_scale = (size, size)


def jax_variables(sd, variables):
    """The JAX variables of the port's ``state_dict`` ``sd``: each leaf of
    ``variables`` (the layout) read back through ``state_dict_from_jax``
    of a tree that numbers every element (the conversion only moves
    elements)."""
    import jax
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    leaves, tree = jax.tree_util.tree_flatten(variables)
    sizes = [int(np.size(x)) for x in leaves]
    assert sum(sizes) < 2 ** 24                 # ids exact in float32
    offsets = np.cumsum([0] + sizes)
    ids = jax.tree_util.tree_unflatten(tree, [
        np.arange(o, o + n, dtype=np.float64).reshape(np.shape(x))
        for o, n, x in zip(offsets, sizes, leaves)])
    index = state_dict_from_jax(ids["params"], ids["batch_stats"])
    flat = np.full(offsets[-1], np.nan, np.float32)
    for k, v in index.items():
        flat[v.numpy().astype(np.int64).ravel()] = sd[k].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(tree, [
        flat[o:o + n].reshape(np.shape(x))
        for o, n, x in zip(offsets, sizes, leaves)])


def test_atss_train_and_test_clis_match_jax(tmp_path):
    from bonai_tpu.apis import run_inference as jax_run_inference
    from bonai_tpu.datasets import build_dataloader as jax_build_dataloader
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.engine import latest_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    from bonai_tpu_torch.tools import train as train_cli
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    data = synth_data(tmp_path / "data", n=TILES, size=128)
    cfg = dense_cfg("atss")
    _tiles(cfg, data)
    cfg.data.max_gt = 64
    cfg.compute_dtype = "float32"
    cfg.log_config = dict(interval=1)
    cfg.lr_config.warmup = None
    jm, variables = jax_model(cfg, seed=1)
    variables["params"]["bbox_head"]["atss_reg"]["kernel"] *= 0.1
    start = state_dict_from_jax(variables["params"],
                                variables["batch_stats"])
    gn_biases = [k for k in start if k.endswith(".conv.bias")
                 and k[:-len("conv.bias")] + "gn.weight" in start]
    assert len(gn_biases) == 4
    torch.save({"state_dict": {k: v for k, v in start.items()
                               if k not in gn_biases}},
               tmp_path / "start.pth")
    cfg.load_from = str(tmp_path / "start.pth")
    cfg_path = str(tmp_path / "atss.py")
    cfg.dump(cfg_path)

    wd = tmp_path / "wd"
    train_cli.main([cfg_path, "--work-dir", str(wd), "--device", "cpu",
                    "--max-steps", "2"])
    rows = [json.loads(r) for r in
            (wd / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2]
    for r in rows:
        assert {"loss_cls", "loss_bbox", "loss_centerness"} <= set(r)
        assert all(np.isfinite(r[k]) for k in r if k.startswith("loss"))
    ckpt = latest_checkpoint(str(wd))
    trained = torch.load(ckpt, map_location="cpu",
                         weights_only=False)["state_dict"]
    assert not torch.equal(trained["bbox_head.atss_cls.weight"],
                           start["bbox_head.atss_cls.weight"])
    assert all(float(trained[k].abs().max()) > 0 for k in gn_biases)

    results, metrics = test_cli.main([cfg_path, ckpt, "--eval", "bbox",
                                      "--out", str(tmp_path / "r.pkl"),
                                      "--device", "cpu"])
    assert list(metrics) == ["bbox_mAP", "bbox_mAP_50", "bbox_mAP_75"]
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    ref = jax_run_inference(
        jm, jax_variables(trained, variables), jax_build_dataloader(
            jax_build_dataset(copy.deepcopy(dict(cfg.data.test,
                                                 test_mode=True))),
            2, shuffle=False, train=False), progress=False)
    assert len(results) == len(ref) == TILES
    for got, want in zip(results, ref):
        assert len(got) == len(want) == 1 and len(got[0]) > 5
        np.testing.assert_allclose(got[0][:, :4], want[0][:, :4], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got[0][:, 4], want[0][:, 4], rtol=0,
                                   atol=1e-5)
