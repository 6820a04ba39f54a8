"""The robustness tools of bonai_tpu_torch against the JAX scripts on the
CPU:

- ``robustness_eval`` on the same COCO-style and VOC-style pkls: the
  printed P / mPC / rPC tables equal to the JAX script's, character for
  character, and the returned arrays equal, for every print and
  aggregate mode and a metric subset;
- ``test_robustness`` on the tiny LOFT-FOA (``torch_port_common``, the
  same seeded weights in float32) over two synthetic 128^2 tiles, the
  clean run and ``brightness`` and ``jpeg_compression`` at severities 2
  and 5: the aggregate pkl has the JAX layout and each AP within 1e-3 of
  the JAX script's (its inference within 1e-4; on an x86 host the two
  come out equal), and the tables print (the same text where the APs
  are equal).
  These two corruptions draw no random numbers: the JAX script's default
  thread-mode loader shares one ``RandomState`` between its threads, so
  its random corruptions are not repeatable (ROADMAP.md queue C);
  the port's draws per batch, as the JAX process-mode loader does;
- the VOC branch of ``test_robustness`` (per-class AP lists) on a VOC
  tree with the same model.
"""

import copy
import importlib.util
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from bonai_tpu_torch.engine import save_checkpoint
from bonai_tpu_torch.tools import robustness_eval
from bonai_tpu_torch.tools import test_robustness as port_tr
from bonai_tpu_torch.tools.make_synthetic_datasets import make_voc
from torch_port_common import (ROOT, SYNTH_CONFIG, jax_model, port_model,
                               synth_data, tiny_cfg)

SIZE = 128


def _jax_tool(name, monkeypatch):
    monkeypatch.syspath_prepend(osp.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, osp.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _coco_pkl(rs, n_dist=16):
    names = port_tr.BENCHMARK_CORRUPTIONS + ["speckle"]
    out = {}
    for d in names[:n_dist]:
        out[d] = {}
        for sev in range(6):
            out[d][sev] = {t: {m: float(rs.rand()) for m in
                               robustness_eval.COCO_METRICS}
                           for t in ("bbox", "segm")}
    return out


def _voc_pkl(rs):
    return {d: {sev: [{"ap": float(rs.rand())} for _ in range(20)]
                for sev in range(6)}
            for d in port_tr.BENCHMARK_CORRUPTIONS}


def test_robustness_eval_tables_match_jax(tmp_path, monkeypatch, capsys):
    jax_eval = _jax_tool("robustness_eval", monkeypatch)
    rs = np.random.RandomState(0)
    coco, voc = _coco_pkl(rs), _voc_pkl(rs)
    path = str(tmp_path / "coco_results.pkl")
    with open(path, "wb") as f:
        pickle.dump(coco, f)
    cases = [dict(filename=coco, dataset="coco", task="bbox",
                  prints="all", aggregate="benchmark"),
             dict(filename=coco, dataset="coco", task="segm",
                  prints=["P", "rPC"], aggregate="all"),
             dict(filename=path, dataset="coco", task="bbox",
                  metric=["AP", "AP50"], prints="all"),
             dict(filename=voc, dataset="voc", prints="all"),
             dict(filename=voc, dataset="voc", task="segm",
                  metric=["AR1"], prints="mPC", aggregate="all")]
    for kw in cases:
        got = robustness_eval.get_results(**kw)
        out_port = capsys.readouterr().out
        want = jax_eval.get_results(**kw)
        out_jax = capsys.readouterr().out
        assert out_port == out_jax and "Performance" in out_port
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr("sys.argv", ["robustness_eval.py", path, "--task",
                                     "bbox", "segm", "--prints", "P",
                                     "mPC"])
    robustness_eval.main()
    out_port = capsys.readouterr().out
    jax_eval.main()
    assert out_port == capsys.readouterr().out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("robust")
    data = synth_data(tmp / "synth", n=2, size=SIZE)
    cfg = tiny_cfg(config=SYNTH_CONFIG)
    test = cfg.data.test
    test.ann_file = osp.join(data, "train", "train.json")
    test.img_prefix = osp.join(data, "train", "images") + "/"
    test.pipeline[1].img_scale = (SIZE, SIZE)
    cfg.compute_dtype = "float32"
    cfg_path = str(tmp / "tiny.py")
    cfg.dump(cfg_path)
    jm, variables = jax_model(cfg)
    pm = port_model(cfg, variables)
    ckpt = save_checkpoint(str(tmp / "wd"), 0, pm,
                           torch.optim.SGD(pm.parameters(), lr=0.1))
    return dict(tmp=tmp, cfg=cfg, cfg_path=cfg_path, jm=jm,
                variables=variables, pm=pm, ckpt=ckpt)


ARGS = ["--corruptions", "brightness", "jpeg_compression",
        "--severities", "0", "2", "5", "--eval", "bbox"]


def test_test_robustness_matches_jax(tiny, monkeypatch, capsys):
    import bonai_tpu.apis.inference as jax_inference
    from bonai_tpu import Config as JaxConfig
    out = str(tiny["tmp"] / "port.pkl")
    got = port_tr.main([tiny["cfg_path"], tiny["ckpt"], "--out", out,
                        "--device", "cpu", *ARGS])
    port_out = capsys.readouterr().out
    jax_tr = _jax_tool("test_robustness", monkeypatch)
    monkeypatch.setattr(
        jax_inference, "init_detector",
        lambda config, checkpoint: (tiny["jm"], tiny["variables"],
                                    JaxConfig.fromfile(config)))
    ref_out = str(tiny["tmp"] / "jax.pkl")
    monkeypatch.setattr("sys.argv", ["test_robustness.py", tiny["cfg_path"],
                                     "unused", "--out", ref_out, *ARGS])
    jax_tr.main()
    jax_out = capsys.readouterr().out
    with open(out, "rb") as f:
        saved = pickle.load(f)
    with open(osp.splitext(out)[0] + "_results.pkl", "rb") as f:
        assert pickle.load(f) == saved
    with open(ref_out, "rb") as f:
        want = pickle.load(f)
    assert list(saved) == list(want) == ["brightness", "jpeg_compression"]
    for corruption, by_sev in want.items():
        assert list(saved[corruption]) == list(by_sev) == [0, 2, 5]
        for sev, by_task in by_sev.items():
            assert list(saved[corruption][sev]) == list(by_task) == ["bbox"]
            a, b = saved[corruption][sev]["bbox"], by_task["bbox"]
            assert list(a) == list(b)
            for m in a:
                assert a[m] == pytest.approx(b[m], abs=1e-3), (corruption,
                                                               sev, m)
    assert saved == got
    assert saved["brightness"][0] == saved["jpeg_compression"][0]
    for text in (port_out, jax_out):
        assert "Mean Performance under Corruption [mPC] (bbox)" in text
        assert "Relative Performance under Corruption [rPC] (bbox)" in text
    if saved == want:                   # then the tables are the same text
        assert port_out.split("Aggregated results:")[1] == \
            jax_out.split("Aggregated results:")[1]


def test_test_robustness_voc_branch(tiny, capsys):
    voc_dir, split = make_voc(str(tiny["tmp"] / "voc"), n=2,
                              size=(96, SIZE), seed=3)
    cfg = copy.deepcopy(tiny["cfg"])
    test = dict(cfg.data.test)
    cfg.data.test = dict(type="VOCDataset", ann_file=split,
                         img_prefix=voc_dir + "/", pipeline=test["pipeline"])
    out = str(tiny["tmp"] / "voc.pkl")
    agg = port_tr.run_robustness(tiny["pm"], cfg, ["jpeg_compression"],
                                 [0, 5], out=out)
    assert list(agg["jpeg_compression"]) == [0, 5]
    for entry in agg["jpeg_compression"].values():
        assert isinstance(entry, list) and set(entry[0]) == {"ap"}
    robustness_eval.get_results(out, dataset="voc", prints="all")
    text = capsys.readouterr().out
    assert "Mean Performance under Corruption [mPC] in AP50" in text
