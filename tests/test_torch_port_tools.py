"""bonai_tpu_torch's host tools against the JAX package's on the CPU:
``utils/{collect_env,profiling,async_utils,visualize}.py``, the mask
library (``native.py`` over ``csrc/maskops.cpp``) and ``datasets/
mask_utils.py`` on it, and the tools ``print_config``, ``analyze_logs``,
``publish_model``, ``fuse_conv_bn``, ``browse_dataset`` and
``coco_error_analysis[_f1]``; and the new drawing calls of
``utils/raster.py`` against cv2.

Tolerances: every comparison is exact (bytes, elements, pixels), but for
the fused model's serving outputs, held to the unfused model's within 1e-5
of each output's largest value (the fold changes the float rounding of each
BatchNorm), and for the drawings: a label's pixels inside the box of
``cv2.getTextSize`` (the port draws its own font), and the pixels within
2 px of a thick diagonal stroke that crosses the image's border (``line``,
``arrowed_line``), are not compared.
"""

import asyncio
import hashlib
import importlib.util
import json
import os
import os.path as osp
import pickle
import re
import runpy
import sys

import cv2
import numpy as np
import pytest
import torch

from bonai_tpu_torch.utils import raster
from bonai_tpu_torch.utils.png import read_png
from torch_port_common import (CONFIG, DENSE_CONFIGS, HTC_CONFIG,
                               MASK_RCNN_CONFIG, ROOT, SYNTH_CONFIG,
                               jax_model, port_model, synth_data,
                               synth_train_cfg, t, tiny_cfg)

RUN2X_LOG = osp.join(ROOT, "data", "torch_run2x", "train_log.jsonl")


def _jax_tool(name):
    """The module of the JAX tool ``tools/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", osp.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv, monkeypatch):
    """Run ``tools/<name>.py`` as a script with ``argv``."""
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    monkeypatch.syspath_prepend(ROOT)
    runpy.run_path(osp.join(ROOT, "tools", f"{name}.py"),
                   run_name="__main__")


# --- utils ------------------------------------------------------------------

def test_collect_env_has_the_jax_keys():
    from bonai_tpu.utils.collect_env import collect_env as jax_env
    from bonai_tpu_torch.engine.checkpoint import VERSION
    from bonai_tpu_torch.utils.collect_env import collect_env, env_info_str
    env, ref = collect_env(), jax_env()
    for k in ("sys.platform", "Python", "Platform", "numpy"):
        assert env[k] == ref[k]
    assert env["PyTorch"] == torch.__version__
    assert env["Devices"] == "cpu" and env["bonai_tpu_torch"] == VERSION
    assert env["GCC"].startswith("g++")
    assert env_info_str().splitlines()[0] == f"sys.platform: {sys.platform}"


def test_profiling_matches_jax(capsys, tmp_path):
    from bonai_tpu.utils import profiling as jax_prof
    from bonai_tpu_torch.utils import profiling
    with jax_prof.profile_time("serve", "call"):
        pass
    with profiling.profile_time("serve", "call") as timed:
        torch.ones(3).sum()
    with profiling.profile_time("serve", "off", enabled=False) as off:
        pass
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and off == {} and timed["ms"] >= 0
    assert all(re.fullmatch(r"serve call elapsed_time: \d+\.\d\d ms", line)
               for line in lines)
    calls = {"jax": [], "port": []}
    for key, mod in (("jax", jax_prof), ("port", profiling)):
        assert mod.timed(calls[key].append, 1, iters=3, warmup=2) >= 0
    assert calls["jax"] == calls["port"] == [1] * 5
    with profiling.device_trace(str(tmp_path)):
        torch.arange(8.0).cumsum(0)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("cumsum" in n for n in names)


def _async_log(mod):
    """Five jobs under ``concurrent`` (two at a time), each queueing its
    work inside ``completed``: the order of events and the peak count in
    flight."""
    log, active, peak = [], [0], [0]

    async def job(i, limiter):
        async with mod.concurrent(limiter):
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            async with mod.completed("serve", str(i)):
                log.append(("queued", i))
            log.append(("done", i))
            await asyncio.sleep(0)
            active[0] -= 1

    async def main():
        limiter = asyncio.Semaphore(2)
        await asyncio.gather(*(job(i, limiter) for i in range(5)))
    asyncio.run(main())
    return log, peak[0]


def test_async_utils_match_jax():
    from bonai_tpu.utils import async_utils as jax_async
    from bonai_tpu_torch.utils import async_utils
    got = _async_log(async_utils)
    assert got == _async_log(jax_async)
    assert got[1] == 2 and len(got[0]) == 10


# --- the mask library -------------------------------------------------------

def _masks():
    """Random masks of several shapes and densities, and planted ones: all
    zero, all one, a first pixel of 1, a last pixel of 1, one column, one
    pixel, an empty mask."""
    r = np.random.RandomState(0)
    out = [(r.rand(*s) > p).astype(np.uint8)
           for s in ((17, 13), (64, 64), (5, 100), (128, 96))
           for p in (0.3, 0.8, 0.97)]
    first = np.zeros((9, 7), np.uint8)
    first[0, 0] = 1
    last = np.zeros((9, 7), np.uint8)
    last[-1, -1] = 1
    column = np.zeros((9, 7), np.uint8)
    column[:, 3] = 1
    return out + [np.zeros((9, 7), np.uint8), np.ones((9, 7), np.uint8),
                  first, last, column, np.ones((1, 1), np.uint8),
                  np.zeros((3, 0), np.uint8)]


def _np_counts(mask):
    flat = mask.flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + counts if flat[0] else counts


def test_mask_library_matches_jax_and_numpy():
    """RLE encode and decode, the IoU matrix, the paste and the polygon
    fill of the port's library equal the JAX library's and the numpy
    paths, element for element."""
    from bonai_tpu import native as jax_native
    from bonai_tpu_torch import native
    from bonai_tpu_torch.datasets import mask_utils
    masks = _masks()
    for m in masks:
        counts = native.rle_encode_counts(m)
        assert counts == jax_native.rle_encode_counts(m) == _np_counts(m)
        h, w = m.shape
        back = native.rle_decode_counts(counts, h, w)
        assert np.array_equal(back, m)
        assert np.array_equal(back, jax_native.rle_decode_counts(counts, h, w))
        assert np.array_equal(back, mask_utils.rle_counts_to_mask(
            counts, h, w, native=False))
    assert native.rle_encode_counts(masks[-7]) == [63]           # all zero
    assert native.rle_encode_counts(masks[-6]) == [0, 63]        # all one
    assert native.rle_encode_counts(masks[-5])[:2] == [0, 1]     # first 1
    same = [m for m in masks if m.shape == (9, 7)]
    ca = [native.rle_encode_counts(m) for m in same]
    got = native.rle_iou_matrix(ca, ca[::-1])
    assert np.array_equal(got, [[jax_native.rle_iou_native(a, b)
                                 for b in ca[::-1]] for a in ca])
    assert native.rle_iou_matrix([], ca).shape == (0, len(ca))
    r = np.random.RandomState(1)
    for _ in range(20):
        prob = r.rand(28, 28).astype(np.float32)
        box = r.uniform(-20, 80, 2).tolist()
        box += (np.asarray(box) + r.uniform(1, 60, 2)).tolist()
        got = native.paste_mask_native(prob, box, np.zeros((64, 48),
                                                           np.uint8))
        want = np.zeros((64, 48), np.uint8)
        jax_native.paste_mask_native(prob, box, want)
        assert np.array_equal(got, want)
        k = int(r.randint(3, 9))              # star-shaped about a centre
        ang = np.sort(r.uniform(0, 2 * np.pi, k))
        rad = r.uniform(4, 30, k)[:, None]
        poly = (r.uniform(0, 60, 2) + rad * np.stack(
            [np.cos(ang), np.sin(ang)], 1)).astype(np.float32)
        got = native.fill_poly_native(poly, 64, 48)
        want = np.zeros((64, 48), np.uint8)
        jax_native.lib().fill_poly(np.ascontiguousarray(poly).ctypes.data,
                                   len(poly), want.ctypes.data, 64, 48)
        assert np.array_equal(got, want) and got.sum() > 0


def test_mask_utils_take_the_library():
    """``encode_mask``, ``decode_mask`` and ``mask_iou`` on the library
    equal their numpy versions (``native=False``) and the JAX functions."""
    from bonai_tpu.datasets import mask_utils as jax_mask_utils
    from bonai_tpu_torch.datasets import mask_utils
    masks = [m for m in _masks() if m.shape == (64, 64)] + [
        np.zeros((64, 64), np.uint8), np.ones((64, 64), np.uint8)]
    rles = [mask_utils.encode_mask(m) for m in masks]
    for m, rle in zip(masks, rles):
        assert rle == mask_utils.encode_mask(m, native=False)
        assert rle == jax_mask_utils.encode_mask(m)
        assert np.array_equal(mask_utils.decode_mask(rle), m)
        assert np.array_equal(mask_utils.decode_mask(rle, native=False), m)
    got = mask_utils.mask_iou(rles, rles[::-1])
    assert np.array_equal(got, mask_utils.mask_iou(rles, rles[::-1],
                                                   native=False))
    assert np.array_equal(got, jax_mask_utils.mask_iou(rles, rles[::-1]))
    crowd = np.arange(len(rles)) % 2 == 0
    assert np.array_equal(mask_utils.mask_iou(rles, rles, iscrowd=crowd),
                          jax_mask_utils.mask_iou(rles, rles, iscrowd=crowd))


def test_failed_library_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ refuses raises with its output."""
    from bonai_tpu_torch import native
    bad = tmp_path / "maskops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# --- configs and logs -------------------------------------------------------

@pytest.mark.parametrize("config,options", [
    (CONFIG, None), (MASK_RCNN_CONFIG, None), (HTC_CONFIG, None),
    (DENSE_CONFIGS["atss"], ["model.backbone.depth=101",
                             "data.samples_per_gpu=4", "optimizer.lr=0.02",
                             "model.neck.out_channels=128"])])
def test_print_config_prints_the_jax_bytes(config, options, capsys,
                                           monkeypatch):
    from bonai_tpu_torch.tools import print_config
    argv = [config] + (["--options", *options] if options else [])
    _run_jax_tool("print_config", argv, monkeypatch)
    want = capsys.readouterr().out
    print_config.main(argv)
    got = capsys.readouterr().out
    assert got == want and got.startswith(f"Config path: {config}")


def test_cal_train_time_prints_the_jax_lines(tmp_path, capsys, monkeypatch):
    """On the port-written log of the A4 run, and on a log without timed
    rows."""
    from bonai_tpu_torch.tools import analyze_logs
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"epoch": 1, "iter": 1}) + "\n")
    argv = ["cal_train_time", RUN2X_LOG, str(empty)]
    _run_jax_tool("analyze_logs", argv, monkeypatch)
    want = capsys.readouterr().out
    analyze_logs.main(argv)
    got = capsys.readouterr().out
    assert got == want and got.splitlines()[1].endswith("no records")
    assert "avg " in got.splitlines()[0]


def test_plot_curve_draws_and_names_matplotlib(tmp_path, monkeypatch):
    from bonai_tpu_torch.tools import analyze_logs
    out = str(tmp_path / "curve.png")
    analyze_logs.main(["plot_curve", RUN2X_LOG, "--keys", "loss",
                       "loss_cls", "--out", out])
    assert read_png(out).shape[2] == 3
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        analyze_logs.plot_curve([RUN2X_LOG], out=out)


# --- checkpoints ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny LOFT-FOA: config, JAX variables, the port's model."""
    cfg = tiny_cfg()
    cfg.compute_dtype = "float32"
    _, variables = jax_model(cfg)
    return cfg, variables, port_model(cfg, variables)


def _orbax_ckpt(path, variables):
    """A JAX training checkpoint directory (``state`` with an optimizer
    entry, and ``meta.json``) of ``variables``."""
    import orbax.checkpoint as ocp
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"], "step": np.int32(3),
             "opt_state": {"trace": variables["params"]}}
    ckpter = ocp.StandardCheckpointer()
    ckpter.save(osp.join(path, "state"), state, force=True)
    ckpter.wait_until_finished()
    with open(osp.join(path, "meta.json"), "w") as f:
        json.dump({"CLASSES": ["building"]}, f)


def _orbax_restore(path):
    import orbax.checkpoint as ocp
    return ocp.StandardCheckpointer().restore(osp.join(path, "state"))


def _port_ckpt(tmp_path, model, cfg):
    from bonai_tpu_torch.engine.checkpoint import (provenance_meta,
                                                   save_checkpoint)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return save_checkpoint(str(tmp_path / "wd"), 3, model, opt,
                           meta=provenance_meta(cfg, ["building"]),
                           generator=torch.Generator().manual_seed(0))


def test_publish_model_keeps_what_jax_keeps(tiny, tmp_path, monkeypatch,
                                            capsys):
    """The JAX tool keeps params, batch_stats, step and meta; the port's
    keeps the state_dict (the same weights), step and meta, drops the
    optimizer and the generators, names the file by the first 8 hex digits
    of its sha256, and serves as the checkpoint does."""
    from bonai_tpu_torch.apis import inference_detector, init_detector
    from bonai_tpu_torch.tools.publish_model import main, publish_model
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    cfg, variables, model = tiny
    _orbax_ckpt(str(tmp_path / "jax"), variables)
    _run_jax_tool("publish_model", [str(tmp_path / "jax"),
                                    str(tmp_path / "jax_pub")], monkeypatch)
    published = capsys.readouterr().out.split()[-1]
    jax_pub = _orbax_restore(published)
    assert set(jax_pub) == {"params", "batch_stats", "step"}
    ckpt = _port_ckpt(tmp_path, model, cfg)
    out = publish_model(ckpt, str(tmp_path / "pub"))
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert out == f"{tmp_path / 'pub'}-{digest[:8]}.pth"
    got = torch.load(out, weights_only=True)
    src = torch.load(ckpt, weights_only=True)
    assert set(got) == {"meta", "state_dict", "step"} and got["step"] == 3
    assert got["meta"] == src["meta"] and "optimizer" in src
    want = state_dict_from_jax(jax_pub["params"], jax_pub["batch_stats"])
    assert set(got["state_dict"]) == set(want)
    assert all(torch.equal(got["state_dict"][k], want[k]) for k in want)
    main([ckpt, str(tmp_path / "cli")])
    assert capsys.readouterr().out.startswith("published ")
    img = (np.random.RandomState(0).rand(128, 128, 3) * 255).astype(np.uint8)
    a = inference_detector(init_detector(cfg, ckpt, device="cpu",
                                         dtype=torch.float32), img)
    b = inference_detector(init_detector(cfg, out, device="cpu",
                                         dtype=torch.float32), img)
    assert pickle.dumps(a) == pickle.dumps(b)


def test_fuse_state_dict_equals_jax_fuse_tree(tiny, tmp_path, monkeypatch,
                                              capsys):
    """``fuse_state_dict(state_dict_from_jax(p, s))`` equals
    ``state_dict_from_jax(*fuse_tree(p, s))`` to the bit, and the CLI
    equals the JAX CLI on the same checkpoint."""
    from bonai_tpu_torch.tools.fuse_conv_bn import fuse_state_dict, main
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    _, variables, model = tiny
    p, s = variables["params"], variables["batch_stats"]
    fuse_tree = _jax_tool("fuse_conv_bn").fuse_tree
    got = fuse_state_dict(state_dict_from_jax(p, s))
    want = state_dict_from_jax(*fuse_tree(p, s))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    bn = [k[:-len("running_var")] for k in got if k.endswith("running_var")]
    assert len(bn) == 20 and all(             # ResNet-18's BatchNorms
        torch.equal(got[b + "running_var"], torch.ones_like(
            got[b + "running_var"])) for b in bn)
    _orbax_ckpt(str(tmp_path / "jax"), variables)
    _run_jax_tool("fuse_conv_bn", [str(tmp_path / "jax"),
                                   str(tmp_path / "jax_fused")], monkeypatch)
    jax_fused = _orbax_restore(str(tmp_path / "jax_fused"))
    src = str(tmp_path / "in.pth")
    torch.save({"state_dict": state_dict_from_jax(p, s), "step": 3}, src)
    main([src, str(tmp_path / "fused.pth")])
    cli = torch.load(tmp_path / "fused.pth", weights_only=True)
    want = state_dict_from_jax(jax_fused["params"], jax_fused["batch_stats"])
    assert all(torch.equal(cli["state_dict"][k], want[k]) for k in want)
    assert cli["step"] == 3


def test_fused_model_serves_as_the_unfused(tiny):
    from bonai_tpu_torch.tools.fuse_conv_bn import fuse_state_dict
    from bonai_tpu_torch.models import build_detector
    cfg, _, model = tiny
    fused = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg).eval()
    fused.load_state_dict(fuse_state_dict(model.state_dict()))
    img = t(np.random.RandomState(2).normal(0, 1, (2, 128, 128, 3))
            .astype(np.float32))
    args = (img, t(np.array([[128, 128], [120, 128]], np.float32)),
            t(np.array([1.0, 0.9], np.float32)))
    want, got = model.simple_test(*args), fused.simple_test(*args)
    assert set(got) == set(want) and want["det_valid"].sum() > 4
    for k in want:
        if want[k].dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(got[k], want[k]), k
        else:
            tol = 1e-5 * want[k].abs().max().item()
            assert (got[k] - want[k]).abs().max().item() <= tol, k


# --- drawing ----------------------------------------------------------------

def _near_strokes(shape, strokes, thickness=2, margin=2.0):
    """Pixels within ``thickness / 2 + margin`` of any segment."""
    yy, xx = np.mgrid[:shape[0], :shape[1]].astype(np.float64)
    near = np.zeros(shape[:2], bool)
    for (ax, ay), (bx, by) in strokes:
        vx, vy = bx - ax, by - ay
        den = vx * vx + vy * vy
        tt = np.zeros_like(xx) if den == 0 else np.clip(
            ((xx - ax) * vx + (yy - ay) * vy) / den, 0, 1)
        near |= np.hypot(xx - ax - tt * vx, yy - ay - tt * vy) \
            <= thickness / 2 + margin
    return near


def _arrow_strokes(p1, p2, tip=0.1):
    (x1, y1), (x2, y2) = p1, p2
    size = np.hypot(x1 - x2, y1 - y2) * tip
    ang = np.arctan2(y1 - y2, x1 - x2)
    tips = [(round(x2 + size * np.cos(ang + s * np.pi / 4)),
             round(y2 + size * np.sin(ang + s * np.pi / 4))) for s in (1, -1)]
    return [(p1, p2)] + [(q, p2) for q in tips]


def test_rectangles_and_thin_polylines_are_cv2s():
    """``rectangle`` at every thickness and ``polylines`` of thickness 1 are
    cv2's pixel for pixel, parts off the image included."""
    r = np.random.RandomState(0)
    for _ in range(150):
        h, w = (int(v) for v in r.randint(16, 96, 2))
        base = r.randint(0, 255, (h, w, 3)).astype(np.uint8)
        p1 = (int(r.randint(-20, w + 20)), int(r.randint(-20, h + 20)))
        p2 = (int(r.randint(-20, w + 20)), int(r.randint(-20, h + 20)))
        col = tuple(int(v) for v in r.randint(0, 256, 3))
        th = int(r.randint(1, 5))
        want = cv2.rectangle(base.copy(), p1, p2, col, th)
        assert np.array_equal(raster.rectangle(base.copy(), p1, p2, col, th),
                              want)
        pts = r.randint(-10, max(h, w) + 10,
                        (int(r.randint(2, 7)), 2)).astype(np.int32)
        closed = bool(r.randint(2))
        want = cv2.polylines(base.copy(), [pts], closed, col, 1)
        assert np.array_equal(raster.polylines(base.copy(), [pts], closed,
                                               col, 1), want)


def test_thick_lines_and_arrows_are_cv2s_inside():
    """``line`` and ``arrowed_line`` of thickness 2 and 3 are cv2's pixel
    for pixel when both ends lie inside the image, and elsewhere differ
    only within 2 px of the stroke."""
    r = np.random.RandomState(1)
    crossing = 0
    for _ in range(200):
        h, w = (int(v) for v in r.randint(24, 96, 2))
        base = r.randint(0, 255, (h, w)).astype(np.uint8)
        pad = int(r.choice([0, 20]))
        p1 = (int(r.randint(-pad, w + pad)), int(r.randint(-pad, h + pad)))
        p2 = (int(r.randint(-pad, w + pad)), int(r.randint(-pad, h + pad)))
        th = int(r.randint(2, 4))
        inside = all(0 <= p[0] < w and 0 <= p[1] < h for p in (p1, p2))
        for ours, theirs, strokes in (
                (raster.line, cv2.line, [(p1, p2)]),
                (raster.arrowed_line, cv2.arrowedLine,
                 _arrow_strokes(p1, p2))):
            got = ours(base.copy(), p1, p2, 200, th)
            want = theirs(base.copy(), p1, p2, 200, th)
            if inside:
                assert np.array_equal(got, want)
            else:
                far = ~_near_strokes(base.shape, strokes, th)
                assert np.array_equal(got[far], want[far])
                crossing += not np.array_equal(got, want)
    assert crossing > 10


def _label_boxes(result, class_names, score_thr):
    """``(x0, y0, x1, y1)`` of each drawn label's ``cv2.getTextSize`` box,
    one pixel wider on every side."""
    boxes = []
    for c, dets in enumerate(result[0]):
        for det in np.asarray(dets, np.float32).reshape(-1, 5):
            if det[4] < score_thr:
                continue
            x1, y1 = det[:2].astype(int)
            label = class_names[c] if c < len(class_names) else str(c)
            (tw, th), base = cv2.getTextSize(f"{label} {det[4]:.2f}",
                                             cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
            oy = max(y1 - 3, 0)
            boxes.append((x1 - 1, oy - th - 1, x1 + tw + 1, oy + base + 1))
    return boxes


def test_show_result_matches_jax(tmp_path):
    """The JAX ``show_result`` (cv2) and the port's on boxes (some past the
    image's border), masks and offsets of two classes: equal outside the
    labels' text boxes and 2 px of the arrows that cross the border; the
    PNG written."""
    from bonai_tpu.utils.visualize import show_result as jax_show
    from bonai_tpu_torch.datasets import mask_utils
    from bonai_tpu_torch.utils.visualize import show_result
    r = np.random.RandomState(3)
    h, w = 160, 200
    img = r.randint(0, 255, (h, w, 3)).astype(np.uint8)
    bbox, segm, offsets = [], [], []
    for c in range(2):
        xy = r.uniform(-10, 150, (5, 2))
        boxes = np.concatenate([xy, xy + r.uniform(8, 60, (5, 2))], 1)
        scores = np.array([0.9, 0.2, 0.55, 0.31, 0.99])
        bbox.append(np.concatenate([boxes, scores[:, None]], 1)
                    .astype(np.float32))
        masks = []
        for b in boxes:
            m = np.zeros((h, w), np.uint8)
            x0, y0, x1, y1 = np.clip(b, 0, [w, h, w, h]).astype(int)
            m[y0:y1, x0:x1] = r.rand(max(y1 - y0, 0), max(x1 - x0, 0)) > 0.5
            masks.append(mask_utils.encode_mask(m))
        segm.append(masks)
        offsets += r.uniform(-15, 15, (5, 2)).tolist()
    result = (bbox, segm, np.asarray(offsets, np.float32))
    names = ("roof", "footprint")
    want = jax_show(img, result, class_names=names)
    out = str(tmp_path / "shown.png")
    got = show_result(img, result, class_names=names, out_file=out)
    assert np.array_equal(read_png(out), got)
    skip = np.zeros((h, w), bool)
    for x0, y0, x1, y1 in _label_boxes(result, names, 0.3):
        skip[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = True
    k = 0
    for dets in bbox:
        for det in dets:
            if det[4] >= 0.3:
                x1, y1, x2, y2 = det[:4].astype(int)
                cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
                ox, oy = result[2][k]
                strokes = _arrow_strokes((cx, cy), (int(cx - ox),
                                                    int(cy - oy)))
                if not all(0 <= x < w and 0 <= y < h
                           for s in strokes for x, y in s):
                    skip |= _near_strokes((h, w), strokes)
            k += 1
    assert (~skip).sum() > 0.6 * h * w
    assert np.array_equal(got[~skip], want[~skip])
    assert not np.array_equal(got, img)
    with pytest.raises(ValueError, match="PNG"):
        show_result(img, result, out_file=str(tmp_path / "shown.jpg"))


def test_browse_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    """Both tools on the synthetic tiles' train pipeline: the port's PNGs
    equal the JAX tool's outside 2 px of the offset arrows (their boxes and
    polygon outlines exact)."""
    from bonai_tpu_torch.datasets import build_dataset
    from bonai_tpu_torch.tools import browse_dataset
    data = synth_data(tmp_path / "synth", n=3, size=128)
    cfgs = {}
    for who in ("jax", "port"):
        cfg = synth_train_cfg(data)
        cfg.data.train.pipeline[0].cache_dir = str(tmp_path / f"cache_{who}")
        cfgs[who] = cfg
        cfg.dump(str(tmp_path / f"{who}.py"))
    capsys.readouterr()
    _run_jax_tool("browse_dataset", [str(tmp_path / "jax.py"),
                                     "--output-dir", str(tmp_path / "jax"),
                                     "--num", "3"], monkeypatch)
    browse_dataset.main([str(tmp_path / "port.py"), "--output-dir",
                         str(tmp_path / "port"), "--num", "3"])
    assert len(capsys.readouterr().out.splitlines()) == 6
    dataset = build_dataset(cfgs["port"].data.train)
    rng = np.random.RandomState(0)
    for i in range(3):
        res = dataset.prepare(i, rng)
        want = cv2.imread(str(tmp_path / "jax" / f"sample_{i}.png"))
        got = read_png(str(tmp_path / "port" / f"sample_{i}.png"))
        strokes = []
        for box, off in zip(res["gt_bboxes"], res["gt_offsets"]):
            x1, y1, x2, y2 = box.astype(int)
            cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
            strokes += _arrow_strokes((cx, cy), (int(cx - off[0]),
                                                 int(cy - off[1])))
        far = ~_near_strokes(got.shape, strokes)
        assert far.sum() > 0.5 * far.size
        assert np.array_equal(got[far], want[far])


# --- error analysis ---------------------------------------------------------

@pytest.fixture(scope="module")
def analysed(tmp_path_factory):
    """A pkl of the port's test CLI (the tiny LOFT-FOA with random weights
    on four synthetic tiles), both packages' BONAI datasets, and results
    planted near the GTs."""
    from bonai_tpu.datasets import build_dataset as jax_build_dataset
    from bonai_tpu_torch.apis import init_detector
    from bonai_tpu_torch.datasets import build_dataset, mask_utils
    from bonai_tpu_torch.engine import save_checkpoint
    from bonai_tpu_torch.tools import test as test_cli
    tmp = tmp_path_factory.mktemp("analysis")
    data = synth_data(tmp / "synth", n=4, size=128)
    ann = osp.join(data, "train", "train.json")
    prefix = osp.join(data, "train", "images") + "/"
    cfg = tiny_cfg(config=SYNTH_CONFIG)
    cfg.data.test.update(ann_file=ann, img_prefix=prefix)
    cfg.data.test.pipeline[1].img_scale = (128, 128)
    cfg.compute_dtype = "float32"
    cfg.test_cfg.rcnn.score_thr = 0.05
    cfg.dump(str(tmp / "tiny.py"))
    model = init_detector(cfg, device="cpu", dtype=torch.float32, seed=1)
    ckpt = save_checkpoint(str(tmp / "wd"), 0, model,
                           torch.optim.SGD(model.parameters(), lr=0.1))
    pkl = str(tmp / "r.pkl")
    test_cli.main([str(tmp / "tiny.py"), ckpt, "--out", pkl, "--device",
                   "cpu"])
    test = dict(type="BONAI", ann_file=ann, img_prefix=prefix,
                test_mode=True, pipeline=[dict(type="LoadImageFromFile"),
                                          dict(type="Collect", keys=["img"])])
    port_ds, jax_ds = build_dataset(dict(test)), jax_build_dataset(dict(test))
    r = np.random.RandomState(0)
    planted = []
    for i in range(len(port_ds)):
        gt = port_ds.get_ann_info(i)
        boxes = np.concatenate([gt["bboxes"] + r.normal(0, 3, gt["bboxes"]
                                                        .shape),
                                r.uniform(0, 100, (5, 4)) + [0, 0, 20, 20]])
        scores = r.uniform(0.05, 1, (len(boxes), 1))
        rles = []
        for b in boxes:
            m = np.zeros((128, 128), np.uint8)
            x0, y0, x1, y1 = np.clip(b, 0, 128).astype(int)
            m[y0:y1, x0:x1] = 1
            rles.append(mask_utils.encode_mask(m))
        planted.append(([np.concatenate([boxes, scores], 1)
                         .astype(np.float32)], [rles]))
    return dict(pkl=pkl, ann=ann, prefix=prefix, port=port_ds, jax=jax_ds,
                planted=planted, tmp=tmp)


@pytest.mark.parametrize("which", ["cli", "planted"])
def test_error_analysis_matches_jax(analysed, which, tmp_path):
    """The curves of every class and their mean, and ``maxF1score.txt``,
    equal the JAX tool's (whose text comes from its plotting function);
    the port's plots carry the JAX tool's names."""
    from bonai_tpu_torch.tools import coco_error_analysis_f1 as port_tool
    jax_tool = _jax_tool("coco_error_analysis_f1")
    if which == "cli":
        with open(analysed["pkl"], "rb") as f:
            results = pickle.load(f)
    else:
        results = analysed["planted"]
    metrics = ("bbox", "segm")
    jax_tool.analyze(results, analysed["jax"], str(tmp_path / "jax"),
                     metrics)
    port_tool.analyze(results, analysed["port"], str(tmp_path / "port"),
                      metrics, plots=False)
    for metric in metrics:
        with open(tmp_path / "jax" / metric / "maxF1score.txt") as f:
            want = f.read()
        with open(tmp_path / "port" / metric / "maxF1score.txt") as f:
            assert f.read() == want
        curves = np.load(tmp_path / "port" / metric / "curves.npz")
        rs, ps = jax_tool.compute_curves(analysed["jax"], results, 0, metric)
        assert np.array_equal(curves["rs"], rs)
        assert np.array_equal(curves["building"], ps)
        assert np.array_equal(curves["allclass"], np.mean([ps], axis=0))
    if which == "planted":
        assert "maxF1=0.0000" not in want.splitlines()[0]
        port_tool.analyze(results, analysed["port"], str(tmp_path / "plots"),
                          ("bbox",))
        assert sorted(os.listdir(tmp_path / "plots" / "bbox")) == sorted(
            os.listdir(tmp_path / "jax" / "bbox") + ["curves.npz"])


def test_error_analysis_clis(analysed, tmp_path, capsys, monkeypatch):
    """Both CLIs of the port on the test CLI's pkl: without plots they
    need no matplotlib; the precision-only one writes no F1 text; asking
    for plots without matplotlib raises naming it."""
    from bonai_tpu_torch.tools import coco_error_analysis_f1 as port_tool
    args = [analysed["pkl"], str(tmp_path / "f1"), "--ann", analysed["ann"],
            "--img-prefix", analysed["prefix"], "--types", "bbox", "segm",
            "--no-plots"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    port_tool.main(args)
    assert capsys.readouterr().out.startswith("wrote ")
    assert sorted(os.listdir(tmp_path / "f1" / "segm")) == [
        "curves.npz", "maxF1score.txt"]
    args[1] = str(tmp_path / "plain")
    port_tool.main(args, with_f1=False)
    assert os.listdir(tmp_path / "plain" / "bbox") == ["curves.npz"]
    with pytest.raises(RuntimeError, match="matplotlib"):
        port_tool.main(args[:-1])
