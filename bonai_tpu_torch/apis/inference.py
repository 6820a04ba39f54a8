"""Inference API (counterpart of ``bonai_tpu/apis/inference.py``):
``init_detector`` builds a detector from a config with seeded random
weights or an mmdet checkpoint; ``inference_detector`` runs the test
pipeline and one batched ``simple_test`` on one image or a list of them.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit device, ``init_detector`` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..datasets.pipelines import build_pipeline
from ..models.builder import build_detector
from ..utils.weights import load_mmdet_checkpoint, mmdet_state_dict
from .test import results_to_host


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the GPU, and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bonai_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def init_detector(config, checkpoint=None, device=None, dtype=None, seed=0):
    """Build the detector of ``config`` (a path or a ``Config``).

    Weights are seeded random (``torch.Generator`` seeded with ``seed``)
    unless ``checkpoint`` names an mmdet ``.pth``.  ``dtype`` is the
    compute type, bfloat16 by default as in the JAX package.  Returns the
    model in eval mode, on ``device``, channels-last, with ``model.cfg``.
    """
    device = resolve_device(device)
    if isinstance(config, (str, os.PathLike)):
        config = Config.fromfile(config)
    model = build_detector(config.model, config.get("train_cfg"),
                           config.get("test_cfg"))
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint:
        model.load_state_dict(mmdet_state_dict(
            model, load_mmdet_checkpoint(checkpoint)))
    model.to(device=device, dtype=dtype or torch.bfloat16)
    model.to(memory_format=torch.channels_last).eval()
    model.cfg = config
    return model


def prepare_batch(model, imgs):
    """Run the config's test pipeline, without its ``LoadImageFromFile``,
    on ``(H, W, 3)`` uint8 BGR images and stack them (zero-padded to one
    size) for ``model.simple_test``.  Returns ``(img, img_shape,
    scale_factor, metas)``."""
    pipe = build_pipeline([t for t in model.cfg.data.test["pipeline"]
                           if t["type"] != "LoadImageFromFile"])
    outs = []
    for im in imgs:
        im = np.asarray(im)
        outs.append(pipe({"img": im, "img_shape": im.shape[:2],
                          "ori_shape": im.shape[:2], "scale_factor": 1.0}))
    h = max(o["img"].shape[0] for o in outs)
    w = max(o["img"].shape[1] for o in outs)
    batch = np.zeros((len(outs), h, w, 3), np.float32)
    for i, o in enumerate(outs):
        batch[i, :o["img"].shape[0], :o["img"].shape[1]] = o["img"]
    device = next(model.parameters()).device
    img_shape = torch.tensor([o["img_shape"] for o in outs],
                             dtype=torch.float32, device=device)
    scale = torch.tensor([o["scale_factor"][0] for o in outs],
                         dtype=torch.float32, device=device)
    metas = [{k: o[k] for k in ("ori_shape", "img_shape", "pad_shape",
                                "scale_factor")} for o in outs]
    return torch.from_numpy(batch).to(device), img_shape, scale, metas


def inference_detector(model, imgs, proposals=None):
    """Detect on one ``(H, W, 3)`` uint8 BGR image or a list of them (one
    batched ``simple_test``).  A Fast R-CNN takes ``proposals``: an ``(N,
    4|5)`` array an image in its pixels (a list of them for a list of
    images).  Returns the per-image result tuple(s) of
    :func:`results_to_host`."""
    single = isinstance(imgs, np.ndarray)
    img, img_shape, scale, metas = prepare_batch(
        model, [imgs] if single else imgs)
    if not model.takes_proposals:
        out = model.simple_test(img, img_shape, scale)
    else:
        if proposals is None:
            raise ValueError("a detector without an RPN needs proposals")
        props = [proposals] if single else proposals
        n = max(len(p) for p in props)
        boxes = torch.zeros((len(props), n, 4), dtype=torch.float32)
        valid = torch.zeros((len(props), n), dtype=torch.bool)
        for i, p in enumerate(props):
            p = torch.as_tensor(np.asarray(p, np.float32)[:, :4])
            boxes[i, :len(p)] = p * scale[i].cpu()
            valid[i, :len(p)] = True
        out = model.simple_test(img, img_shape, scale, boxes.to(img.device),
                                valid.to(img.device))
    results = results_to_host(out, metas)
    return results[0] if single else results
