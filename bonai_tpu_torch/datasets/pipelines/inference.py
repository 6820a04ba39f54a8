"""The config's test pipeline for in-memory BGR images, in numpy
(counterpart of the ``MultiScaleFlipAug[Resize(keep_ratio), RandomFlip,
Normalize, Pad, ImageToTensor, Collect]`` steps of
``bonai_tpu/datasets/pipelines/transforms.py``, without cv2)."""

from __future__ import annotations

import numpy as np

from ...core.masks import resize_bilinear

_NO_OPS = ("LoadImageFromFile", "RandomFlip", "ImageToTensor", "Collect",
           "DefaultFormatBundle")


class InferencePipeline:
    """Keep-ratio resize to fit ``img_scale``, BGR->RGB normalisation and
    bottom/right zero padding to ``size_divisor``.  Test-time flips are
    ROADMAP.md item A5; the train pipeline that reads files is
    :mod:`.transforms`."""

    def __init__(self, pipeline_cfg):
        self.img_scale = None
        self.mean = self.std = None
        self.to_rgb = True
        self.size_divisor = None
        self._parse(pipeline_cfg)

    def _parse(self, cfgs):
        for t in cfgs:
            t = dict(t)
            kind = t.pop("type")
            if kind == "MultiScaleFlipAug":
                if t.get("flip") or isinstance(t["img_scale"][0],
                                               (list, tuple)):
                    raise NotImplementedError(
                        "test-time augmentation is ROADMAP.md item A5")
                self.img_scale = tuple(t["img_scale"])
                self._parse(t["transforms"])
            elif kind == "Resize":
                if not t.get("keep_ratio", True):
                    raise NotImplementedError("Resize(keep_ratio=False)")
                if t.get("img_scale"):
                    self.img_scale = tuple(t["img_scale"])
            elif kind == "Normalize":
                self.mean = np.asarray(t["mean"], np.float32)
                self.std = np.asarray(t["std"], np.float32)
                self.to_rgb = t.get("to_rgb", True)
            elif kind == "Pad":
                self.size_divisor = t["size_divisor"]
            elif kind not in _NO_OPS:
                raise NotImplementedError(
                    f"test pipeline step {kind} is not ported (ROADMAP.md A3d)")

    def __call__(self, img):
        """``(H, W, 3)`` uint8 BGR image -> dict with the normalised,
        padded float32 ``img`` and its ``img_shape``, ``ori_shape``,
        ``pad_shape`` and ``scale_factor`` (w, h, w, h)."""
        h, w = img.shape[:2]
        new_h, new_w = h, w
        if self.img_scale is not None:
            long_, short = max(self.img_scale), min(self.img_scale)
            scale = min(long_ / max(h, w), short / min(h, w))
            new_w, new_h = int(w * scale + 0.5), int(h * scale + 0.5)
        if (new_h, new_w) != (h, w):
            img = np.clip(np.rint(resize_bilinear(img, new_h, new_w)),
                          0, 255).astype(np.uint8)
        if self.to_rgb:
            img = img[..., ::-1]
        img = img.astype(np.float32)
        if self.mean is not None:
            img = (img - self.mean) / self.std
        ph, pw = new_h, new_w
        if self.size_divisor:
            d = self.size_divisor
            ph, pw = -(-new_h // d) * d, -(-new_w // d) * d
        out = np.zeros((ph, pw, 3), np.float32)
        out[:new_h, :new_w] = img
        sx, sy = new_w / w, new_h / h
        return {"img": out, "img_shape": (new_h, new_w), "ori_shape": (h, w),
                "pad_shape": (ph, pw),
                "scale_factor": np.array([sx, sy, sx, sy], np.float32)}
