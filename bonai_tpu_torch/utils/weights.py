"""Weights carried across: the JAX package's flax variables to the port's
mmdet-keyed ``state_dict``, and mmdet ``.pth`` checkpoints.

``state_dict_from_jax`` is the exact inverse of
``bonai_tpu.utils.torch_import.mmdet_checkpoint_to_params``: HWIO convs
back to OIHW, ``(in, out)`` Dense kernels back to ``(out, in)``, the
flipped transposed-conv kernel back, and the first FC after RoI features
(``shared_fc1``, offset ``fc0``) from the (H, W, C) flatten back to
torch's (C, H, W).  The plain ``OffsetHead``'s convs (``conv<i>``) go to
mmdet's ``roi_head.offset_head.convs.<i>``, which the JAX importer does
not read back (ROADMAP.md queue C).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _conv(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))       # HWIO -> OIHW


def _deconv(w):
    # flax (kh, kw, in, out), spatially flipped -> torch (in, out, kh, kw)
    return np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1))


def _fc(w):
    return np.transpose(np.asarray(w), (1, 0))               # (in,out)->(out,in)


def _fc_to_chw(w, h, ww):
    """First FC on flattened RoI features: input axis from (H, W, C) to
    torch's (C, H, W)."""
    w = np.asarray(w)                                        # (H*W*C, out)
    c = w.shape[0] // (h * ww)
    w = w.T.reshape(w.shape[1], h, ww, c).transpose(0, 3, 1, 2)
    return w.reshape(w.shape[0], -1)


def state_dict_from_jax(params, batch_stats, roi_feat=7):
    """Flax ``params``/``batch_stats`` of the JAX LOFT (numpy leaves) ->
    the port's ``state_dict`` (mmdet v2.3 keys, CPU float32 tensors)."""
    sd = {}

    def layer(key, p, weight=_conv):
        sd[f"{key}.weight"] = weight(p["kernel"])
        if "bias" in p:
            sd[f"{key}.bias"] = np.asarray(p["bias"])

    def norm(key, p, s):
        sd[f"{key}.weight"] = np.asarray(p["scale"])
        sd[f"{key}.bias"] = np.asarray(p["bias"])
        sd[f"{key}.running_mean"] = np.asarray(s["mean"])
        sd[f"{key}.running_var"] = np.asarray(s["var"])

    bk, bs = params["backbone"], batch_stats["backbone"]
    layer("backbone.conv1", bk["conv1"])
    norm("backbone.bn1", bk["bn1"], bs["bn1"])
    for name, blk in bk.items():
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if not m:
            continue
        base = f"backbone.layer{m[1]}.{m[2]}"
        for sub, p in blk.items():
            if sub == "ds_conv":
                layer(f"{base}.downsample.0", p)
            elif sub == "ds_bn":
                norm(f"{base}.downsample.1", p, bs[name][sub])
            elif sub.startswith("bn"):
                norm(f"{base}.{sub}", p, bs[name][sub])
            else:
                layer(f"{base}.{sub}", p)
    for name, p in params["neck"].items():
        kind, i = name.rsplit("_", 1)
        layer(f"neck.{kind}_convs.{i}.conv", p)
    for name, p in params["rpn_head"].items():
        layer(f"rpn_head.{name}", p)

    bh = params["bbox_head"]
    sd["roi_head.bbox_head.shared_fcs.0.weight"] = _fc_to_chw(
        bh["shared_fc1"]["kernel"], roi_feat, roi_feat)
    sd["roi_head.bbox_head.shared_fcs.0.bias"] = np.asarray(
        bh["shared_fc1"]["bias"])
    layer("roi_head.bbox_head.shared_fcs.1", bh["shared_fc2"], _fc)
    layer("roi_head.bbox_head.fc_cls", bh["fc_cls"], _fc)
    layer("roi_head.bbox_head.fc_reg", bh["fc_reg"], _fc)

    for name, p in params["mask_head"].items():
        if name == "upsample":
            layer("roi_head.mask_head.upsample", p, _deconv)
        elif name == "conv_logits":
            layer("roi_head.mask_head.conv_logits", p)
        else:
            layer(f"roi_head.mask_head.convs.{name[len('conv'):]}.conv", p)

    for name, p in params["offset_head"].items():
        m = re.fullmatch(r"branch(\d+)_conv(\d+)", name)
        plain = re.fullmatch(r"conv(\d+)", name)
        if m:
            layer(f"roi_head.offset_head.expand_convs.{m[1]}.{m[2]}", p)
        elif plain:
            layer(f"roi_head.offset_head.convs.{plain[1]}", p)
        elif name == "fc0":
            sd["roi_head.offset_head.fcs.0.weight"] = _fc_to_chw(
                p["kernel"], roi_feat, roi_feat)
            sd["roi_head.offset_head.fcs.0.bias"] = np.asarray(p["bias"])
        elif name == "fc_offset":
            layer("roi_head.offset_head.fc_offset", p, _fc)
        else:
            layer(f"roi_head.offset_head.fcs.{name[len('fc'):]}", p, _fc)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def load_mmdet_checkpoint(path):
    """The ``state_dict`` of an mmdet ``.pth`` checkpoint, as it is."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)
