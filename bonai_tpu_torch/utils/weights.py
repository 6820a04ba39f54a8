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

The detector may be LOFT, Faster, Mask or Dynamic R-CNN (the heads it has
of ``bbox_head``, ``mask_head`` and ``offset_head``), or Cascade R-CNN,
whose stage heads ``bbox_head_<i>`` go to mmdet's
``roi_head.bbox_head.<i>``; the JAX importer reads the single
``bbox_head`` only (ROADMAP.md queue C).  The backbone may be the ResNet
or HRNet (mmdet's HRNet keys, ``hrnet.py``), the neck FPN or HRFPN; the
JAX importer reads no HRNet or HRFPN variable.
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
    """Flax ``params``/``batch_stats`` of a JAX two-stage detector (numpy
    leaves) -> the port's ``state_dict`` (mmdet v2.3 keys, CPU float32
    tensors)."""
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

    def block(base, blk, stats):
        """A residual block's convs and norms (``ds_*``: its downsample)."""
        for sub, p in blk.items():
            if sub == "ds_conv":
                layer(f"{base}.downsample.0", p)
            elif sub == "ds_bn":
                norm(f"{base}.downsample.1", p, stats[sub])
            elif sub.startswith("bn"):
                norm(f"{base}.{sub}", p, stats[sub])
            else:
                layer(f"{base}.{sub}", p)

    bk, bs = params["backbone"], batch_stats["backbone"]
    for name, p in bk.items():
        stem = re.fullmatch(r"(conv|bn)(\d)", name)
        res = re.fullmatch(r"layer(\d+)_(\d+)", name)
        trans = re.fullmatch(r"t(\d)_(\d+)", name)
        hr = re.fullmatch(r"stage(\d)_module(\d+)", name)
        if stem and stem[1] == "conv":
            layer(f"backbone.{name}", p)
        elif stem:
            norm(f"backbone.{name}", p, bs[name])
        elif res:
            block(f"backbone.layer{res[1]}.{res[2]}", p, bs[name])
        elif trans:
            # HRNet's transition into stage s: a new branch (past the
            # previous stage's) is mmdet's Sequential of one conv-BN-ReLU
            s, b = int(trans[1]), int(trans[2])
            key = f"backbone.transition{s - 1}.{b}" + (
                ".0" if b >= _hr_branches(bk, s - 1) else "")
            layer(f"{key}.0", p)
            norm(f"{key}.1", bk[f"{name}_bn"], bs[f"{name}_bn"])
        elif hr:
            _hr_module(f"backbone.stage{hr[1]}.{hr[2]}", p, bs[name],
                       layer, norm, block)
    for name, p in params["neck"].items():
        if name == "reduction":                         # HRFPN
            layer("neck.reduction_conv.conv", p)
        elif name.startswith("fpn_conv") and name[8:].isdigit():
            layer(f"neck.fpn_convs.{name[8:]}.conv", p)
        else:                                           # FPN
            kind, i = name.rsplit("_", 1)
            layer(f"neck.{kind}_convs.{i}.conv", p)
    for name, p in params["rpn_head"].items():
        layer(f"rpn_head.{name}", p)

    for name, bh in params.items():
        m = re.fullmatch(r"bbox_head(?:_(\d+))?", name)
        if not m:
            continue
        key = "roi_head.bbox_head" + ("" if m[1] is None else f".{m[1]}")
        sd[f"{key}.shared_fcs.0.weight"] = _fc_to_chw(
            bh["shared_fc1"]["kernel"], roi_feat, roi_feat)
        sd[f"{key}.shared_fcs.0.bias"] = np.asarray(bh["shared_fc1"]["bias"])
        layer(f"{key}.shared_fcs.1", bh["shared_fc2"], _fc)
        layer(f"{key}.fc_cls", bh["fc_cls"], _fc)
        layer(f"{key}.fc_reg", bh["fc_reg"], _fc)

    for name, p in params.get("mask_head", {}).items():
        if name == "upsample":
            layer("roi_head.mask_head.upsample", p, _deconv)
        elif name == "conv_logits":
            layer("roi_head.mask_head.conv_logits", p)
        else:
            layer(f"roi_head.mask_head.convs.{name[len('conv'):]}.conv", p)

    for name, p in params.get("offset_head", {}).items():
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


def _hr_branches(bk, s):
    """The number of branches of HRNet stage ``s`` (1 for ``layer1``)."""
    if s == 1:
        return 1
    return sum(re.fullmatch(r"branch\d+_block0", k) is not None
               for k in bk[f"stage{s}_module0"])


def _hr_module(base, mod, stats, layer, norm, block):
    """An HRNet module's variables: ``branch<b>_block<i>`` ->
    ``branches.<b>.<i>``; ``fuse<i>_<j>_conv|bn`` (from a coarser branch)
    -> ``fuse_layers.<i>.<j>.0|1``; ``fuse<i>_<j>_down<k>[_bn]`` (from a
    finer one) -> ``fuse_layers.<i>.<j>.<k>.0|1``."""
    for name, p in mod.items():
        br = re.fullmatch(r"branch(\d+)_block(\d+)", name)
        fuse = re.fullmatch(r"fuse(\d+)_(\d+)_(conv|bn|down(\d+)(_bn)?)",
                            name)
        if br:
            block(f"{base}.branches.{br[1]}.{br[2]}", p, stats[name])
            continue
        key = f"{base}.fuse_layers.{fuse[1]}.{fuse[2]}"
        if fuse[4] is not None:
            key += f".{fuse[4]}"
        if fuse[3] == "bn" or fuse[5]:
            norm(f"{key}.1", p, stats[name])
        else:
            layer(f"{key}.0", p)


def load_mmdet_checkpoint(path):
    """The ``state_dict`` of an mmdet ``.pth`` checkpoint, as it is: its
    keys are the port's (a cascade's stage heads under
    ``roi_head.bbox_head.<i>``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)
