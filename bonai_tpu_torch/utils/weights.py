"""Weights carried across: the JAX package's flax variables to the port's
mmdet-keyed ``state_dict``, and mmdet ``.pth`` checkpoints.

``state_dict_from_jax`` is the exact inverse of
``bonai_tpu.utils.torch_import.mmdet_checkpoint_to_params``: HWIO convs
back to OIHW, ``(in, out)`` Dense kernels back to ``(out, in)``, the
flipped transposed-conv kernel back, and the first FC after RoI features
(``shared_fc1``, offset ``fc0``) from the (H, W, C) flatten back to
torch's (C, H, W).  The plain ``OffsetHead``'s convs (``conv<i>``) go to
mmdet's ``roi_head.offset_head.convs.<i>``, which the JAX importer does
not read back (ROADMAP.md queue C); the FOA head's own FCs of each branch
(flax ``branch<e>_fc<i>``, ``branch<e>_fc_offset``, unshared FCs) to
``roi_head.offset_head.expand_fcs.<e>.<i>`` and
``expand_fc_offsets.<e>``.  LOFT's attribute heads (flax ``height_head``,
``offset_height_head`` with their ``trunk``, ``angle_head``,
``side_face_head``, ``offset_field_head``) go to ``roi_head.<head>.
{convs.<i>,fcs.<i>,fc_height,fc_offset,fc_angle,upsample,conv_logits,
conv_field}``: the reference removed those modules, so no mmdet key
exists, and the JAX importer reads none of these (ROADMAP.md queue C).

The detector may be LOFT, Faster, Mask or Dynamic R-CNN (the heads it has
of ``bbox_head``, ``mask_head`` and ``offset_head``), or Cascade R-CNN,
whose stage heads ``bbox_head_<i>`` go to mmdet's
``roi_head.bbox_head.<i>``; the JAX importer reads the single
``bbox_head`` only (ROADMAP.md queue C).  The backbone may be the ResNet
or HRNet (mmdet's HRNet keys, ``hrnet.py``), the neck FPN or HRFPN; the
JAX importer reads no HRNet or HRFPN variable.

Libra R-CNN's chained neck goes to ``neck.0.*`` (the FPN) and
``neck.1.refine.*`` (the BFP's ``neck_extra0``), Double-Head's box head to
``roi_head.bbox_head.{res_block,conv_branch,fc_branch,fc_cls,fc_reg}``,
Mask Scoring's IoU head to ``roi_head.mask_iou_head.{convs.<i>.conv,
fcs.<i>,fc_mask_iou}``; an RPN-only model has no ``roi_head.*``, a Fast
R-CNN no ``rpn_head.*``.  The JAX importer reads none of the BFP, the
double head or the IoU head (ROADMAP.md queue C).

The dense single-stage detectors (RetinaNet, FreeAnchor, ATSS, GFL,
FCOS, FSAF, FoveaBox, RepPoints) have a ``bbox_head`` of mmdet's
dense-head keys (``cls_convs.<i>.{conv,gn}``, ``reg_convs.<i>``,
``retina_{cls,reg}`` (FSAF's too), ``atss_{cls,reg,centerness}``,
``gfl_{cls,reg}``, ``fcos_{cls,reg,centerness}``, FoveaBox's
``conv_{cls,reg}``, RepPoints' ``reppoints_cls_{conv,out}``,
``reppoints_pts_{init,refine}_{conv,out}`` and ``moment_transfer``,
``scales.<l>.scale``) and no ``rpn_head``/``roi_head``; Guided
Anchoring's RPN has ``rpn_head.{rpn_conv,conv_loc,conv_shape,conv_cls,
conv_reg}`` and ``rpn_head.feature_adaption.{conv_offset,
conv_adaption}``; an FPN's extra
convs (flax ``extra_<i>``) are mmdet's ``neck.fpn_convs.<n>`` after its
output convs.  The JAX importer reads ``rpn_head.*`` unconditionally and
raises ``KeyError`` on such a checkpoint (ROADMAP.md queue C).  The GN
towers' convs keep the bias they have in the JAX package, which mmdet's
convs before a norm lack: :func:`mmdet_state_dict` gives them a zero one.

The trunk variants: a deformable ``conv2`` keeps mmcv's
``layer<s>.<b>.conv2.weight`` and adds ``conv2.conv_offset.{weight,
bias}``; Res2Net's deep stem (flax ``stem_conv<i>``/``stem_bn<i>``) goes
to ``backbone.stem.{0,1,3,4,6,7}``, its split convs ``conv2_<i>``/
``bn2_<i>`` to ``convs.<i>``/``bns.<i>`` and its shortcut to mmdet's
``Res2Layer`` keys ``downsample.1``/``.2``; RegNet's keys are ResNet's; a
plugin (flax ``after_conv<k>_plugin<i>``) goes under mmcv's name,
``context_block``, ``gen_attention_block`` or ``nonlocal_block`` (see
:func:`_plugin`); PAFPN's ``downsample_<i>``/``pafpn_<i>`` to
``neck.downsample_convs.<i>.conv``/``neck.pafpn_convs.<i>.conv``.  The
JAX importer raises ``KeyError`` on a Res2Net checkpoint, reads a RegNet
one whole, and leaves DCN's ``conv_offset``, the plugins and PAFPN's
bottom-up convs at their initial values (ROADMAP.md queue C).

Grid R-CNN's box head has no ``fc_reg`` and its grid head goes to
``roi_head.grid_head.{convs.<i>.{conv,gn},forder_trans.<i>.<j>.{0,1},
sorder_trans.<i>.<j>.{0,1},deconv1,norm1,deconv2}``, the per-point JAX
deconvs concatenated into the grouped ones; PointRend's coarse head to
``roi_head.mask_head.{convs.<i>.conv,downsample_conv.conv,fcs.<i>,
fc_logits}`` and its point head to ``roi_head.point_head.{fcs.<i>.conv,
fc_logits}`` (``Conv1d`` weights ``(out, in, 1)``).  The JAX importer
raises ``KeyError`` on both detectors (ROADMAP.md queue C).

HTC's stage mask heads ``mask_head_<i>`` go to ``roi_head.mask_head.<i>.
{convs.<j>.conv,conv_res.conv,upsample,conv_logits}`` and its semantic
head to ``roi_head.semantic_head.{lateral_convs.<i>.conv,convs.<j>.conv,
conv_embedding.conv,conv_logits}``.  DetectoRS's SAC ``conv2`` keeps
mmcv's ``weight`` and adds ``weight_gamma``/``weight_beta`` ``(out, 1, 1,
1)``, ``weight_diff``, ``switch``, ``pre_context`` and ``post_context``;
its RFP's FPN (flax ``neck/fpn``) goes to ``neck.{lateral,fpn}_convs``,
the backbone copy ``rfp_backbone<s>`` to ``neck.rfp_modules.<s - 1>``
(with ``layer<k>.0.rfp_conv``), the ASPP to ``neck.rfp_aspp.aspp.<i>``
and the gate to ``neck.rfp_weight``.  The JAX importer reads none of
these (ROADMAP.md queue C).

NAS-FPN's neck (flax ``lateral<i>``, ``extra<i>``, ``s<s>_<cell>``) goes
to ``neck.lateral_convs.<k>``, ``neck.extra_downsamples.<i>.0`` and
``neck.fpn_stages.<s>.<cell>.out_conv``, NAS-FCOS's (``adapt<i>``, its
concat cells, ``extra<i>``) to ``neck.adapt_convs.<k>.{conv,bn}``,
``neck.fpn.<cell>.{input1_conv,input2_conv,out_conv}`` and
``neck.extra_downsamples.<i>.{norm,conv}`` (:func:`_nas_neck`), its head's
searched towers to ``bbox_head.cls|reg_convs.<i>.{conv,gn}``; SSD's VGG
to mmcv's ``backbone.features.<n>``, ``extra.<j>`` and ``l2_norm``
(:func:`_vgg_var`) and its head to ``bbox_head.cls|reg_convs.<i>``;
CornerNet's hourglass to ``backbone.{stem,hourglass_modules,out_convs,
conv1x1s,remap_convs,inters}`` (:func:`_hourglass_var`) and its head to
``bbox_head.tl|br_pool.<l>`` and ``bbox_head.tl|br_heat|off|emb.<l>``
(:func:`_corner_head`).  The JAX importer reads ``rpn_head.*``
unconditionally and raises ``KeyError`` on all four (ROADMAP.md queue C).
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


def _conv1d(w):
    return _fc(w)[..., None]                                 # -> (out, in, 1)


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
        """A residual block's convs and norms (``ds_*``: its downsample;
        a Res2Net block's ``conv2_<i>``/``bn2_<i>`` and pooled shortcut,
        ``downsample.1``/``.2``), a deformable ``conv2``'s
        ``conv_offset`` and the block's plugins."""
        res2 = "conv2_0" in blk
        ds = (1, 2) if res2 else (0, 1)
        for sub, p in blk.items():
            split = re.fullmatch(r"(conv|bn)2_(\d+)", sub)
            if sub == "ds_conv":
                layer(f"{base}.downsample.{ds[0]}", p)
            elif sub == "ds_bn":
                norm(f"{base}.downsample.{ds[1]}", p, stats[sub])
            elif split:
                key = f"{base}.{split[1]}s.{split[2]}"
                if split[1] == "bn":
                    norm(key, p, stats[sub])
                else:
                    layer(key, p)
            elif re.fullmatch(r"after_conv\d_plugin\d+", sub):
                _plugin(base, blk, sub, sd, layer)
            elif sub.startswith("bn"):
                norm(f"{base}.{sub}", p, stats[sub])
            else:
                layer(f"{base}.{sub}", p)
                if "conv_offset" in p:                  # DCN's conv2
                    layer(f"{base}.{sub}.conv_offset", p["conv_offset"])
                if "weight_diff" in p:                  # SAC's conv2
                    _sac(f"{base}.{sub}", p, sd, layer)

    def backbone(prefix, bk, bs):
        for name, p in bk.items():
            _backbone_var(prefix, name, p, bk, bs, layer, norm, block)

    backbone("backbone", params["backbone"], batch_stats.get("backbone", {}))
    # a chained neck shows by its BFP's variables (one without a refine
    # has none, and reads as a plain FPN)
    chained = "neck_extra0" in params
    neck = "neck.0" if chained else "neck"
    nk = params.get("neck", {})
    if "fpn" in nk:                                     # DetectoRS's RFP
        for name, p in nk.items():
            step = re.fullmatch(r"rfp_backbone(\d+)", name)
            if step:
                backbone(f"neck.rfp_modules.{int(step[1]) - 1}", p,
                         batch_stats["neck"][name])
            elif name == "rfp_aspp":
                for sub, q in p.items():
                    layer(f"neck.rfp_aspp.aspp.{sub[len('aspp'):]}", q)
            elif name == "rfp_weight":
                layer("neck.rfp_weight", p)
        nk = nk["fpn"]
    used = sum(name.startswith("lateral_") for name in nk)
    if any(re.fullmatch(r"(lateral|adapt)\d+", name) for name in nk):
        _nas_neck(nk, sd, layer)
        nk = {}
    for name, p in nk.items():
        if name == "reduction":                         # HRFPN
            layer(f"{neck}.reduction_conv.conv", p)
        elif name.startswith("fpn_conv") and name[8:].isdigit():
            layer(f"{neck}.fpn_convs.{name[8:]}.conv", p)
        elif name.startswith("extra_"):                 # FPN's extra convs
            layer(f"{neck}.fpn_convs.{used + int(name[6:])}.conv", p)
        else:                                           # FPN
            kind, i = name.rsplit("_", 1)
            layer(f"{neck}.{kind}_convs.{i}.conv", p)
    j = 0
    while f"neck_extra{j}" in params:                   # Libra's BFP
        refine = params[f"neck_extra{j}"]["refine"]
        j += 1
        if "kernel" in refine:                          # refine_type conv
            layer(f"neck.{j}.refine.conv", refine)
        else:                                           # non_local
            for sub, p in refine.items():
                layer(f"neck.{j}.refine.{sub}.conv", p)
    for name, p in params.get("rpn_head", {}).items():
        if name == "adaption_kernel":                   # GA-RPN's DCN
            sd["rpn_head.feature_adaption.conv_adaption.weight"] = _conv(p)
        elif name == "conv_offset":
            layer("rpn_head.feature_adaption.conv_offset", p)
        else:
            layer(f"rpn_head.{name}", p)

    for name, bh in params.items():
        m = re.fullmatch(r"bbox_head(?:_(\d+))?", name)
        if not m:
            continue
        if name == "bbox_head" and DENSE_OUTPUTS.keys() & bh.keys():
            _dense_head(bh, sd, layer)
            continue
        if name == "bbox_head" and "cls_conv0" in bh:    # SSD's
            for sub, p in bh.items():
                kind, i = re.fullmatch(r"(cls|reg)_conv(\d+)", sub).groups()
                layer(f"bbox_head.{kind}_convs.{i}", p)
            continue
        if name == "bbox_head" and "tl_pool0" in bh:     # CornerNet's
            _corner_head(bh, sd, layer)
            continue
        key = "roi_head.bbox_head" + ("" if m[1] is None else f".{m[1]}")
        if "fc_branch_0" in bh:                         # Double-Head
            _double_head(key, bh, batch_stats[name], roi_feat, sd, layer,
                         norm, block)
            continue
        sd[f"{key}.shared_fcs.0.weight"] = _fc_to_chw(
            bh["shared_fc1"]["kernel"], roi_feat, roi_feat)
        sd[f"{key}.shared_fcs.0.bias"] = np.asarray(bh["shared_fc1"]["bias"])
        layer(f"{key}.shared_fcs.1", bh["shared_fc2"], _fc)
        layer(f"{key}.fc_cls", bh["fc_cls"], _fc)
        if "fc_reg" in bh:                              # not Grid R-CNN's
            layer(f"{key}.fc_reg", bh["fc_reg"], _fc)
    if "grid_head" in params:
        _grid_head("roi_head.grid_head", params["grid_head"], sd, layer)
    for name, p in params.get("point_head", {}).items():
        layer(f"roi_head.point_head."
              f"{'fc_logits' if name == 'fc_logits' else f'fcs.{name[2:]}.conv'}",
              p, _conv1d)

    for name, p in params.get("mask_iou_head", {}).items():
        key = "roi_head.mask_iou_head"
        if name == "fc0":               # on the convs' (S, S, C) output
            c = np.shape(params["mask_iou_head"]["conv0"]["kernel"])[-1]
            side = int(round((np.shape(p["kernel"])[0] / c) ** 0.5))
            sd[f"{key}.fcs.0.weight"] = _fc_to_chw(p["kernel"], side, side)
            sd[f"{key}.fcs.0.bias"] = np.asarray(p["bias"])
        elif name.startswith("fc"):
            layer(f"{key}.{'fcs.' + name[2:] if name[2:].isdigit() else name}",
                  p, _fc)
        else:
            layer(f"{key}.convs.{name[len('conv'):]}.conv", p)

    for head, mask_head in params.items():
        m = re.fullmatch(r"mask_head(?:_(\d+))?", head)   # HTC's stages
        if not m:
            continue
        key = "roi_head.mask_head" + ("" if m[1] is None else f".{m[1]}")
        for name, p in mask_head.items():
            if "fc_logits" in mask_head:                # PointRend's coarse
                _coarse_head(key, mask_head, name, p, sd, layer)
            elif name == "upsample":
                layer(f"{key}.upsample", p, _deconv)
            elif name == "conv_logits":
                layer(f"{key}.conv_logits", p)
            elif name == "conv_res":
                layer(f"{key}.conv_res.conv", p)
            else:
                layer(f"{key}.convs.{name[len('conv'):]}.conv", p)
    for name, p in params.get("semantic_head", {}).items():
        key = "roi_head.semantic_head"
        if name == "conv_logits":
            layer(f"{key}.conv_logits", p)
        elif name.startswith("lateral"):
            layer(f"{key}.lateral_convs.{name[len('lateral'):]}.conv", p)
        elif name == "conv_embedding":
            layer(f"{key}.conv_embedding.conv", p)
        else:
            layer(f"{key}.convs.{name[len('conv'):]}.conv", p)

    for name, p in params.get("offset_head", {}).items():
        m = re.fullmatch(r"branch(\d+)_(conv|fc)(\d+|_offset)", name)
        if m and m[2] == "conv":
            layer(f"roi_head.offset_head.expand_convs.{m[1]}.{m[3]}", p)
        elif m and m[3] == "_offset":   # a branch's own FCs
            layer(f"roi_head.offset_head.expand_fc_offsets.{m[1]}", p, _fc)
        elif m:
            _roi_fc(f"roi_head.offset_head.expand_fcs.{m[1]}", m[3], p,
                    roi_feat, sd, layer)
        else:
            _roi_fc_or_conv("roi_head.offset_head", name, p, roi_feat, sd,
                            layer)
    for head in ("height_head", "offset_height_head"):
        for name, p in params.get(head, {}).get("trunk", {}).items():
            _roi_fc_or_conv(f"roi_head.{head}", name, p, roi_feat, sd,
                            layer)
        for name, p in params.get(head, {}).items():
            if name != "trunk":
                layer(f"roi_head.{head}.{name}", p, _fc)
    for head in ("angle_head", "side_face_head", "offset_field_head"):
        for name, p in params.get(head, {}).items():
            if re.fullmatch(r"conv\d+", name):
                layer(f"roi_head.{head}.convs.{name[len('conv'):]}", p)
            else:
                layer(f"roi_head.{head}.{name}", p,
                      {"upsample": _deconv, "fc_angle": _fc}.get(name,
                                                                 _conv))
    # np.array, not np.ascontiguousarray: the latter makes the scales'
    # 0-d arrays 1-d
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def _roi_fc_or_conv(key, name, p, roi_feat, sd, layer):
    """A RoI regressor's ``conv<i>`` (to ``<key>.convs.<i>``), ``fc<i>``
    (``<key>.fcs.<i>``, the first from the (H, W, C) flatten) or output FC
    (``<key>.<name>``)."""
    if re.fullmatch(r"conv\d+", name):
        layer(f"{key}.convs.{name[len('conv'):]}", p)
    elif re.fullmatch(r"fc\d+", name):
        _roi_fc(f"{key}.fcs", name[len("fc"):], p, roi_feat, sd, layer)
    else:
        layer(f"{key}.{name}", p, _fc)


def _roi_fc(base, index, p, roi_feat, sd, layer):
    """FC ``index`` of a RoI regressor's ``base``; FC 0 reads the (H, W,
    C) flatten of the RoI features."""
    if index == "0":
        sd[f"{base}.0.weight"] = _fc_to_chw(p["kernel"], roi_feat, roi_feat)
        sd[f"{base}.0.bias"] = np.asarray(p["bias"])
    else:
        layer(f"{base}.{index}", p, _fc)


def _backbone_var(prefix, name, p, bk, bs, layer, norm, block):
    """One top-level variable ``name`` of a JAX backbone tree ``bk`` under
    the port's module ``prefix``: a ResNet's stem and blocks, Res2Net's
    deep stem, HRNet's transitions and modules, SSD's VGG
    (:func:`_vgg_var`) and the hourglass (:func:`_hourglass_var`)."""
    if "l2_norm_scale_p" in bk:
        _vgg_var(prefix, name, p, bk, layer)
        return
    if "stem0_conv" in bk:
        _hourglass_var(prefix, name, p, bs, layer, norm, block)
        return
    stem = re.fullmatch(r"(conv|bn)(\d)", name)
    deep = re.fullmatch(r"stem_(conv|bn)(\d)", name)     # Res2Net's stem
    res = re.fullmatch(r"layer(\d+)_(\d+)", name)
    trans = re.fullmatch(r"t(\d)_(\d+)", name)
    hr = re.fullmatch(r"stage(\d)_module(\d+)", name)
    if stem and stem[1] == "conv":
        layer(f"{prefix}.{name}", p)
    elif stem:
        norm(f"{prefix}.{name}", p, bs[name])
    elif deep:
        key = f"{prefix}.stem.{3 * int(deep[2]) + (deep[1] == 'bn')}"
        if deep[1] == "conv":
            layer(key, p)
        else:
            norm(key, p, bs[name])
    elif res:
        block(f"{prefix}.layer{res[1]}.{res[2]}", p, bs[name])
    elif trans:
        # HRNet's transition into stage s: a new branch (past the previous
        # stage's) is mmdet's Sequential of one conv-BN-ReLU
        s, b = int(trans[1]), int(trans[2])
        key = f"{prefix}.transition{s - 1}.{b}" + (
            ".0" if b >= _hr_branches(bk, s - 1) else "")
        layer(f"{key}.0", p)
        norm(f"{key}.1", bk[f"{name}_bn"], bs[f"{name}_bn"])
    elif hr:
        _hr_module(f"{prefix}.stage{hr[1]}.{hr[2]}", p, bs[name], layer,
                   norm, block)


def _vgg_var(prefix, name, p, bk, layer):
    """SSD's VGG: ``conv<s>_<c>``, ``fc6`` and ``fc7`` -> mmcv's
    ``features.<n>`` (its ReLUs and pools counted, as
    ``ssd_vgg.py::feature_indices`` counts them for the stage sizes the
    tree has), ``extra<j>`` -> ``extra.<j>``, ``l2_norm_scale_p`` ->
    ``l2_norm.weight``."""
    counts = [sum(re.fullmatch(rf"conv{s}_\d+", k) is not None for k in bk)
              for s in range(1, 6)]
    index, n = {}, 0
    for s, convs in enumerate(counts):
        for c in range(convs):
            index[f"conv{s + 1}_{c + 1}"] = n
            n += 2
        n += 1 if s < 4 else 0
    index.update(fc6=n + 1, fc7=n + 3)
    if name == "l2_norm_scale_p":
        layer(f"{prefix}.l2_norm", {"kernel": p}, np.asarray)
    elif name.startswith("extra"):
        layer(f"{prefix}.extra.{name[len('extra'):]}", p)
    else:
        layer(f"{prefix}.features.{index[name]}", p)


def _hourglass_var(prefix, name, p, bs, layer, norm, block):
    """The hourglass: ``stem0_conv|bn`` -> ``stem.0.conv|bn``, ``stem1_b0``
    -> ``stem.1.0``, ``hg<i>`` -> ``hourglass_modules.<i>``
    (:func:`_hourglass_module`), ``out<i>_``, ``inter1x1_<i>_`` and
    ``remap<i>_conv|bn`` -> ``out_convs``, ``conv1x1s`` and
    ``remap_convs.<i>.conv|bn``, ``inter<i>_b0`` -> ``inters.<i>``."""
    conv_bn = re.fullmatch(r"(stem|out|inter1x1_|remap)(\d+)_(conv|bn)",
                           name)
    if conv_bn:
        key = {"stem": "stem", "out": "out_convs", "inter1x1_": "conv1x1s",
               "remap": "remap_convs"}[conv_bn[1]]
        key = f"{prefix}.{key}.{conv_bn[2]}.{conv_bn[3]}"
        if conv_bn[3] == "bn":
            norm(key, p, bs[name])
        else:
            layer(key, p)
    elif name == "stem1_b0":
        block(f"{prefix}.stem.1.0", p, bs[name])
    elif name.startswith("hg"):
        _hourglass_module(f"{prefix}.hourglass_modules.{name[2:]}", p,
                          bs[name], block)
    else:
        inter = re.fullmatch(r"inter(\d+)_b0", name)
        block(f"{prefix}.inters.{inter[1]}", p, bs[name])


def _hourglass_module(key, mod, stats, block):
    """An hourglass module: ``up1|low1|low2|low3_b<j>`` -> ``<part>.<j>``,
    a nested ``low2`` module -> ``low2``."""
    for name, p in mod.items():
        if name == "low2":
            _hourglass_module(f"{key}.low2", p, stats[name], block)
        else:
            part, j = re.fullmatch(r"(up1|low[123])_b(\d+)", name).groups()
            block(f"{key}.{part}.{j}", p, stats[name])


def _nas_neck(nk, sd, layer):
    """NAS-FPN's neck: ``lateral<i>`` (numbered from ``start_level``) ->
    ``neck.lateral_convs.<k>.conv``, ``extra<i>`` ->
    ``neck.extra_downsamples.<i>.0.conv``, ``s<s>_<cell>/out_conv`` ->
    ``neck.fpn_stages.<s>.<cell>.out_conv.conv``; NAS-FCOS's:
    ``adapt<i>``/``adapt_bn<i>`` -> ``neck.adapt_convs.<k>.conv|bn``,
    ``<cell>/in1_conv|in2_conv`` -> ``neck.fpn.<cell>.input1_conv|
    input2_conv.conv``, ``<cell>/out_norm|out_conv`` ->
    ``neck.fpn.<cell>.out_conv.bn|conv``, ``extra<i>``/``extra_bn<i>`` ->
    ``neck.extra_downsamples.<i>.conv|norm``."""
    def gn(key, q):
        sd[f"{key}.weight"] = np.asarray(q["scale"])
        sd[f"{key}.bias"] = np.asarray(q["bias"])

    firsts = sorted(int(n[len("lateral"):]) for n in nk
                    if re.fullmatch(r"lateral\d+", n)) or sorted(
        int(n[len("adapt"):]) for n in nk if re.fullmatch(r"adapt\d+", n))
    nasfcos = any(n.startswith("adapt") for n in nk)
    for name, p in nk.items():
        m = re.fullmatch(r"(lateral|adapt|adapt_bn|extra|extra_bn)(\d+)",
                         name)
        stage = re.fullmatch(r"s(\d+)_(\w+)", name)
        if m and m[1] in ("lateral", "adapt", "adapt_bn"):
            k = int(m[2]) - firsts[0]
            if m[1] == "lateral":
                layer(f"neck.lateral_convs.{k}.conv", p)
            elif m[1] == "adapt":
                layer(f"neck.adapt_convs.{k}.conv", p)
            else:
                gn(f"neck.adapt_convs.{k}.bn", p)
        elif m and m[1] == "extra_bn":
            gn(f"neck.extra_downsamples.{m[2]}.norm", p)
        elif m:
            layer(f"neck.extra_downsamples.{m[2]}." +
                  ("conv" if nasfcos else "0.conv"), p)
        elif stage:
            layer(f"neck.fpn_stages.{stage[1]}.{stage[2]}.out_conv.conv",
                  p["out_conv"])
        else:                                   # a NAS-FCOS cell
            for sub, q in p.items():
                if sub == "out_norm":
                    gn(f"neck.fpn.{name}.out_conv.bn", q)
                elif sub == "out_conv":
                    layer(f"neck.fpn.{name}.out_conv.conv", q)
                else:
                    layer(f"neck.fpn.{name}.input{sub[2]}_conv.conv", q)


def _sac(key, p, sd, layer):
    """The rest of a JAX ``SAConv2d`` (its ``kernel`` is ``weight``):
    ``weight_diff`` as a conv weight, ``weight_gamma``/``weight_beta``
    ``(1, 1, 1, out)`` -> mmcv's ``(out, 1, 1, 1)``, the ``switch``,
    ``pre_context`` and ``post_context`` convs."""
    sd[f"{key}.weight_diff"] = _conv(p["weight_diff"])
    for k in ("weight_gamma", "weight_beta"):
        sd[f"{key}.{k}"] = np.asarray(p[k]).reshape(-1, 1, 1, 1)
    for k in ("switch", "pre_context", "post_context"):
        layer(f"{key}.{k}", p[k])


# a JAX plugin's variables -> mmcv's plugin name (``_abbr_``): the
# attention block by its value conv, the non-local block by its theta
def _plugin_abbr(p):
    if "value_conv" in p:
        return "gen_attention_block"
    return "nonlocal_block" if "theta" in p else "context_block"


def _plugin(base, blk, name, sd, layer):
    """A ResNet plugin of a JAX block (``after_conv<k>_plugin<i>``) under
    mmcv's name: a ``ContextBlock``'s ``conv_mask`` and
    ``channel_{add,mul}_conv{1,2}``/``_ln`` -> ``context_block.conv_mask``
    and ``channel_{add,mul}_conv.{0,3,1}`` (LayerNorm weights ``(planes,
    1, 1)``); a ``GeneralizedAttention``'s convs as they are,
    ``appr_geom_x|y`` -> ``appr_geom_fc_x|y``, ``key_content_bias`` ->
    ``appr_bias`` and ``geom_bias`` flattened ``(heads * dk,)``; a
    ``NonLocal2d``'s ``g``, ``theta``, ``phi``, ``conv_out`` ->
    ``nonlocal_block.<n>.conv``.  Two plugins of one type in a block
    would share mmcv's name: they raise."""
    abbr = _plugin_abbr(blk[name])
    if sum(re.fullmatch(r"after_conv\d_plugin\d+", k) is not None
           and _plugin_abbr(v) == abbr for k, v in blk.items()) > 1:
        raise ValueError(f"{base}: two {abbr} plugins in one block")
    key = f"{base}.{abbr}"
    for sub, p in blk[name].items():
        fusion = re.fullmatch(r"(channel_(?:add|mul))_(conv1|conv2|ln)", sub)
        if fusion:
            idx = {"conv1": 0, "ln": 1, "conv2": 3}[fusion[2]]
            if fusion[2] == "ln":
                for k, v in (("weight", p["scale"]), ("bias", p["bias"])):
                    sd[f"{key}.{fusion[1]}_conv.{idx}.{k}"] = np.asarray(
                        v).reshape(-1, 1, 1)
            else:
                layer(f"{key}.{fusion[1]}_conv.{idx}", p)
        elif sub in ("key_content_bias", "geom_bias"):
            sd[f"{key}.{'appr_bias' if sub[0] == 'k' else sub}"] = \
                np.asarray(p).reshape(-1)
        elif sub in ("appr_geom_x", "appr_geom_y"):
            layer(f"{key}.appr_geom_fc_{sub[-1]}", p, _fc)
        elif abbr == "nonlocal_block":
            layer(f"{key}.{sub}.conv", p)
        else:
            layer(f"{key}.{sub}", p)


# the dense heads' output convs: flax name -> mmdet name
DENSE_OUTPUTS = {"retina_cls": "retina_cls", "retina_reg": "retina_reg",
                 "atss_cls": "atss_cls", "atss_reg": "atss_reg",
                 "atss_centerness": "atss_centerness", "gfl_cls": "gfl_cls",
                 "gfl_reg": "gfl_reg", "conv_cls": "fcos_cls",
                 "conv_reg": "fcos_reg", "conv_centerness": "fcos_centerness",
                 "fovea_cls": "conv_cls", "fovea_reg": "conv_reg",
                 "cls_out": "reppoints_cls_out",
                 "pts_init_conv": "reppoints_pts_init_conv",
                 "pts_init_out": "reppoints_pts_init_out",
                 "pts_refine_out": "reppoints_pts_refine_out"}
# RepPoints' variables that are arrays, not modules: flax name -> mmdet key
DENSE_ARRAYS = {"cls_dcn_kernel": "reppoints_cls_conv.weight",
                "refine_dcn_kernel": "reppoints_pts_refine_conv.weight",
                "moment_transfer": "moment_transfer"}


def _dense_head(bh, sd, layer):
    """A single-stage detector's dense head: ``cls|reg_conv<i>`` and
    ``cls|reg_gn<i>`` -> ``bbox_head.cls|reg_convs.<i>.conv|gn`` (a
    deformable tower conv with its ``conv_offset``; NAS-FCOS's
    ``cls|reg_tower/op<i>|gn<i>`` likewise), the output convs by
    :data:`DENSE_OUTPUTS`, RepPoints' arrays by :data:`DENSE_ARRAYS` (its
    HWIO deformable kernels to OIHW), ``scale<l>`` ->
    ``bbox_head.scales.<l>.scale``."""
    for kind in ("cls", "reg"):
        for sub, p in bh.get(f"{kind}_tower", {}).items():
            op, i = re.fullmatch(r"(op|gn)(\d+)", sub).groups()
            bh = {**bh, f"{kind}_{'conv' if op == 'op' else 'gn'}{i}": p}
    for name, p in bh.items():
        if name.endswith("_tower"):
            continue
        tower = re.fullmatch(r"(cls|reg)_(conv|gn)(\d+)", name)
        scale = re.fullmatch(r"scale(\d+)", name)
        if tower and tower[2] == "conv":
            key = f"bbox_head.{tower[1]}_convs.{tower[3]}.conv"
            layer(key, p)
            if "conv_offset" in p:              # FCOS's dcn_on_last_conv
                layer(f"{key}.conv_offset", p["conv_offset"])
        elif tower:
            key = f"bbox_head.{tower[1]}_convs.{tower[3]}.gn"
            sd[f"{key}.weight"] = np.asarray(p["scale"])
            sd[f"{key}.bias"] = np.asarray(p["bias"])
        elif scale:
            sd[f"bbox_head.scales.{scale[1]}.scale"] = np.asarray(p)
        elif name in DENSE_ARRAYS:
            sd[f"bbox_head.{DENSE_ARRAYS[name]}"] = (
                _conv(p) if name.endswith("kernel") else np.asarray(p))
        else:
            layer(f"bbox_head.{DENSE_OUTPUTS[name]}", p)


# CornerNet's corner-pool modules: flax prefix -> mmdet name
CORNER_POOL = {"d1": "direction1_conv", "d2": "direction2_conv",
               "aftpool": "aftpool_conv", "conv1": "conv1", "conv2": "conv2"}


def _corner_head(bh, sd, layer):
    """CornerNet's head: ``tl|br_pool<l>/<part>_conv|bn`` ->
    ``bbox_head.tl|br_pool.<l>.<mmdet part>.conv|bn`` (:data:`CORNER_POOL`;
    the per-channel GroupNorms' ``scale`` -> ``weight``),
    ``tl|br_heat|off|emb<l>_c<j>`` -> ``bbox_head.tl|br_heat|off|emb.<l>.
    <j>.conv``."""
    for name, p in bh.items():
        pool = re.fullmatch(r"(tl|br)_pool(\d+)", name)
        if pool:
            for sub, q in p.items():
                part, kind = sub.rsplit("_", 1)
                key = f"bbox_head.{pool[1]}_pool.{pool[2]}." \
                    f"{CORNER_POOL[part]}.{kind}"
                if kind == "bn":
                    sd[f"{key}.weight"] = np.asarray(q["scale"])
                    sd[f"{key}.bias"] = np.asarray(q["bias"])
                else:
                    layer(key, q)
            continue
        side, kind, lvl, j = re.fullmatch(
            r"(tl|br)_(heat|off|emb)(\d+)_c(\d)", name).groups()
        layer(f"bbox_head.{side}_{kind}.{lvl}.{j}.conv", p)


def _grid_head(key, gh, sd, layer):
    """Grid R-CNN's head: ``conv<i>``/``gn<i>`` -> ``convs.<i>.conv|gn``,
    ``fo|so_<i>_<j>_dw|pw`` -> ``forder|sorder_trans.<i>.<j>.0|1``, the
    per-point ``deconv1_<i>``/``deconv2_<i>`` concatenated (flipped) into
    ``deconv1``/``deconv2``, ``deconv_gn`` -> ``norm1``."""
    for name, p in gh.items():
        conv = re.fullmatch(r"(conv|gn)(\d+)", name)
        trans = re.fullmatch(r"(fo|so)_(\d+)_(\d+)_(dw|pw)", name)
        if conv and conv[1] == "conv":
            layer(f"{key}.convs.{conv[2]}.conv", p)
        elif conv:
            sd[f"{key}.convs.{conv[2]}.gn.weight"] = np.asarray(p["scale"])
            sd[f"{key}.convs.{conv[2]}.gn.bias"] = np.asarray(p["bias"])
        elif trans:
            order = "forder" if trans[1] == "fo" else "sorder"
            layer(f"{key}.{order}_trans.{trans[2]}.{trans[3]}."
                  f"{0 if trans[4] == 'dw' else 1}", p)
    g = sum(name.startswith("deconv1_") for name in gh)
    for d in ("deconv1", "deconv2"):
        parts = [gh[f"{d}_{i}"] for i in range(g)]
        sd[f"{key}.{d}.weight"] = np.concatenate(
            [_deconv(p["kernel"]) for p in parts])
        sd[f"{key}.{d}.bias"] = np.concatenate(
            [np.asarray(p["bias"]) for p in parts])
    sd[f"{key}.norm1.weight"] = np.asarray(gh["deconv_gn"]["scale"])
    sd[f"{key}.norm1.bias"] = np.asarray(gh["deconv_gn"]["bias"])


def _coarse_head(key, mh, name, p, sd, layer):
    """One variable of PointRend's coarse head: ``conv<i>``,
    ``downsample_conv``, ``fc<i>`` (``fc0`` on the downsampled (S, S, C)
    features), ``fc_logits`` (its (S, S, K) outputs to torch's (K, S,
    S))."""
    if name == "downsample_conv" or name.startswith("conv"):
        layer(f"{key}.{'convs.' + name[4:] if name != 'downsample_conv' else name}"
              ".conv", p)
    elif name == "fc0":
        c = np.shape(mh["downsample_conv"]["kernel"])[-1]
        side = int(round((np.shape(p["kernel"])[0] / c) ** 0.5))
        sd[f"{key}.fcs.0.weight"] = _fc_to_chw(p["kernel"], side, side)
        sd[f"{key}.fcs.0.bias"] = np.asarray(p["bias"])
    elif name == "fc_logits":
        side = int(round((np.shape(mh["fc0"]["kernel"])[0] / np.shape(
            mh["downsample_conv"]["kernel"])[-1]) ** 0.5))
        w = np.asarray(p["kernel"])                          # (in, S*S*K)
        k = w.shape[1] // (side * side)
        sd[f"{key}.fc_logits.weight"] = w.reshape(
            -1, side, side, k).transpose(3, 1, 2, 0).reshape(-1, w.shape[0])
        sd[f"{key}.fc_logits.bias"] = np.asarray(p["bias"]).reshape(
            side, side, k).transpose(2, 0, 1).reshape(-1)
    else:
        layer(f"{key}.fcs.{name[2:]}", p, _fc)


def _double_head(key, bh, stats, roi_feat, sd, layer, norm, block):
    """Double-Head's box head: ``res_{conv,bn}{1,2}`` and ``res_ds_*`` ->
    ``res_block.{conv1,conv2,conv_identity}.{conv,bn}``,
    ``conv_branch_<i>`` -> ``conv_branch.<i>`` (bottlenecks),
    ``fc_branch_<i>`` -> ``fc_branch.<i>``."""
    for jax_name, sub in (("res_conv1", "conv1.conv"),
                          ("res_conv2", "conv2.conv"),
                          ("res_ds_conv", "conv_identity.conv")):
        layer(f"{key}.res_block.{sub}", bh[jax_name])
    for jax_name, sub in (("res_bn1", "conv1.bn"), ("res_bn2", "conv2.bn"),
                          ("res_ds_bn", "conv_identity.bn")):
        norm(f"{key}.res_block.{sub}", bh[jax_name], stats[jax_name])
    for name, p in bh.items():
        m = re.fullmatch(r"(conv|fc)_branch_(\d+)", name)
        if m and m[1] == "conv":
            block(f"{key}.conv_branch.{m[2]}", p, stats[name])
        elif m and m[2] == "0":
            sd[f"{key}.fc_branch.0.weight"] = _fc_to_chw(
                p["kernel"], roi_feat, roi_feat)
            sd[f"{key}.fc_branch.0.bias"] = np.asarray(p["bias"])
        elif m:
            layer(f"{key}.fc_branch.{m[2]}", p, _fc)
    layer(f"{key}.fc_cls", bh["fc_cls"], _fc)
    layer(f"{key}.fc_reg", bh["fc_reg"], _fc)


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


def fold_aws(weight, gamma, beta):
    """The plain conv weight of an mmcv ``ConvAWS2d``: ``weight``
    standardised per output channel (the square root of its unbiased
    variance plus 1e-5), times ``gamma`` plus ``beta`` (``(out, 1, 1,
    1)``)."""
    flat = weight.reshape(weight.shape[0], -1)
    mean = flat.mean(dim=1).reshape(-1, 1, 1, 1)
    std = torch.sqrt(flat.var(dim=1) + 1e-5).reshape(-1, 1, 1, 1)
    return gamma * ((weight - mean) / std) + beta


def mmdet_state_dict(model, sd):
    """``sd`` (an mmdet ``state_dict``) ready for ``model.load_state_dict``:
    without the ``num_batches_tracked`` counters, and with a zero bias for
    each conv of a conv-GroupNorm module of ``model`` (``<m>.conv.bias``
    beside ``<m>.gn.weight``) that ``sd`` lacks: mmdet's conv before a
    norm has none, the port's, as the JAX package's, has one.

    An mmcv ``GeneralizedAttention``'s ``gamma`` folds into its
    ``proj_conv`` (the port's block has none), and its one ``query_conv``
    also fills the port's ``geom_query_conv``.  Its per-head position
    projections ``appr_geom_fc_x|y`` do not fit the JAX block's, shared by
    the heads: such a checkpoint raises ``ValueError`` (ROADMAP.md queue
    C).

    DetectoRS's ``ConvAWS`` convs carry ``weight_gamma``/``weight_beta``
    (mmcv's buffers); where the port's conv is a plain one (every conv
    outside SAC, as in the JAX package) mmcv's standardisation folds into
    its weight (:func:`fold_aws`).

    mmdetection's Guided Anchoring ``FeatureAdaption`` has four offset
    groups (a 72-channel ``conv_offset``), its NAS-FCOS head's deformable
    convs two (54 channels), the port's, as the JAX package's, one: such
    a checkpoint raises ``ValueError`` (ROADMAP.md queue C).

    Where mmdetection has a BatchNorm and the port, as the JAX package, a
    per-channel GroupNorm (NAS-FCOS's FPN, CornerNet's corner pools), the
    affine parameters load and the statistics are dropped; the norms the
    JAX package adds before NAS-FCOS's extra levels, where mmdetection has
    none, start at weight 1 and bias 0."""
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    own = model.state_dict()
    for key in [k for k in sd if k.endswith("conv_offset.weight")
                and k in own and sd[k].shape != own[k].shape]:
        raise ValueError(
            f"{key}: {tuple(sd[key].shape)} is mmdetection's deformable "
            f"conv of {sd[key].shape[0] // own[key].shape[0]} offset "
            f"groups; the port's, as the JAX package's, has one group "
            f"{tuple(own[key].shape)} (ROADMAP.md queue C)")
    for key in [k for k in sd if k.endswith((".running_mean",
                                             ".running_var"))
                and k not in own]:
        if key.rsplit(".", 1)[0] + ".weight" in own:    # a GroupNorm here
            del sd[key]
    for key, v in own.items():
        if re.fullmatch(r"neck\.extra_downsamples\.\d+\.norm\.(weight|bias)",
                        key) and key not in sd:
            sd[key] = torch.ones_like(v) if key.endswith("weight") \
                else torch.zeros_like(v)
    for key in [k for k in sd if k.endswith(".weight_gamma")
                and k not in own]:
        base = key[:-len("weight_gamma")]
        sd[base + "weight"] = fold_aws(sd[base + "weight"], sd.pop(key),
                                       sd.pop(base + "weight_beta"))
    for key in [k for k in sd if re.fullmatch(r"(.*\.)?gamma", k)
                and k[:-len("gamma")] + "proj_conv.weight" in own]:
        # mmcv's attention block scales proj_conv's output by gamma
        base, gamma = key[:-len("gamma")], sd.pop(key)
        for k in ("proj_conv.weight", "proj_conv.bias"):
            sd[base + k] = sd[base + k] * gamma.reshape(())
    for key, v in own.items():
        base = key[:-len("geom_query_conv.weight")]
        if re.fullmatch(r"(.*\.)?geom_query_conv\.weight", key) \
                and key not in sd and f"{base}query_conv.weight" in sd:
            # mmcv's block reads one query conv for both terms
            sd[key] = sd[f"{base}query_conv.weight"].clone()
        if "appr_geom_fc_" in key and key in sd \
                and sd[key].shape != v.shape:
            raise ValueError(
                f"{key}: mmcv's per-head position projection "
                f"{tuple(sd[key].shape)} cannot hold the JAX block's "
                f"projection shared by the heads {tuple(v.shape)} "
                f"(ROADMAP.md queue C)")
    for key, v in model.state_dict().items():
        base = key[:-len(".conv.bias")]
        if key.endswith(".conv.bias") and key not in sd \
                and f"{base}.gn.weight" in sd:
            sd[key] = torch.zeros_like(v)
    return sd

