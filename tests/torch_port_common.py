"""Shared fixtures of the ``test_torch_port_*`` parity tests: the flagship
LOFT-FOA config (or another two-stage BONAI config) cut to tiny widths,
the JAX model with seeded random variables, and the port's model carrying
the same weights through ``state_dict_from_jax``."""

import os
import os.path as osp

import numpy as np
import torch

# One intra-op thread in each test process and in the processes the tests
# start: the tier-1 command runs six pytest workers at once, and PyTorch's
# OpenMP threads, one per core in every worker, busy-wait against each
# other (on an 8-core host, six concurrent runs of a six-step tiny
# training took 172 s each, against 2.5 s with one thread each).
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")
SYNTH_CONFIG = osp.join(ROOT,
                        "configs/loft_foa/loft_foa_r50_fpn_2x_synth_bonai.py")
LOFT_CONFIG = osp.join(ROOT, "configs/loft/loft_r50_fpn_2x_bonai.py")
MASK_RCNN_CONFIG = osp.join(ROOT,
                            "configs/mask_rcnn/mask_rcnn_r50_fpn_2x_bonai.py")
CASCADE_CONFIG = osp.join(
    ROOT, "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_bonai.py")
DYNAMIC_CONFIG = osp.join(
    ROOT, "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_bonai.py")
# the rest of the R-CNN family on BONAI
A7_CONFIGS = {k: osp.join(ROOT, "configs", v) for k, v in {
    "libra": "libra_rcnn/libra_faster_rcnn_r50_fpn_1x_bonai.py",
    "double_head": "double_heads/dh_faster_rcnn_r50_fpn_1x_bonai.py",
    "mask_scoring": "ms_rcnn/ms_rcnn_r50_fpn_1x_bonai.py",
    "rpn": "rpn/rpn_r50_fpn_1x_bonai.py",
    "fast_rcnn": "fast_rcnn/fast_rcnn_r50_fpn_1x_bonai.py",
    "grid": "grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_bonai.py",
    "point_rend": "point_rend/point_rend_r50_fpn_2x_bonai.py"}.items()}


# the dense single-stage detectors
DENSE_CONFIGS = {k: osp.join(ROOT, "configs", v) for k, v in {
    "retinanet": "retinanet/retinanet_r50_fpn_1x_coco.py",
    "ghm": "ghm/retinanet_ghm_r50_fpn_1x_bonai.py",
    "pisa": "pisa/pisa_retinanet_r50_fpn_1x_bonai.py",
    "free_anchor": "free_anchor/retinanet_free_anchor_r50_fpn_1x_bonai.py",
    "atss": "atss/atss_r50_fpn_1x_bonai.py",
    "gfl": "gfl/gfl_r50_fpn_1x_bonai.py",
    "fcos": "fcos/fcos_r50_fpn_1x_bonai.py"}.items()}

# the point-set and anchor-free heads on BONAI (dense_cfg's families too)
POINT_CONFIGS = {k: osp.join(ROOT, "configs", v) for k, v in {
    "reppoints": "reppoints/reppoints_moment_r50_fpn_1x_bonai.py",
    "fsaf": "fsaf/fsaf_r50_fpn_1x_bonai.py",
    "fovea": "foveabox/fovea_r50_fpn_4x4_1x_bonai.py"}.items()}
GA_CONFIG = osp.join(ROOT,
                     "configs/guided_anchoring/ga_faster_r50_fpn_1x_bonai.py")

HRNET_CONFIG = osp.join(ROOT, "configs/hrnet/loft_foa_hrnetv2p_w32_2x_bonai.py")
# HRNet at tiny widths: one module of one block a stage, branches of 8, 16,
# 32 and 64 channels
TINY_HRNET_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(1,), num_channels=(8,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(1, 1), num_channels=(8, 16)),
    stage3=dict(num_modules=1, num_branches=3, block="BASIC",
                num_blocks=(1, 1, 1), num_channels=(8, 16, 32)),
    stage4=dict(num_modules=1, num_branches=4, block="BASIC",
                num_blocks=(1, 1, 1, 1), num_channels=(8, 16, 32, 64)))


# the R-CNN trunk variants on BONAI
TRUNK_CONFIGS = {k: osp.join(ROOT, "configs", v) for k, v in {
    "dcn": "dcn/mask_rcnn_r50_fpn_dconv_c3-c5_1x_bonai.py",
    "gcnet": "gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_bonai.py",
    "attention":
        "empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_bonai.py",
    "res2net": "res2net/mask_rcnn_r2_50_fpn_2x_bonai.py",
    "regnet": "regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_bonai.py",
    "pafpn": "pafpn/faster_rcnn_r50_pafpn_1x_bonai.py"}.items()}
# a RegNetX at tiny widths: stages of 8, 16, 32 and 64 channels (1, 1, 2
# and 2 blocks), group widths 8
TINY_REGNET = dict(w0=8, wa=12, wm=2, group_w=8, depth=6, bot_mul=1.0)

# the last two mask-producing cascades on BONAI
HTC_CONFIG = osp.join(ROOT, "configs/htc/htc_r50_fpn_1x_bonai.py")
DETECTORS_CONFIG = osp.join(
    ROOT, "configs/detectors/detectors_cascade_rcnn_r50_1x_bonai.py")


# the last four BONAI configs: NAS-FPN RetinaNet, NAS-FCOS, SSD300 and
# CornerNet
NAS_SSD_CONFIGS = {k: osp.join(ROOT, "configs", v) for k, v in {
    "nasfpn": "nas_fpn/retinanet_r50_nasfpn_bonai.py",
    "nasfcos": "nas_fcos/nas_fcos_r50_fpn_bonai.py",
    "ssd": "ssd/ssd300_bonai.py",
    "cornernet": "cornernet/cornernet_hourglass104_bonai.py"}.items()}
# SSD's VGG stage widths in the parity tests (fc6, fc7 and the extras keep
# theirs): both packages' module constants, set by ``tiny_vgg``
TINY_VGG = (8, 16, 32, 64, 64)


def tiny_vgg():
    """A context in which both packages' SSD VGG has the stage widths
    ``TINY_VGG`` (the JAX module reads its ``_STAGE_CH`` when it traces,
    the port's ``STAGE_CHANNELS`` when it builds)."""
    import contextlib

    import bonai_tpu.models.backbones.ssd_vgg as jax_vgg
    import bonai_tpu_torch.models.backbones.ssd_vgg as vgg

    @contextlib.contextmanager
    def patched():
        saved = jax_vgg._STAGE_CH, vgg.STAGE_CHANNELS
        jax_vgg._STAGE_CH = vgg.STAGE_CHANNELS = TINY_VGG
        try:
            yield
        finally:
            jax_vgg._STAGE_CH, vgg.STAGE_CHANNELS = saved
    return patched()


def nas_ssd_cfg(family, num_classes=3):
    """The config of a ``NAS_SSD_CONFIGS`` family at tiny widths:
    ResNet-18 at base 8 with a 16-channel NAS-FPN of two stacks (and
    RetinaNet's 64-channel towers of two convs, ``num_classes`` for COCO's
    80) or a 16-channel NAS-FCOS FPN and 64-channel searched towers; SSD's
    head on the ``TINY_VGG`` conv4_3 (build it inside :func:`tiny_vgg`);
    CornerNet's hourglass of two downsamplings at 8 and 16 channels, one
    block a stage, 16 output channels.  ``nms_pre`` 100, 32 detections an
    image (CornerNet: 20 corners a side, 50 pairs)."""
    from bonai_tpu_torch import Config
    cfg = Config.fromfile(NAS_SSD_CONFIGS[family])
    m = cfg.model
    if family in ("nasfpn", "nasfcos"):
        m.backbone.update(depth=18, base_channels=8)
        m.neck.update(in_channels=[8, 16, 32, 64], out_channels=16)
        m.bbox_head.update(in_channels=16, feat_channels=64)
        cfg.test_cfg.update(nms_pre=100, max_per_img=32)
    if family == "nasfpn":
        m.neck.stack_times = 2
        m.bbox_head.update(stacked_convs=2, num_classes=num_classes)
    elif family == "ssd":
        m.bbox_head.in_channels = (TINY_VGG[3],) + tuple(
            m.bbox_head.in_channels[1:])
        cfg.test_cfg.update(nms_pre=100, max_per_img=32)
    elif family == "cornernet":
        m.backbone.update(downsample_times=2, stage_channels=[8, 16, 16],
                          stage_blocks=[1, 1, 1], feat_channel=16)
        m.bbox_head.in_channels = 16
        cfg.test_cfg.update(corner_topk=20, num_dets=50, max_per_img=32)
    return cfg


def _each(x):
    """A per-stage config list as it is; one config as a list of one."""
    return x if isinstance(x, (list, tuple)) else [x]


def tiny_cfg(nms_pre=100, max_num=64, max_per_img=32, config=CONFIG):
    """The LOFT-FOA R50 config (``config``; or another two-stage config:
    its heads that are there, a cascade's every stage) at the
    ``_tiny_loft_model`` widths (``__graft_entry__.py``): ResNet-18 at
    base 8, 16-channel FPN; or an HRNet config's backbone at
    ``TINY_HRNET_EXTRA`` and a 16-channel HRFPN.  Grid R-CNN's grid head
    takes two convs at 8 channels a point, PointRend's coarse head one conv
    and 32-channel FCs, its point head 16 channels."""
    from bonai_tpu_torch import Config
    cfg = Config.fromfile(config)
    m = cfg.model
    if m.backbone.type == "HRNet":
        m.backbone.extra = TINY_HRNET_EXTRA
    else:
        m.backbone.update(depth=18, base_channels=8)
    necks = _each(m.neck)
    necks[0].update(in_channels=[8, 16, 32, 64], out_channels=16)
    for neck in necks[1:]:                      # Libra's BFP
        neck.in_channels = 16
    if m.get("rpn_head") is not None:
        m.rpn_head.update(in_channels=16, feat_channels=16)
    rh = m.get("roi_head") or {}                # the RPN has none
    for k in ("bbox_roi_extractor", "mask_roi_extractor",
              "offset_roi_extractor", "grid_roi_extractor"):
        if rh.get(k) is not None:
            rh[k].out_channels = 16
    for head in _each(rh.get("bbox_head", [])):
        head.update(in_channels=16, fc_out_channels=32)
        if head.get("type") == "DoubleConvFCBBoxHead":
            head.update(conv_out_channels=32, num_convs=2)
    if rh.get("mask_head") is not None:
        rh.mask_head.update(num_convs=1, in_channels=16,
                            conv_out_channels=16)
        if rh.mask_head.get("type") == "CoarseMaskHead":
            rh.mask_head.fc_out_channels = 32
    if rh.get("grid_head") is not None:
        rh.grid_head.update(in_channels=16, point_feat_channels=8,
                            num_convs=2)
    if rh.get("point_head") is not None:
        rh.point_head.update(in_channels=16, fc_channels=16)
    if rh.get("mask_iou_head") is not None:
        rh.mask_iou_head.update(num_convs=2, in_channels=16,
                                conv_out_channels=16, fc_out_channels=32)
    if rh.get("offset_head") is not None:
        rh.offset_head.update(in_channels=16, num_convs=2,
                              fc_out_channels=32, conv_out_channels=16)
    if cfg.test_cfg.get("rpn") is not None:
        cfg.test_cfg.rpn.update(nms_pre=nms_pre, nms_post=max_num,
                                max_num=max_num)
    if cfg.test_cfg.get("rcnn") is not None:
        cfg.test_cfg.rcnn.max_per_img = max_per_img
    return cfg


def dense_cfg(family, num_classes=3):
    """The config of a ``DENSE_CONFIGS`` or ``POINT_CONFIGS`` family at the
    tiny widths (RepPoints' point features 32 channels):
    ResNet-18 at base 8, a 16-channel FPN (the config's ``start_level=1``,
    extra convs and 5 outputs), two 64-channel tower convs (two channels
    to each of GroupNorm's 32 groups: one alone would be normalised over
    a single element on a 1x1 level, rounding noise magnified a
    thousandfold), ``nms_pre`` 100 and 32 detections an image.  The
    RetinaNet-family configs (COCO's 80 classes) take ``num_classes``."""
    from bonai_tpu_torch import Config
    cfg = Config.fromfile({**DENSE_CONFIGS, **POINT_CONFIGS}[family])
    m = cfg.model
    m.backbone.update(depth=18, base_channels=8)
    m.neck.update(in_channels=[8, 16, 32, 64], out_channels=16)
    m.bbox_head.update(in_channels=16, feat_channels=64, stacked_convs=2)
    if m.type == "RepPointsDetector":
        m.bbox_head.point_feat_channels = 32
    if m.bbox_head.num_classes == 80:
        m.bbox_head.num_classes = num_classes
    cfg.test_cfg.update(nms_pre=100, max_per_img=32)
    return cfg


def a7_cfg(family, train=False):
    """The tiny config of an ``A7_CONFIGS`` family (the training sizes of
    :func:`tiny_train_cfg` with ``train``).  Fast R-CNN's is built without
    the RPN head that its BONAI config inherits: the port builds none, and
    without it the JAX detector has none either."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(config=A7_CONFIGS[family])
    if family == "fast_rcnn":
        cfg.model.rpn_head = None
    return cfg


def trunk_cfg(family, train=False):
    """The config of a ``TRUNK_CONFIGS`` family at tiny widths (the
    training sizes of :func:`tiny_train_cfg` with ``train``): its trunk
    as the config has it, but ResNet-50 at base 8 (Res2Net at
    ``base_width`` 4), or RegNet at ``TINY_REGNET``; the heads of
    :func:`tiny_cfg`, with one class (the attention and PAFPN configs
    keep their COCO base's 80; :func:`jax_model` sets one foreground
    logit)."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(
        config=TRUNK_CONFIGS[family])
    cfg.model.roi_head.bbox_head.num_classes = 1
    bk, neck = cfg.model.backbone, cfg.model.neck
    if bk.type == "RegNet":
        bk.pop("base_channels")
        bk.arch = TINY_REGNET
        return cfg
    bk.depth = 50
    neck.in_channels = [32, 64, 128, 256]
    if bk.type == "Res2Net":
        bk.base_width = 4
    return cfg


def ga_cfg(train=False):
    """Guided-Anchoring Faster R-CNN's BONAI config at the tiny widths of
    :func:`tiny_cfg` (the training sizes of :func:`tiny_train_cfg` with
    ``train``), one class (its COCO base has 80)."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(config=GA_CONFIG)
    cfg.model.roi_head.bbox_head.num_classes = 1
    if train:
        cfg.train_cfg.rpn.ga_sampler.num = 64
    return cfg


def htc_cfg(train=False, **roi_head):
    """HTC's BONAI config at the tiny widths of :func:`tiny_cfg` (the
    training sizes of :func:`tiny_train_cfg` with ``train``): ResNet-18 at
    base 8, a 16-channel FPN, one-conv mask heads and a one-conv semantic
    head of 16 channels; ``roi_head`` options (``interleaved``,
    ``mask_info_flow``) set on its RoI head."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(config=HTC_CONFIG)
    rh = cfg.model.roi_head
    rh.semantic_roi_extractor.out_channels = 16
    rh.semantic_head.update(in_channels=16, conv_out_channels=16,
                            num_convs=1)
    rh.update(roi_head)
    return cfg


def detectors_cfg(train=False):
    """DetectoRS's BONAI config at tiny widths (the training sizes of
    :func:`tiny_train_cfg` with ``train``): both ResNets at depth 50 and
    base 8 (SAC and the RFP need bottlenecks), a 16-channel RFP whose ASPP
    gives 4 channels a dilation, the heads of :func:`tiny_cfg`."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(config=DETECTORS_CONFIG)
    cfg.model.backbone.depth = 50
    neck = cfg.model.neck
    neck.update(in_channels=[32, 64, 128, 256], aspp_out_channels=4)
    neck.rfp_backbone.update(depth=50, base_channels=8)
    return cfg


def attr_cfg(train=False):
    """LOFT-FOA with every attribute head at the widths of
    ``tests/test_attribute_heads.py::_attr_cfg`` on the trunk of
    :func:`tiny_cfg` (the training sizes of :func:`tiny_train_cfg` with
    ``train``): ``SemiRPNHead``, height and joint offset-height heads of
    one 32-channel conv and one 32-wide FC, an angle head of one conv,
    side-face and offset-field heads of one conv, offset reweighting.  The
    angle head's ``in_channels`` is the FPN's 16 (the JAX module infers
    it).  The same derivation as ``chip_smoke.py::_attr_config`` at full
    width."""
    cfg = (tiny_train_cfg if train else tiny_cfg)()
    cfg.model.rpn_head.type = "SemiRPNHead"
    rh = cfg.model.roi_head
    trunk = dict(num_convs=1, num_fcs=1, conv_out_channels=32,
                 fc_out_channels=32)
    rh.height_head = dict(trunk, loss_weight=1.0, height_coder=dict(
        target_means=[0.0], target_stds=[4.0]))
    rh.offset_height_head = dict(trunk)
    rh.angle_head = dict(in_channels=16, conv_out_channels=32, num_convs=1,
                         loss_weight=1.0)
    rh.side_face_head = dict(num_convs=1, conv_out_channels=32)
    rh.offset_field_head = dict(num_convs=1, conv_out_channels=32)
    rh.offset_reweight = True
    return cfg


def polar_cfg(train=False):
    """LOFT with the plain ``OffsetHead`` regressing polar offsets as
    ``(length, cos, sin)`` (``reg_num=3``, ``DeltaPolarOffsetCoder``) at
    the widths of ``tests/test_polar_offsets.py::_polar_cfg`` on the trunk
    of :func:`tiny_cfg`; its train pipeline turns the flipped offsets
    polar (``OffsetTransform('xy2la')`` after ``RandomFlip``).  The same
    derivation as ``chip_smoke.py::_polar_config`` at full width."""
    cfg = (tiny_train_cfg if train else tiny_cfg)(config=LOFT_CONFIG)
    cfg.model.roi_head.offset_head = dict(
        type="OffsetHead", num_convs=1, num_fcs=1, in_channels=16,
        conv_out_channels=32, fc_out_channels=32, reg_num=3,
        offset_coordinate="polar",
        offset_coder=dict(type="DeltaPolarOffsetCoder",
                          target_means=[0.0, 0.0], target_stds=[0.5, 0.5]),
        loss_offset=dict(type="SmoothL1Loss", loss_weight=8.0))
    pipeline = cfg.data.train.pipeline
    flip = [i for i, p in enumerate(pipeline) if p.type == "RandomFlip"][0]
    pipeline.insert(flip + 1, dict(type="OffsetTransform",
                                   transform_flag="xy2la"))
    return cfg


def attr_batch(seed=0, b=2, size=128, g=6):
    """:func:`train_batch` with the attribute heads' GT: building heights,
    the images' angles, a random side-face map and offset field at the
    image's size, the roofs shifted by their offsets as footprint boxes,
    and the first image footprint-only."""
    r = np.random.RandomState(seed + 100)
    batch = train_batch(seed, b=b, size=size, g=g)
    fp = batch["gt_bboxes"] - np.tile(batch["gt_offsets"], 2)
    fp = np.clip(fp, 0, size - 1) * batch["gt_valid"][..., None]
    batch.update(
        gt_building_heights=r.uniform(3, 30, (b, g)).astype(np.float32),
        gt_angle=r.uniform(0.1, 0.6, (b,)).astype(np.float32),
        gt_side_face_maps=(r.rand(b, size, size) > 0.7).astype(np.float32),
        gt_offset_field=r.uniform(-10, 10, (b, size, size, 2)).astype(
            np.float32),
        gt_footprint_bboxes=fp.astype(np.float32),
        gt_only_footprint_flag=np.array([1.0] + [0.0] * (b - 1),
                                        np.float32))
    return batch


def _random_tree(shapes, r):
    """Seeded numpy values for every leaf of a flax variable tree: LeCun
    normal kernels, random biases and BatchNorm affine and statistics (so
    their conversion is exercised)."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = _random_tree(v, r)
            continue
        if k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            x = r.normal(0.0, np.sqrt(1.0 / fan_in), v.shape)
        elif k == "var":
            x = r.uniform(0.5, 2.0, v.shape)
        elif k == "scale":
            x = r.normal(1.0, 0.1, v.shape)
        else:                                   # bias, mean
            x = r.normal(0.0, 0.1, v.shape)
        out[k] = x.astype(np.float32)
    return out


def jax_model(cfg, seed=0, init_size=64, **build_kw):
    """The JAX LOFT of ``cfg`` in float32 with seeded random variables
    (``build_kw``, e.g. ``roi_align_impl``, go to ``build_detector``;
    initialised on an ``init_size``^2 image: NAS-FPN's P7 needs 256).

    The class weights are set so scores spread well apart (NMS order then
    does not hang on float noise), and the box deltas are kept small so
    decoded boxes stay boxes."""
    import jax
    import jax.numpy as jnp
    from bonai_tpu.models import build_detector
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           compute_dtype="float32", **build_kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, init_size, init_size, 3)))
    r = np.random.RandomState(seed)
    params = _random_tree(shapes["params"], r)
    stats = _random_tree(shapes.get("batch_stats", {}), r)
    for k in ("rpn_reg", "conv_reg", "conv_shape"):   # GA-RPN's last two
        if k in params.get("rpn_head", {}):     # Fast R-CNN has none
            params["rpn_head"][k]["kernel"] *= 0.1
    for name in params:                 # bbox_head, or a cascade's stages
        if not name.startswith("bbox_head") or "fc_cls" not in params[name]:
            continue                    # a single-stage detector's dense head
        if "fc_reg" in params[name]:           # not Grid R-CNN's
            params[name]["fc_reg"]["kernel"] *= 0.1
        # foreground logit = -background logit: softmax scores spread over
        # (0, 1) instead of collapsing onto one class
        fc_cls = params[name]["fc_cls"]
        fg = fc_cls["kernel"][:, :1]
        fc_cls["kernel"] = np.concatenate([fg, -fg], axis=1)
        fc_cls["bias"] = np.zeros_like(fc_cls["bias"])
    return model, {"params": params, "batch_stats": stats}


def port_model(cfg, variables, **build_kw):
    """The port's LOFT of ``cfg`` on the CPU in float32, carrying the JAX
    variables (``build_kw`` go to ``build_detector``)."""
    from bonai_tpu_torch.models import build_detector
    from bonai_tpu_torch.utils.weights import state_dict_from_jax
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           **build_kw)
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model.eval()


def t(x):
    return torch.from_numpy(np.array(x))


def tiny_train_cfg(config=CONFIG):
    """``tiny_cfg`` with the training sizes cut so that both sampler paths
    run: the RPN samples 64 of ~4000 anchors (top-k path), the R-CNN 64
    slots from 32 proposals plus the GTs (fewer candidates than slots:
    the padding path)."""
    cfg = tiny_cfg(config=config)
    cfg.train_cfg.rpn.sampler.num = 64
    cfg.train_cfg.rpn_proposal.update(nms_pre=100, nms_post=32, max_num=32)
    for stage in _each(cfg.train_cfg.rcnn):
        stage.sampler.num = 64
    return cfg


def train_batch(seed=0, b=2, size=128, g=6, m=112, semantic=None):
    """A padded training batch in the JAX package's contract, from a numpy
    seed: GT boxes with padded rows, 112^2 instance masks, offsets; with
    ``semantic`` (a stride) HTC's ``gt_semantic_seg`` at ``size /
    semantic``, random labels of its four classes."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size * 0.6, (b, g, 2))
    wh = r.uniform(12, size * 0.4, (b, g, 2))
    valid = np.ones((b, g), bool)
    valid[-1, -2:] = False
    boxes = np.concatenate([xy, np.minimum(xy + wh, size - 1)], -1)
    boxes[~valid] = 0.0
    img_shape = np.full((b, 2), size, np.float32)
    img_shape[-1] = [size - 16, size - 8]       # a resized, padded image
    extra = {} if semantic is None else dict(gt_semantic_seg=r.randint(
        0, 4, (b, size // semantic, size // semantic)).astype(np.int32))
    return dict(
        **extra, image=r.randn(b, size, size, 3).astype(np.float32),
        img_shape=img_shape,
        gt_bboxes=boxes.astype(np.float32),
        gt_labels=np.zeros((b, g), np.int32), gt_valid=valid,
        gt_masks=(r.rand(b, g, m, m) > 0.4).astype(np.float32),
        gt_offsets=r.uniform(-10, 10, (b, g, 2)).astype(np.float32))


def jax_uniforms(key, n, streams=2):
    """The uniforms that ``bonai_tpu.core.samplers.random_sample`` (two
    streams: ``u_pos``, ``u_neg``) or ``iou_balanced_neg_sample`` (three:
    and ``u_fill``) draws from ``key`` for ``n`` candidates."""
    import jax
    return tuple(np.asarray(jax.random.uniform(k, (n,), minval=1e-4,
                                               maxval=1.0))
                 for k in jax.random.split(key, streams))


def jax_forward_train_draws(jm, variables, key, b, cascade=False,
                            unsplit=False, htc=False, ga=False):
    """A draw source for the port's ``forward_train`` that hands out the
    numbers the JAX ``forward_train`` draws under ``rngs={"sampling":
    key}``.  ``draw(shape, device, n)``: the RPN's uniforms per image, then
    the R-CNN's per image, from the splits of the module's first
    ``sampling`` key (as many streams as the port's sampler asks for).
    With ``cascade``, the R-CNN's are stage ``i``'s at call ``i + 1``: the
    splits of the R-CNN key folded with ``i``
    (``bonai_tpu/models/detectors/cascade_rcnn.py``).  With ``ga``
    (Guided Anchoring's RPN, which samples twice), the RPN key gives the
    shape sampler's per-image splits and the RPN key folded with 1 the RPN
    sampler's (``bonai_tpu/models/dense_heads/ga_rpn_head.py``), before
    the R-CNN's.  With ``htc``, each
    stage's box draw is followed by its interleaved mask draw, from the
    R-CNN key folded with ``100 + i`` (``bonai_tpu/models/detectors/
    htc.py``).  With ``unsplit``
    (the RPN-only detector and Fast R-CNN, which sample once), the one
    call's are the splits of the key itself.

    The module's second ``sampling`` key gives ``draw.offsets(shape,
    device, amplitude)``, Grid R-CNN's jitter: split per image, each
    image's ``jax.random.uniform(k, shape[1:], -amplitude, amplitude)``;
    and ``draw.points(shapes, device)``, PointRend's points: the uniforms
    of the key's two splits (``r1``, ``r2``) of the two shapes."""
    import jax
    rng, second = jm.apply(
        variables, rngs={"sampling": key},
        method=lambda m: (m.make_rng("sampling"), m.make_rng("sampling")))
    rpn, rcnn = jax.random.split(rng)
    if htc:
        stages = [jax.random.fold_in(rcnn, i + k) for i in range(8)
                  for k in (0, 100)]
    else:
        stages = [jax.random.fold_in(rcnn, i) for i in range(8)] \
            if cascade else [rcnn]
    rpn_keys = [rpn, jax.random.fold_in(rpn, 1)] if ga else [rpn]
    keys = iter([rng] if unsplit else rpn_keys + stages)

    def draw(shape, device, n=2):
        per_image = [jax_uniforms(k, shape[-1], n)
                     for k in jax.random.split(next(keys), b)]
        return tuple(torch.from_numpy(np.stack(u)).to(device)
                     for u in zip(*per_image))

    def offsets(shape, device, amplitude):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            k, shape[1:], minval=-amplitude, maxval=amplitude))
            for k in jax.random.split(second, shape[0])])).to(device)

    def points(shapes, device):
        return tuple(torch.from_numpy(np.array(jax.random.uniform(k, s)))
                     .to(device)
                     for k, s in zip(jax.random.split(second), shapes))
    draw.offsets, draw.points = offsets, points
    return draw


def edge_rois(B=2):
    """``(n, 5)`` float32 RoIs on the edges of the level rules, one float32
    ulp below, at and above: max(w, h) = 112 * 2^k (the block push),
    w = 144 * 2^k (the strip push), sqrt(w * h) = 56 * 2^k and
    56 * (2^k - 1e-6) (the gather rule), from the origin and from a
    fractional corner."""
    rows = []
    for k in range(-2, 6):
        edges = [(112, "wide"), (112, "tall"), (144, "wide"), (56, "square"),
                 (56 * (1 - 1e-6 / 2.0 ** k), "square")]
        for edge, shape in edges:
            e = np.float32(edge * 2.0 ** k)
            for v in (np.nextafter(e, np.float32(0)), e,
                      np.nextafter(e, np.float32(np.inf))):
                w, h = {"wide": (v, v / 8), "tall": (v / 8, v),
                        "square": (v, v)}[shape]
                for x0, y0 in ((0.0, 0.0), (100.25, 37.5)):
                    rows.append([len(rows) % B, x0, y0, np.float32(x0) + w,
                                 np.float32(y0) + h])
    return np.array(rows, np.float32)


def synth_data(out, n=4, size=128, seed=0):
    """``n`` synthetic BONAI tiles of ``size``^2 from the port's generator
    in ``out/train``; returns the directory ``out``."""
    from bonai_tpu_torch.tools.make_synthetic_bonai import write_split
    write_split(str(out), "train", n, seed, size)
    return str(out)


def synth_train_cfg(data_dir, size=128, max_gt=64):
    """The 2x synthetic recipe at the tiny widths (its ``frozen_stages=-1,
    norm_eval=False``), training on the tiles of :func:`synth_data`: the
    train pipeline at ``img_scale=(size, size)`` (the identity), the
    decoded-image cache under ``data_dir``."""
    cfg = tiny_train_cfg(SYNTH_CONFIG)
    train = cfg.data.train
    train.ann_file = osp.join(data_dir, "train", "train.json")
    train.img_prefix = osp.join(data_dir, "train", "images") + "/"
    train.pipeline[0].cache_dir = osp.join(data_dir, "imgcache_train")
    train.pipeline[2].img_scale = (size, size)
    cfg.data.max_gt = max_gt
    cfg.log_config.interval = 1
    return cfg


RUN2X = osp.join(ROOT, "data", "synth_run2x")
TORCH_RUN2X = osp.join(ROOT, "data", "torch_run2x")


def run2x_records(run_dir=RUN2X, prefix="merged_r5"):
    """A 2x run's merged predictions (``<prefix>_{roof,footprint}.csv`` in
    ``run_dir``; by default the JAX run's, ``data/synth_run2x/
    merged_r5_*.csv``) as evaluator records, keyed by scene stem: the roof
    and footprint polygons of each row, its confidence, and its offset
    recovered as the roof's first vertex minus the footprint's."""
    from bonai_tpu_torch.evaluation.bonai_eval import load_csv
    roofs = load_csv(osp.join(run_dir, f"{prefix}_roof.csv"))
    feet = load_csv(osp.join(run_dir, f"{prefix}_footprint.csv"))
    assert roofs.keys() == feet.keys()
    out = {}
    for stem, rs in roofs.items():
        fs = feet[stem]
        assert len(rs) == len(fs)
        out[stem] = [dict(polygon=r["polygon"],
                          footprint_polygon=f["polygon"], score=r["score"],
                          offset=r["polygon"][0] - f["polygon"][0])
                     for r, f in zip(rs, fs)]
    return out


def stem_keys(records):
    """Records keyed by file name -> keyed by its stem (the evaluation
    CLI's ``--merge`` rule)."""
    return {k.rsplit(".", 1)[0] if "." in k else k: v
            for k, v in records.items()}


# ---------------------------------------------------------------------------
# data-parallel ranks: functions that ``bonai_tpu_torch.parallel.launch``
# runs in its spawned processes (torch and numpy only, no JAX; inputs and
# outputs go through files)
# ---------------------------------------------------------------------------

def ddp_train_cfg():
    """The tiny 2x synthetic recipe (every parameter trains:
    ``frozen_stages=-1``) at a constant LR of 0.2: large enough that each
    tensor's update is far above its float32 rounding."""
    cfg = tiny_train_cfg(SYNTH_CONFIG)
    cfg.lr_config = dict(policy="step", warmup=None, step=[])
    cfg.optimizer.lr = 0.2
    return cfg


def replay_draws(pairs):
    """A draw source handing out recorded ``(u_pos, u_neg)`` numpy pairs in
    order."""
    pairs = iter(pairs)

    def draw(shape, device):
        u_pos, u_neg = next(pairs)
        assert u_pos.shape == tuple(shape), (u_pos.shape, shape)
        return (torch.from_numpy(u_pos).to(device),
                torch.from_numpy(u_neg).to(device))
    return draw


def ddp_step_rank(inputs, out_dir, cfg=None):
    """A rank of the data-parallel step test: ``build_trainer`` of ``cfg``
    (:func:`ddp_train_cfg` by default) in the process group (DDP), then for
    each global
    batch ``batch/<s>/*`` of ``inputs`` (an ``.npz``) in turn, one step
    (step 0) from its weights ``sd/*`` and a fresh momentum, with this
    rank's recorded draws ``draw/<rank>/<s>/<i>/{pos,neg}``.  Writes each
    step's metrics (mean over the ranks) and weights to
    ``out_dir/rank<r>.npz``."""
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis.train import build_trainer, rank_rows
    torch.set_num_threads(1)
    rank, world_size = parallel.world()
    d = np.load(inputs)
    model, optimizer, train_step, _ = build_trainer(cfg or ddp_train_cfg(),
                                                    torch.device("cpu"))
    start = {k[3:]: torch.from_numpy(d[k]) for k in d.files
             if k.startswith("sd/")}
    out = {}
    steps = sorted({int(k.split("/")[1]) for k in d.files
                    if k.startswith("batch/")})
    for s in steps:
        batch = {k.split("/")[2]: d[k] for k in d.files
                 if k.startswith(f"batch/{s}/")}
        draws = [(d[f"draw/{rank}/{s}/{i}/pos"], d[f"draw/{rank}/{s}/{i}/neg"])
                 for i in range(2)]
        model.load_state_dict(start)
        optimizer.state.clear()
        metrics = train_step(rank_rows(batch, rank, world_size), 0,
                             replay_draws(draws))
        for k, v in parallel.mean_over_ranks(metrics).items():
            out[f"metrics/{s}/{k}"] = np.float64(v)
        for k, v in model.state_dict().items():
            out[f"sd/{s}/{k}"] = v.numpy().copy()
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), **out)


def infer_rank(cfg, checkpoint, out, tta=None):
    """A rank of the sharded-inference test: the checkpoint's model on the
    CPU in float32, this rank's eval shard of ``cfg.data.test``,
    ``run_inference`` (with the test-time augmentation ``tta``); rank 0
    pickles the merged results to ``out``."""
    import pickle
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis import init_detector, run_inference
    from bonai_tpu_torch.datasets import build_dataloader, build_dataset
    torch.set_num_threads(1)
    rank, world_size = parallel.world()
    model = init_detector(cfg, checkpoint, device="cpu", dtype=torch.float32)
    loader = build_dataloader(
        build_dataset(dict(cfg.data.test, test_mode=True)),
        samples_per_gpu=2, shuffle=False, train=False, shard_id=rank,
        num_shards=world_size)
    results = run_inference(model, loader, progress=False, tta=tta)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)


def exit_rank(codes):
    """A rank that joins the group's first collective and exits with
    ``codes[rank]``."""
    import sys
    from bonai_tpu_torch import parallel
    rank, _ = parallel.world()
    parallel.gather_objects(rank)
    sys.exit(codes[rank])


def ballast_train_rank(cfg, work_dir, ballast_gb):
    """A rank of ``train_detector`` on the CPU whose rank 1 first holds
    ``ballast_gb`` GB more host memory (written, so resident) than rank
    0."""
    from bonai_tpu_torch import parallel
    from bonai_tpu_torch.apis import train_detector
    torch.set_num_threads(1)
    rank, _ = parallel.world()
    ballast = np.ones(int(ballast_gb * 1e9) // 8) if rank == 1 else None
    train_detector(cfg, None, work_dir, device="cpu")
    del ballast
