"""Shared fixtures of the ``test_torch_port_*`` parity tests: the flagship
LOFT-FOA config cut to tiny widths, the JAX model with seeded random
variables, and the port's model carrying the same weights through
``state_dict_from_jax``."""

import os.path as osp

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "configs/loft_foa/loft_foa_r50_fpn_2x_bonai.py")


def tiny_cfg(nms_pre=100, max_num=64, max_per_img=32):
    """The LOFT-FOA R50 config at the ``_tiny_loft_model`` widths
    (``__graft_entry__.py``): ResNet-18 at base 8, 16-channel FPN."""
    from bonai_tpu_torch import Config
    cfg = Config.fromfile(CONFIG)
    m = cfg.model
    m.backbone.update(depth=18, base_channels=8)
    m.neck.update(in_channels=[8, 16, 32, 64], out_channels=16)
    m.rpn_head.update(in_channels=16, feat_channels=16)
    rh = m.roi_head
    for k in ("bbox_roi_extractor", "mask_roi_extractor",
              "offset_roi_extractor"):
        rh[k].out_channels = 16
    rh.bbox_head.update(in_channels=16, fc_out_channels=32)
    rh.mask_head.update(num_convs=1, in_channels=16, conv_out_channels=16)
    rh.offset_head.update(in_channels=16, num_convs=2, fc_out_channels=32,
                          conv_out_channels=16)
    cfg.test_cfg.rpn.update(nms_pre=nms_pre, nms_post=max_num,
                            max_num=max_num)
    cfg.test_cfg.rcnn.max_per_img = max_per_img
    return cfg


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


def jax_model(cfg, seed=0, **build_kw):
    """The JAX LOFT of ``cfg`` in float32 with seeded random variables
    (``build_kw``, e.g. ``roi_align_impl``, go to ``build_detector``).

    The class weights are set so scores spread well apart (NMS order then
    does not hang on float noise), and the box deltas are kept small so
    decoded boxes stay boxes."""
    import jax
    import jax.numpy as jnp
    from bonai_tpu.models import build_detector
    model = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg,
                           compute_dtype="float32", **build_kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    r = np.random.RandomState(seed)
    params = _random_tree(shapes["params"], r)
    stats = _random_tree(shapes["batch_stats"], r)
    params["rpn_head"]["rpn_reg"]["kernel"] *= 0.1
    params["bbox_head"]["fc_reg"]["kernel"] *= 0.1
    # foreground logit = -background logit: softmax scores spread over
    # (0, 1) instead of collapsing onto one class
    fc_cls = params["bbox_head"]["fc_cls"]
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


def tiny_train_cfg():
    """``tiny_cfg`` with the training sizes cut so that both sampler paths
    run: the RPN samples 64 of ~4000 anchors (top-k path), the R-CNN 64
    slots from 32 proposals plus the GTs (fewer candidates than slots:
    the padding path)."""
    cfg = tiny_cfg()
    cfg.train_cfg.rpn.sampler.num = 64
    cfg.train_cfg.rpn_proposal.update(nms_pre=100, nms_post=32, max_num=32)
    cfg.train_cfg.rcnn.sampler.num = 64
    return cfg


def train_batch(seed=0, b=2, size=128, g=6, m=112):
    """A padded training batch in the JAX package's contract, from a numpy
    seed: GT boxes with padded rows, 112^2 instance masks, offsets."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size * 0.6, (b, g, 2))
    wh = r.uniform(12, size * 0.4, (b, g, 2))
    valid = np.ones((b, g), bool)
    valid[-1, -2:] = False
    boxes = np.concatenate([xy, np.minimum(xy + wh, size - 1)], -1)
    boxes[~valid] = 0.0
    img_shape = np.full((b, 2), size, np.float32)
    img_shape[-1] = [size - 16, size - 8]       # a resized, padded image
    return dict(
        image=r.randn(b, size, size, 3).astype(np.float32),
        img_shape=img_shape,
        gt_bboxes=boxes.astype(np.float32),
        gt_labels=np.zeros((b, g), np.int32), gt_valid=valid,
        gt_masks=(r.rand(b, g, m, m) > 0.4).astype(np.float32),
        gt_offsets=r.uniform(-10, 10, (b, g, 2)).astype(np.float32))


def jax_uniforms(key, n):
    """The ``(u_pos, u_neg)`` that ``bonai_tpu.core.samplers.random_sample``
    draws from ``key`` for ``n`` candidates."""
    import jax
    k_pos, k_neg = jax.random.split(key)
    return tuple(np.asarray(jax.random.uniform(k, (n,), minval=1e-4,
                                               maxval=1.0))
                 for k in (k_pos, k_neg))


def jax_forward_train_draws(jm, variables, key, b):
    """A draw source for the port's ``forward_train`` that hands out the
    uniforms the JAX ``forward_train`` draws under ``rngs={"sampling":
    key}``: the RPN's per image, then the R-CNN's per image, from the
    splits of the module's ``sampling`` stream."""
    import jax
    rng = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": key})
    stages = list(jax.random.split(rng))

    def draw(shape, device):
        keys = jax.random.split(stages.pop(0), b)
        pairs = [jax_uniforms(k, shape[-1]) for k in keys]
        return tuple(torch.from_numpy(np.stack(u)).to(device)
                     for u in zip(*pairs))
    return draw
