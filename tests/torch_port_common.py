"""Shared fixtures of the ``test_torch_port_*`` parity tests: the flagship
LOFT-FOA config (or another two-stage BONAI config) cut to tiny widths,
the JAX model with seeded random variables, and the port's model carrying
the same weights through ``state_dict_from_jax``."""

import os.path as osp

import numpy as np
import torch

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


def _each(x):
    """A per-stage config list as it is; one config as a list of one."""
    return x if isinstance(x, (list, tuple)) else [x]


def tiny_cfg(nms_pre=100, max_num=64, max_per_img=32, config=CONFIG):
    """The LOFT-FOA R50 config (``config``; or another two-stage config:
    its heads that are there, a cascade's every stage) at the
    ``_tiny_loft_model`` widths (``__graft_entry__.py``): ResNet-18 at
    base 8, 16-channel FPN; or an HRNet config's backbone at
    ``TINY_HRNET_EXTRA`` and a 16-channel HRFPN."""
    from bonai_tpu_torch import Config
    cfg = Config.fromfile(config)
    m = cfg.model
    if m.backbone.type == "HRNet":
        m.backbone.extra = TINY_HRNET_EXTRA
    else:
        m.backbone.update(depth=18, base_channels=8)
    m.neck.update(in_channels=[8, 16, 32, 64], out_channels=16)
    m.rpn_head.update(in_channels=16, feat_channels=16)
    rh = m.roi_head
    for k in ("bbox_roi_extractor", "mask_roi_extractor",
              "offset_roi_extractor"):
        if rh.get(k) is not None:
            rh[k].out_channels = 16
    for head in _each(rh.bbox_head):
        head.update(in_channels=16, fc_out_channels=32)
    if rh.get("mask_head") is not None:
        rh.mask_head.update(num_convs=1, in_channels=16,
                            conv_out_channels=16)
    if rh.get("offset_head") is not None:
        rh.offset_head.update(in_channels=16, num_convs=2,
                              fc_out_channels=32, conv_out_channels=16)
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
    for name in params:                 # bbox_head, or a cascade's stages
        if not name.startswith("bbox_head"):
            continue
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


def jax_forward_train_draws(jm, variables, key, b, cascade=False):
    """A draw source for the port's ``forward_train`` that hands out the
    uniforms the JAX ``forward_train`` draws under ``rngs={"sampling":
    key}``: the RPN's per image, then the R-CNN's per image, from the
    splits of the module's ``sampling`` stream.  With ``cascade``, the
    R-CNN's are stage ``i``'s at call ``i + 1``: the splits of the R-CNN
    key folded with ``i`` (``bonai_tpu/models/detectors/
    cascade_rcnn.py``)."""
    import jax
    rng = jm.apply(variables, method=lambda m: m.make_rng("sampling"),
                   rngs={"sampling": key})
    rpn, rcnn = jax.random.split(rng)
    keys = iter([rpn] + ([jax.random.fold_in(rcnn, i) for i in range(8)]
                         if cascade else [rcnn]))

    def draw(shape, device):
        pairs = [jax_uniforms(k, shape[-1])
                 for k in jax.random.split(next(keys), b)]
        return tuple(torch.from_numpy(np.stack(u)).to(device)
                     for u in zip(*pairs))
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


def infer_rank(cfg, checkpoint, out):
    """A rank of the sharded-inference test: the checkpoint's model on the
    CPU in float32, this rank's eval shard of ``cfg.data.test``,
    ``run_inference``; rank 0 pickles the merged results to ``out``."""
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
    results = run_inference(model, loader, progress=False)
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
