"""The inference loop over a test loader, padded device outputs ->
per-image results in the reference layout, and test-time augmentation
(counterparts of ``bonai_tpu/apis/test.py``: ``run_inference``,
``results_to_host``, ``flip_device_result``, ``merge_flip_tta``,
``tta_cfg_from_pipeline`` and ``make_tta_step``).

Test-time augmentation merges at one of two levels.  At the detection
level (``mode='det'``, :func:`make_tta_step`) every view runs
``simple_test``; its detections, mapped back to the original frame, are
merged by class-offset NMS and the best ``max_per_img`` kept.  At the
proposal level (``mode='proposal'``) the detector's ``aug_test`` merges the
views' proposals, averages the views' box and class predictions on them and
their mask probabilities (``models/detectors/two_stage.py``).  A view is a
scale of the padded canvas, resized with the antialiased bilinear resize
of ``jax.image.resize`` to a multiple of 32, and a flip of it: the whole
canvas is mirrored, which is exact for BONAI's 1024^2 tiles (the canvas
is the image).
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..core.boxes import bbox_flip
from ..core.masks import paste_mask_rle
from ..core.nms import _sort_desc, batched_nms
from ..datasets import build_dataloader, build_dataset
from ..datasets.pipelines import MultiScaleFlipAug
from ..models.roi_heads.mask_head import resize_bilinear
from ..parallel import collect_results_shards, world


def results_to_host(device_out, metas, num_classes=1, mask_thr=0.5,
                    with_offset=True):
    """Convert one batch of ``simple_test`` outputs to per-image tuples
    ``(bbox_results, segm_results[, offsets])``: ``bbox_results`` is a
    per-class list of ``(n, 5)`` float32 arrays, ``segm_results`` per-class
    lists of COCO RLE dicts (masks pasted into the original image of
    ``metas[i]['ori_shape']``), ``offsets`` an ``(n, 2)`` float32 array.
    With Mask Scoring's ``mask_scores`` the segm entry is the pair
    ``(segm_results, per-class (n,) float32 mask scores)``, as in the JAX
    package."""
    host = {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in device_out.items()}
    boxes, scores = host["det_bboxes"], host["det_scores"]
    labels, valid = host["det_labels"], host["det_valid"].astype(bool)
    masks = host.get("mask_probs")
    mask_scores = host.get("mask_scores")
    offsets = host.get("offsets")
    results = []
    for i in range(boxes.shape[0]):
        meta = metas[i] if i < len(metas) else {}
        v = valid[i]
        bx, sc, lb = boxes[i][v], scores[i][v], labels[i][v]
        oh, ow = (int(s) for s in (meta.get("ori_shape") or (1024, 1024)))
        bbox_results = [np.concatenate([bx[lb == c], sc[lb == c, None]], 1)
                        if (lb == c).any() else np.zeros((0, 5), np.float32)
                        for c in range(num_classes)]
        out = [bbox_results]
        if masks is not None:
            mp = masks[i][v]
            segm = [[paste_mask_rle(m, b, oh, ow, mask_thr)
                     for m, b in zip(mp[lb == c], bx[lb == c])]
                    for c in range(num_classes)]
            if mask_scores is not None:
                ms = mask_scores[i][v].astype(np.float32)
                segm = (segm, [ms[lb == c] for c in range(num_classes)])
            out.append(segm)
        if with_offset and offsets is not None:
            out.append(offsets[i][v].astype(np.float32))
        results.append(tuple(out) if len(out) > 1 else bbox_results)
    return results


# ---------------------------------------------------------------------------
# test-time augmentation
# ---------------------------------------------------------------------------

def tta_size(size, scale):
    """The side of the padded canvas ``size`` at view scale ``scale``: the
    nearest multiple of 32, at least 32."""
    return max(int(round(size * scale / 32)) * 32, 32)


def resize_image(img, h, w):
    """``(B, H, W, C)`` images resized to ``(h, w)`` as
    ``jax.image.resize(..., 'bilinear')`` resizes them (antialiased where
    they shrink), in float32."""
    x = resize_bilinear(img.float().permute(0, 3, 1, 2), (h, w))
    return x.permute(0, 2, 3, 1)


def flip_device_result(out, img_shape, direction="horizontal"):
    """Padded ``simple_test`` outputs of a flipped view mapped back to the
    unflipped frame ``img_shape`` ``(B, 2)`` (h, w): boxes mirrored, mask
    probabilities flipped, and the ``offsets`` component along the flip
    negated (a polar model's ``(length, angle)`` too, as in the JAX
    package).  Other outputs pass as they are."""
    flipped = dict(out)
    hw = (img_shape[:, 0, None], img_shape[:, 1, None])
    flipped["det_bboxes"] = bbox_flip(out["det_bboxes"], hw, direction)
    horizontal = direction == "horizontal"
    if "mask_probs" in out:
        flipped["mask_probs"] = torch.flip(out["mask_probs"],
                                           [3 if horizontal else 2])
    if "offsets" in out:
        o = out["offsets"]
        flipped["offsets"] = o * o.new_tensor(
            [-1.0, 1.0] if horizontal else [1.0, -1.0])
    return flipped


def merge_flip_tta(orig, flipped_back, iou_thr=0.5, max_per_img=None):
    """Detection-level merge of two views' padded outputs: every output
    concatenated along the detections, class-offset NMS over the valid
    ones, then the ``max_per_img`` best kept scores (exact ties to the
    lower index, as ``jax.lax.top_k``), each output gathered in that
    order.  An image-level output (a 1-D ``(B,)`` tensor, such as the angle
    head's ``angle``) cannot be concatenated so: the JAX function raises
    ``ValueError`` on it, and so does this one."""
    n = orig["det_bboxes"].shape[1]
    max_per_img = max_per_img or n
    out = {}
    for k, v in orig.items():
        if v.dim() < 2:
            raise ValueError(f"merge_flip_tta concatenates each output "
                             f"along its detections (axis 1); {k!r} has "
                             f"shape {tuple(v.shape)}")
        out[k] = torch.cat([v, flipped_back[k]], dim=1)
    keep = batched_nms(out["det_bboxes"], out["det_scores"],
                       out["det_labels"], iou_thr, valid=out["det_valid"])
    scores = torch.where(keep, out["det_scores"],
                         torch.zeros_like(out["det_scores"]))
    top, idx = (t[:, :max_per_img] for t in _sort_desc(scores))
    merged = {k: v.gather(1, idx.reshape(idx.shape + (1,) * (v.dim() - 2))
                          .expand((-1, -1) + v.shape[2:]))
              for k, v in out.items()}
    merged["det_scores"] = top
    merged["det_valid"] = top > 0
    return merged


def tta_cfg_from_pipeline(dataset):
    """The views that the test pipeline's ``MultiScaleFlipAug`` declares
    (when it declares a flip or several scales), else horizontal and
    vertical flips at scale 1, the default for BONAI's 1024^2 tiles."""
    for ds in getattr(dataset, "datasets", [dataset]):
        pipeline = getattr(ds, "pipeline", None)
        for t in getattr(pipeline, "transforms", []):
            if isinstance(t, MultiScaleFlipAug):
                cfg = t.tta_cfg()
                if cfg["flip"] or len(cfg["scales"]) > 1:
                    return cfg
    return dict(scales=[1.0], flip=True,
                flip_directions=["horizontal", "vertical"])


def make_tta_step(scales=(1.0,), flip=False,
                  flip_directions=("horizontal",), iou_thr=0.5):
    """The detection-level test-time augmentation step ``step(model, image,
    img_shape, scale_factor)``: ``model.simple_test`` on every view (each
    scale of ``scales``, and with ``flip`` each of its ``flip_directions``
    too), the views' detections merged into the first's by
    :func:`merge_flip_tta`, in view order.

    A flipped view's detections are mirrored back about the padded canvas
    mapped to the original frame: its width (or height) divided by the
    view's scale factor.  At a view scale other than 1 the JAX step uses
    the full canvas there, not the resized one, so such a flipped view's
    boxes land off the image (ROADMAP.md queue C); the port keeps that."""

    @torch.inference_mode()
    def step(model, image, img_shape, scale_factor):
        views = []
        pad_h, pad_w = float(image.shape[1]), float(image.shape[2])
        img_shape, scale_factor = img_shape.float(), scale_factor.float()
        for s in scales:
            if s == 1.0:
                img_s, shape_s, sf_s = image, img_shape, scale_factor
            else:
                nh, nw = tta_size(pad_h, s), tta_size(pad_w, s)
                img_s = resize_image(image, nh, nw)
                sy, sx = nh / pad_h, nw / pad_w
                shape_s = img_shape * img_shape.new_tensor([sy, sx])
                sf_s = scale_factor * ((sx + sy) / 2.0)
            views.append(model.simple_test(img_s, shape_s, sf_s))
            if not flip:
                continue
            for direction in flip_directions:
                horizontal = direction == "horizontal"
                out_f = model.simple_test(
                    torch.flip(img_s, [2 if horizontal else 1]), shape_s,
                    sf_s)
                frame = torch.stack(
                    [torch.zeros_like(sf_s) + pad_h, pad_w / sf_s]
                    if horizontal else
                    [pad_h / sf_s, torch.zeros_like(sf_s) + pad_w], -1)
                views.append(flip_device_result(out_f, frame, direction))
        merged = views[0]
        max_per_img = merged["det_bboxes"].shape[1]
        for v in views[1:]:
            merged = merge_flip_tta(merged, v, iou_thr=iou_thr,
                                    max_per_img=max_per_img)
        return merged

    return step


def tta_runner(model, tta):
    """``run(img, img_shape, scale_factor)`` for the test-time
    augmentation settings ``tta``: ``dict(scales=[...], flip=bool,
    flip_directions=[...], iou_thr=..., mode='det'|'proposal')``."""
    if model.takes_proposals:
        raise ValueError(f"{type(model).__name__} tests on given proposals: "
                         f"test-time augmentation runs the detector's own "
                         f"RPN, which it has not")
    scales = tuple(tta.get("scales", (1.0,)))
    directions = tuple(tta.get("flip_directions", ("horizontal",)))
    flip = bool(tta.get("flip", False))
    mode = tta.get("mode", "det")
    if mode == "proposal":
        views = (None,) + (directions if flip else ())
        return lambda img, shp, sf: model.aug_test(
            img, shp, sf, scales=scales, flip_directions=views)
    if mode != "det":
        raise ValueError(f"test-time augmentation mode {mode!r}")
    step = make_tta_step(scales, flip, directions,
                         float(tta.get("iou_thr", 0.5)))
    return lambda img, shp, sf: step(model, img, shp, sf)


def run_inference(model, loader, max_images=None, with_offset=True,
                  progress=True, tta=None):
    """Run ``model.simple_test`` over the batches of a test loader (the
    port's ``build_dataloader(..., train=False, shuffle=False)``) on the
    model's device; returns the flat list of :func:`results_to_host`
    results in dataset order (reference ``single_gpu_test``), without the
    duplicates that wrap-pad the last batch and cut to ``max_images``.
    A Fast R-CNN tests on the batch's proposals (the test pipeline's
    ``LoadProposals``; the JAX loop passes none, ROADMAP.md queue C).

    Sharded testing (reference ``multi_gpu_test``; the JAX function's
    ``mesh=``): in a process group of ``W`` ranks (a rank of
    ``parallel.launch`` or ``torchrun``), each rank passes the loader of
    its eval shard (``build_dataloader(..., shard_id=rank,
    num_shards=W)``: the wrap-padded interleave of the dataset) and runs
    its images on its own card; the ranks' results are merged by
    ``parallel.collect_results_shards`` into dataset order, which every
    rank returns.  The process group is the port's counterpart of the
    mesh: one process per card, where JAX shards one batch over its
    devices from one process.

    ``tta``: test-time augmentation, ``dict(scales=[...], flip=bool,
    flip_directions=[...], mode='det'|'proposal')`` (``iou_thr`` too at
    the detection level, the default); each batch then runs the views of
    :func:`make_tta_step` or the detector's ``aug_test``.  On the sharded
    path each rank runs its own shard's views."""
    run = tta_runner(model, tta) if tta else None
    _, world_size = world()
    num_shards = getattr(loader, "num_shards", 1)
    if num_shards != world_size:
        raise ValueError(f"a loader of {num_shards} shard(s) in a process "
                         f"group of {world_size}")
    total = len(loader.dataset)
    if max_images is not None:
        total = min(total, max_images)
    per_rank = -(-total // world_size)      # shard s holds padded[s::W]
    device = next(model.parameters()).device
    results = []
    seen = 0
    with torch.inference_mode():
        for batch, metas in loader:
            img, shp, sf = (torch.as_tensor(batch[k]).to(device)
                            for k in ("image", "img_shape", "scale_factor"))
            if run is not None:
                out = run(img, shp, sf)
            elif not model.takes_proposals:
                out = model.simple_test(img, shp, sf)
            elif "proposals" not in batch:
                raise ValueError(
                    "a detector without an RPN tests on proposals: give "
                    "the test pipeline LoadProposals and its split a "
                    "proposal_file (datasets.proposals.fast_rcnn_config)")
            else:
                out = model.simple_test(img, shp, sf, *(
                    torch.as_tensor(batch[k]).to(device)
                    for k in ("proposals", "proposals_valid")))
            results.extend(results_to_host(out, metas,
                                           with_offset=with_offset))
            seen += img.shape[0]
            if progress:
                print(f"\r{seen} images", end="", flush=True)
            if seen >= per_rank:
                break
    if progress:
        print()
    return collect_results_shards(results, total)


def test_split(cfg, checkpoint, test_cfg=None, device=None, max_images=None,
               tta=None):
    """Inference over a test split, as the test CLIs run it: the model of
    ``cfg`` with the weights of ``checkpoint`` (a ``.pth``: the port's own
    ``step_N.pth`` or an mmdet v2.3 checkpoint) in the config's
    ``compute_dtype`` (bfloat16 by default) on ``device``, over the
    dataset of ``test_cfg`` (by default ``cfg.data.test``) in test mode,
    with the test-time augmentation ``tta`` of :func:`run_inference`
    (without ``scales`` and ``flip``, the views of
    :func:`tta_cfg_from_pipeline`, printed as the test CLIs print them).
    Returns ``(dataset, results)``."""
    from .inference import init_detector, resolve_device   # imports us
    if osp.isdir(checkpoint):
        raise ValueError(
            f"{checkpoint} is a directory (a JAX checkpoint?): the port "
            "reads .pth checkpoints only")
    dataset = build_dataset(dict(test_cfg or cfg.data.test, test_mode=True))
    loader = build_dataloader(
        dataset, samples_per_gpu=cfg.data.get("samples_per_gpu", 2),
        shuffle=False, train=False)
    model = init_detector(cfg, checkpoint, device=resolve_device(device),
                          dtype=getattr(torch, cfg.get("compute_dtype",
                                                       "bfloat16")))
    if tta and not {"scales", "flip"} & set(tta):
        tta = dict(tta_cfg_from_pipeline(dataset), **tta)
        print(f"aug-test views: {tta}")
    try:
        results = run_inference(model, loader, max_images=max_images,
                                tta=tta)
    finally:
        loader.close()
    return dataset, results
