"""The inference loop over a test loader, and padded device outputs ->
per-image results in the reference layout (counterparts of
``bonai_tpu/apis/test.py::run_inference`` and ``results_to_host``)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.masks import paste_mask_rle


def results_to_host(device_out, metas, num_classes=1, mask_thr=0.5,
                    with_offset=True):
    """Convert one batch of ``simple_test`` outputs to per-image tuples
    ``(bbox_results, segm_results[, offsets])``: ``bbox_results`` is a
    per-class list of ``(n, 5)`` float32 arrays, ``segm_results`` per-class
    lists of COCO RLE dicts (masks pasted into the original image of
    ``metas[i]['ori_shape']``), ``offsets`` an ``(n, 2)`` float32 array."""
    host = {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in device_out.items()}
    boxes, scores = host["det_bboxes"], host["det_scores"]
    labels, valid = host["det_labels"], host["det_valid"].astype(bool)
    masks = host.get("mask_probs")
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
            out.append([[paste_mask_rle(m, b, oh, ow, mask_thr)
                         for m, b in zip(mp[lb == c], bx[lb == c])]
                        for c in range(num_classes)])
        if with_offset and offsets is not None:
            out.append(offsets[i][v].astype(np.float32))
        results.append(tuple(out) if len(out) > 1 else bbox_results)
    return results


def run_inference(model, loader, max_images=None, with_offset=True,
                  progress=True, tta=None, mesh=None):
    """Run ``model.simple_test`` over the batches of a test loader (the
    port's ``build_dataloader(..., train=False, shuffle=False)``) on the
    model's device; returns the flat list of :func:`results_to_host`
    results in dataset order (reference ``single_gpu_test``), without the
    duplicates that wrap-pad the last batch and cut to ``max_images``."""
    if tta:
        raise NotImplementedError(
            "test-time augmentation is ROADMAP.md item A5")
    if mesh is not None:
        raise NotImplementedError(
            "inference over several devices is ROADMAP.md item A2b")
    device = next(model.parameters()).device
    results = []
    seen = 0
    with torch.inference_mode():
        for batch, metas in loader:
            img, shp, sf = (torch.as_tensor(batch[k]).to(device)
                            for k in ("image", "img_shape", "scale_factor"))
            out = model.simple_test(img, shp, sf)
            results.extend(results_to_host(out, metas,
                                           with_offset=with_offset))
            seen += img.shape[0]
            if progress:
                print(f"\r{seen} images", end="", flush=True)
            if max_images is not None and seen >= max_images:
                break
    if progress:
        print()
    total = len(loader.dataset)
    if max_images is not None:
        total = min(total, max_images)
    return results[:total]
