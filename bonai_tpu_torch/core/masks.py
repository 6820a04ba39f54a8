"""Mask targets for training, on the device, and the host-side mask paste
and COCO RLE in numpy (counterparts of
``bonai_tpu/core/masks.py::mask_targets_from_instance_masks`` and
``paste_masks_np``, and of the RLE encoder of
``bonai_tpu/datasets/mask_utils.py``, without cv2).

A detection's mask is pasted into its box crop only, and its RLE is built
from that crop: no ``(n, H, W)`` stack of full-image masks is ever made
(2000 detections of a 1024^2 tile would be 2 GB).
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(coords, size):
    """``(P, S)`` fractional mask coordinates -> ``(P, S, size)`` bilinear
    weights, zero outside ``[-1, size]`` (the instance is 0 outside its
    box)."""
    inside = (coords > -1.0) & (coords < size)
    c = coords.clamp(0.0, size - 1.0)
    c0 = torch.floor(c).clamp(0, size - 2)
    frac = (c - c0)[..., None]
    iota = torch.arange(size, dtype=torch.float32, device=coords.device)
    zero = frac.new_tensor(0.0)
    w = (torch.where(iota == c0[..., None], 1.0 - frac, zero)
         + torch.where(iota == c0[..., None] + 1.0, frac, zero))
    return w * inside[..., None]


def mask_targets_from_instance_masks(pos_proposals, matched_gt_bboxes,
                                     matched_inst_masks, mask_size=28):
    """``(P, S, S)`` binary float32 mask targets of positive proposals.

    Args:
      pos_proposals: ``(P, 4)`` proposal boxes (image coordinates).
      matched_gt_bboxes: ``(P, 4)`` their matched GT boxes.
      matched_inst_masks: ``(P, M, M)`` instance-local GT masks, each
        covering its GT box exactly.

    Each target cell is the bilinear sample of the instance mask at the
    cell's centre within the proposal, binarised at 0.5; the sampling is
    two separable interpolation products in float32 (autocast off).

    A GT box sampled as its own proposal puts its cells exactly on the 0.5
    threshold (every coordinate lands half-way between mask pixels), where
    one rounding more or less in the coordinates flips a target.  The
    coordinates are therefore computed as XLA compiles the JAX function:
    the cell centres as ``(i + 0.5) * float32(1 / S)`` and both
    multiply-adds rounded once (in float64, then to float32).
    """
    m = matched_inst_masks.shape[-1]
    dev = pos_proposals.device
    with torch.autocast(dev.type, enabled=False):
        boxes = pos_proposals.float()
        gt = matched_gt_bboxes.float()
        recip = torch.tensor(1.0 / mask_size, dtype=torch.float32,
                             device=dev)
        cell = ((torch.arange(mask_size, dtype=torch.float32, device=dev)
                 + 0.5) * recip).double()

        def fused(a, b, c):              # a * b + c, rounded once
            return (a.double() * b + c).float()

        xs = fused((boxes[:, 2] - boxes[:, 0])[:, None], cell,
                   boxes[:, 0:1].double())
        ys = fused((boxes[:, 3] - boxes[:, 1])[:, None], cell,
                   boxes[:, 1:2].double())
        gw = (gt[:, 2] - gt[:, 0]).clamp(min=1e-6)[:, None]
        gh = (gt[:, 3] - gt[:, 1]).clamp(min=1e-6)[:, None]
        u = fused((xs - gt[:, 0:1]) / gw, float(m), -0.5)
        v = fused((ys - gt[:, 1:2]) / gh, float(m), -0.5)
        rows = torch.bmm(_interp_matrix(v, m),
                         matched_inst_masks.float())           # (P, S, M)
        vals = torch.bmm(rows, _interp_matrix(u, m).transpose(1, 2))
    return (vals >= 0.5).float()


def _axis(n_in, n_out):
    """Source indices and weights of a half-pixel bilinear resize along one
    axis, with the border replicated (cv2 ``INTER_LINEAR``)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), max(n_in - 2, 0))
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_bilinear(img, out_h, out_w):
    """Bilinear resize of an ``(H, W)`` or ``(H, W, C)`` array to
    ``(out_h, out_w)``; float32 result."""
    y0, y1, fy = _axis(img.shape[0], out_h)
    x0, x1, fx = _axis(img.shape[1], out_w)
    img = np.asarray(img, np.float32)
    extra = (None,) * (img.ndim - 2)
    fy = fy[(slice(None), None) + extra]
    fx = fx[(slice(None),) + extra]
    top, bot = img[y0], img[y1]
    top = top[:, x0] * (1.0 - fx) + top[:, x1] * fx
    bot = bot[:, x0] * (1.0 - fx) + bot[:, x1] * fx
    return top * (1.0 - fy) + bot * fy


def counts_to_string(counts):
    """pycocotools ``rleToString``: 6-bit varints, delta-coded from the
    third count on."""
    s = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10))
                        or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(c + 48)
    return s.decode("ascii")


def crop_rle(crop, y0, x0, img_h, img_w):
    """COCO compressed RLE of the ``(img_h, img_w)`` binary mask that is
    zero except for ``crop`` placed at ``(y0, x0)``.  Runs are column-major
    and start with a zero run; only the crop's columns are scanned."""
    ch, cw = crop.shape
    counts = [img_h * img_w]
    if ch and cw:
        strip = np.zeros((img_h, cw), np.uint8)
        strip[y0:y0 + ch] = crop
        flat = strip.reshape(-1, order="F")
        change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
        if flat[0]:
            counts = [0] + counts
        counts[0] += x0 * img_h
        tail = (img_w - x0 - cw) * img_h
        if len(counts) % 2:           # last run is zeros
            counts[-1] += tail
        elif tail:
            counts.append(tail)
    return {"size": [int(img_h), int(img_w)],
            "counts": counts_to_string(counts)}


def paste_mask_rle(mask_prob, box, img_h, img_w, thr=0.5):
    """Paste one ``(S, S)`` mask probability map into its box of an
    ``(img_h, img_w)`` image, threshold it, and return its RLE."""
    x1, y1, x2, y2 = (float(v) for v in box)
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    w, h = max(x2i - x1i, 1), max(y2i - y1i, 1)
    xs, ys = max(x1i, 0), max(y1i, 0)
    xe, ye = min(x2i, img_w), min(y2i, img_h)
    if xe <= xs or ye <= ys:
        return crop_rle(np.zeros((0, 0), np.uint8), 0, 0, img_h, img_w)
    resized = resize_bilinear(mask_prob, h, w)
    crop = resized[ys - y1i:ye - y1i, xs - x1i:xe - x1i] > thr
    return crop_rle(crop.astype(np.uint8), ys, xs, img_h, img_w)
