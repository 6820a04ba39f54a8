"""Export a detector's ``simple_test`` with ``torch.export`` (counterpart
of ``tools/export_model.py``, which writes StableHLO).

    python -m bonai_tpu_torch.tools.export_model CONFIG CKPT OUT_PREFIX \\
        [--size 1024] [--batch 1] [--device cpu]

Builds the config's detector in its ``compute_dtype`` (bfloat16 by
default) on the card (or ``--device``) with the weights of ``CKPT`` (a
``.pth``; ``none`` or ``-`` keeps seeded random weights), and exports a
module whose ``forward(img)``, on ``(batch, size, size, 3)`` float32
normalised images, returns ``simple_test(img, full((B, 2), size),
ones(B))``: the dict of padded, fixed-shape outputs.  It writes
``OUT_PREFIX.pt2`` with ``torch.export.save``; the weights travel in the
file.

The graph holds the port's custom ops: the RoIAlign forward
(``bonai_tpu_torch::roi_align_levels``, which launches the hand-written
kernel on the card; the CPU export holds the plain RoIAlign instead),
``bonai_tpu_torch::nms`` and ``bonai_tpu_torch::soft_nms``.

Reload (in any process that can import ``bonai_tpu_torch``, which
registers the ops):

    from bonai_tpu_torch.tools.export_model import load_exported
    run = load_exported("model.pt2")
    out = run(images)
"""

from __future__ import annotations

import argparse
import time

import torch
from torch import nn

from ..apis.inference import init_detector, resolve_device
from ..config import Config


class SimpleTest(nn.Module):
    """``forward(img)`` = ``model.simple_test(img, full((B, 2), size),
    ones(B))``: square ``size``^2 images at scale 1."""

    def __init__(self, model, size):
        super().__init__()
        self.model = model
        self.size = float(size)

    def forward(self, img):
        b = img.shape[0]
        return self.model.simple_test(
            img, torch.full((b, 2), self.size, device=img.device),
            torch.ones(b, device=img.device))


def export_detector(model, size=1024, batch=1):
    """``torch.export.export`` of :class:`SimpleTest` around ``model`` on
    a ``(batch, size, size, 3)`` float32 image on the model's device."""
    device = next(model.parameters()).device
    img = torch.zeros((batch, size, size, 3), device=device)
    return torch.export.export(SimpleTest(model, size).eval(), (img,),
                               strict=False)


def load_exported(path):
    """The callable program of an exported ``.pt2`` (its ``module()``),
    after registering the port's custom ops its graph calls."""
    from .. import ops  # noqa: F401  (registers the RoIAlign ops)
    from ..core import nms  # noqa: F401  (and the NMS ops)
    return torch.export.load(path).module()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export simple_test")
    parser.add_argument("config")
    parser.add_argument("checkpoint", help="a .pth, or none / -")
    parser.add_argument("out_prefix")
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    ckpt = None if args.checkpoint in ("none", "-") else args.checkpoint
    model = init_detector(cfg, ckpt, device=resolve_device(args.device),
                          dtype=getattr(torch, cfg.get("compute_dtype",
                                                       "bfloat16")))
    t0 = time.perf_counter()
    program = export_detector(model, args.size, args.batch)
    path = args.out_prefix + ".pt2"
    torch.export.save(program, path)
    print(f"wrote {path} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
