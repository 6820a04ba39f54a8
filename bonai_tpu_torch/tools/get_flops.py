"""Count a detector's parameters and FLOPs (counterpart of
``tools/get_flops.py``; reference: mmdetection's tool over
``forward_dummy``).

    python -m bonai_tpu_torch.tools.get_flops CONFIG [--shape H [W]] \\
        [--device cpu]

Builds the config's detector with seeded random weights on the card (or
``--device``) and prints the input shape, the parameters (the sum of the
numel of ``model.parameters()``, which equals the JAX package's count of
``variables['params']``) and the FLOPs of one ``forward_dummy`` at
``--shape`` (1024^2 by default), counted by
``torch.utils.flop_counter.FlopCounterMode``: convolutions and matrix
products, two FLOPs a multiply-add.  The JAX tool prints XLA's cost
analysis, which counts every operation, so the two FLOP counts differ and
carry different labels.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..apis.inference import init_detector, resolve_device

LABEL = ("FLOPs (forward_dummy, torch.utils.flop_counter: convolutions and "
         "matrix products)")


def count_params(model):
    return sum(p.numel() for p in model.parameters())


def count_flops(model, shape):
    """FLOPs of ``model.forward_dummy`` on one ``(1, H, W, 3)`` zero image
    in the model's dtype, on its device."""
    p = next(model.parameters())
    img = torch.zeros((1, *shape, 3), dtype=p.dtype, device=p.device)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward_dummy(img)
    return counter.get_total_flops()


def get_flops(config, shape=(1024, 1024), device=None):
    """``(params, flops, lines)``: the counts and the three lines the CLI
    prints.  The model is float32 on the CPU, bfloat16 on the card."""
    device = resolve_device(device)
    model = init_detector(config, device=device, dtype=torch.float32
                          if device.type == "cpu" else None)
    h, w = (list(shape) * 2)[:2]
    n_params = count_params(model)
    flops = count_flops(model, (h, w))
    lines = [f"Input shape: (1, {h}, {w}, 3)",
             f"Params: {n_params / 1e6:.2f} M",
             f"{LABEL}: {flops / 1e9:.2f} G"]
    return n_params, flops, lines


def main(argv=None):
    parser = argparse.ArgumentParser(description="Count params and FLOPs")
    parser.add_argument("config")
    parser.add_argument("--shape", type=int, nargs="+", default=[1024, 1024])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args(argv)
    for line in get_flops(args.config, args.shape, args.device)[2]:
        print(line)


if __name__ == "__main__":
    main()
