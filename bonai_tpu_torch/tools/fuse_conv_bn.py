"""Fold frozen BatchNorm statistics for inference (counterpart of
``tools/fuse_conv_bn.py``).

    python -m bonai_tpu_torch.tools.fuse_conv_bn IN.pth OUT.pth

Every BatchNorm of the checkpoint's ``state_dict`` (the keys with
``running_mean`` and ``running_var``) gets the JAX tool's ``fuse_tree``:
``inv = weight / sqrt(running_var + eps)``, ``weight' = inv * sqrt(1 +
eps)``, ``bias' = bias - running_mean * inv``, the statistics set to 0
and 1.  The model then computes what it computed, with its BatchNorms over
identity statistics; the convolutions keep their weights (the port's convs
have no bias, as the JAX package's), so the keys and shapes are unchanged.
GroupNorms and LayerNorms hold no statistics and are left alone.
"""

from __future__ import annotations

import argparse
import math

import torch


def fuse_state_dict(state_dict, eps=1e-5):
    """A copy of ``state_dict`` with every BatchNorm folded, in the JAX
    tool's float operations, so that the results are numpy's to the bit:
    float32 throughout, with numpy's correctly rounded square root (taken
    in float64 and rounded: PyTorch's float32 ``sqrt`` on the CPU can be an
    ulp off), but for ``inv * sqrt(1 + eps)``, which numpy takes in float64
    (a float32 array times a float64 scalar) and rounds to float32."""
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        base = key[:-len("running_mean")]
        if base + "running_var" not in state_dict:
            continue
        weight = state_dict[base + "weight"]
        scale = weight.float()
        bias = state_dict[base + "bias"].float()
        mean = state_dict[base + "running_mean"].float()
        var = state_dict[base + "running_var"].float()
        inv = scale / torch.sqrt((var + eps).double()).float()
        out[base + "weight"] = (inv.double() * math.sqrt(1.0 + eps)).to(
            weight.dtype)
        out[base + "bias"] = (bias - mean * inv).to(weight.dtype)
        out[base + "running_mean"] = torch.zeros_like(
            state_dict[base + "running_mean"])
        out[base + "running_var"] = torch.ones_like(
            state_dict[base + "running_var"])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fold BatchNorm statistics")
    parser.add_argument("in_file", help="a .pth with a state_dict")
    parser.add_argument("out_file")
    args = parser.parse_args(argv)
    ckpt = torch.load(args.in_file, map_location="cpu", weights_only=True)
    ckpt["state_dict"] = fuse_state_dict(ckpt["state_dict"])
    torch.save(ckpt, args.out_file)
    print(f"fused checkpoint written to {args.out_file}")


if __name__ == "__main__":
    main()
