"""Strip a training checkpoint for release (counterpart of
``tools/publish_model.py``; reference: mmdetection's tool).

    python -m bonai_tpu_torch.tools.publish_model IN.pth OUT_PREFIX

Keeps the ``state_dict``, ``meta`` and ``step`` of the train CLI's
``.pth`` (``engine/checkpoint.py``) and drops the optimizer and the
samplers' generators, then renames the file to
``OUT_PREFIX-<hash>.pth``, the hash being the first 8 hex digits of the
written file's sha256, as mmdetection's tool does (the JAX tool hashes
orbax leaves, which a ``.pth`` does not have).  ``init_detector`` and the
test CLIs load the published file as they load the checkpoint.
"""

from __future__ import annotations

import argparse
import hashlib
import os

import torch

KEPT = ("meta", "state_dict", "step")


def publish_model(in_file, out_prefix):
    """Write the published checkpoint; returns its path."""
    ckpt = torch.load(in_file, map_location="cpu", weights_only=True)
    tmp = f"{out_prefix}.{os.getpid()}.tmp"
    torch.save({k: ckpt[k] for k in KEPT if k in ckpt}, tmp)
    digest = hashlib.sha256()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    out = f"{out_prefix}-{digest.hexdigest()[:8]}.pth"
    os.replace(tmp, out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Publish a checkpoint")
    parser.add_argument("in_file", help="the train CLI's .pth")
    parser.add_argument("out_prefix", help="output path without .pth")
    args = parser.parse_args(argv)
    print(f"published {publish_model(args.in_file, args.out_prefix)}")


if __name__ == "__main__":
    main()
