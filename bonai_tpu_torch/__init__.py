"""bonai_tpu_torch: the PyTorch + CUDA port of bonai_tpu for NVIDIA Hopper.

It reads the same ``configs/`` tree, keeps the JAX package's public
layouts and loads mmdet v2.3 weights.  It imports nothing of
``bonai_tpu``; the JAX package is the reference its tests hold it to.
"""

from .config import Config

__all__ = ["Config"]
