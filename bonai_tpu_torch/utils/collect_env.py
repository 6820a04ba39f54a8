"""Environment capture (counterpart of ``bonai_tpu/utils/collect_env.py``;
reference: ``mmdet/utils/collect_env.py:15-65``).

The keys are the JAX package's where one has a counterpart: ``sys.platform``,
``Python``, ``Platform``, ``Devices``, ``numpy`` and the package's version;
``PyTorch``, ``CUDA`` (the CUDA version torch was built with), ``NVCC``
and ``GCC`` (the compilers of the kernels and of the mask library) take
the places of ``JAX``, ``jaxlib backend``, ``flax``, ``optax`` and
``cv2``.
"""

from __future__ import annotations

import os.path as osp
import platform
import shutil
import subprocess
import sys

import numpy as np
import torch


def _tool_version(path, line):
    """Line ``line`` of ``<path> --version``, or ``'missing'``."""
    if path is None:
        return "missing"
    try:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    return out[line].strip() if out else "?"


def collect_env():
    """A dict of the facts of this machine and of the port's packages."""
    from ..engine.checkpoint import VERSION
    env = {"sys.platform": sys.platform,
           "Python": sys.version.replace("\n", ""),
           "Platform": platform.platform(),
           "PyTorch": torch.__version__,
           "CUDA": torch.version.cuda or "none"}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    env["Devices"] = (", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                                for i in range(n)) if n else "cpu")
    nvcc = shutil.which("nvcc") or next(
        (p for p in ("/usr/local/cuda/bin/nvcc",) if osp.isfile(p)), None)
    env["NVCC"] = _tool_version(nvcc, -1)
    env["GCC"] = _tool_version(shutil.which("g++"), 0)
    env["numpy"] = np.__version__
    env["bonai_tpu_torch"] = VERSION
    return env


def env_info_str():
    return "\n".join(f"{k}: {v}" for k, v in collect_env().items())
