"""Builds the port's CUDA sources (``bonai_tpu_torch/csrc/*.cu``) into
plain-C shared libraries with ``nvcc`` and loads them with ``ctypes``.

Each library is built at first use from the repository's sources alone,
into ``build/kernels/`` at the repository root, under a name that carries
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags
(an edited source or header builds anew).  The
``-Xptxas=-v`` report (registers, shared memory, spills) is kept beside
the library as ``<name>.ptxas.txt``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.isfile("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "bonai_tpu_torch are built on a machine with "
                           "the CUDA toolkit")
    return path


def library_path(name):
    """Path of the shared library built from ``csrc/<name>.cu``."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names):
    """Build every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: path}``; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, paths[name])    # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.cache
def load_library(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build([name])[name]))
