"""The host's mask library, ``csrc/maskops.cpp``, through ``ctypes``
(counterpart of ``bonai_tpu/native/__init__.py``).

The library is built with the host's ``g++`` at first use into
``build/native/`` at the repository root, under a name that carries a hash
of its source and flags (an edited source builds anew; the rename into
place is atomic, so concurrent first uses agree), with the JAX package's
flags.  A failed build raises with the compiler's output: no caller falls
back to numpy unless it asks for the numpy path itself
(``datasets/mask_utils.py``'s ``native=False``).

Functions: ``rle_encode_counts`` (column-major COCO run lengths of a
mask), ``rle_decode_counts``, ``paste_mask_native`` (bilinear paste of a
square probability map into a box, thresholded), ``fill_poly_native``
(scanline fill, even-odd rule at half-pixel centres) and
``rle_iou_matrix`` (the C ``rle_iou``, the IoU of two masks' run lengths
without decoding them, over every pair of two lists), and the float32
correlation loops of ``utils/filters.py`` (``filter_rows_seq``,
``filter_cols_sym``, ``filter_2d_fma``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "maskops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "rle_encode": (_I, [_P, _I, _I, _P]),
    "rle_decode": (None, [_P, _I, _I, _I, _P]),
    "paste_mask": (None, [_P, _I, _F, _F, _F, _F, _F, _P, _I, _I]),
    "fill_poly": (None, [_P, _I, _P, _I, _I]),
    "rle_iou": (ctypes.c_double, [_P, _I, _P, _I]),
    "rle_iou_matrix": (None, [_P, _P, _I, _P, _P, _I, _P]),
    "filter_rows_seq": (None, [_P, _I, _I, _P, _I, _I, _P, _I]),
    "filter_cols_sym": (None, [_P, _I, _I, _P, _P, _I]),
    "filter_2d_fma": (None, [_P, _I, _I, _I, _P, _I, _P, _P, _P, _I]),
}


def library_path():
    """Path of the shared library built from ``csrc/maskops.cpp``."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmaskops-{digest.hexdigest()[:16]}.so"


def build():
    """Build the library unless it is built; returns its path.  Raises
    ``RuntimeError`` with the compiler's output on a failure."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: bonai_tpu_torch's mask library "
                           "(csrc/maskops.cpp) is built with the host's g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on csrc/maskops.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)       # atomic: concurrent builds agree
    return path


@functools.cache
def library():
    """The ``ctypes`` handle of the library, built if needed, with every
    function's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _counts(counts):
    return np.ascontiguousarray(counts, np.int32)


def rle_encode_counts(mask):
    """Column-major run lengths of an ``(h, w)`` mask, starting with a
    zero run (a list of ints)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    buf = np.empty(h * w + 2, np.int32)
    n = library().rle_encode(mask.ctypes.data, h, w, buf.ctypes.data)
    return buf[:n].tolist()


def rle_decode_counts(counts, h, w):
    """Run lengths -> ``(h, w)`` uint8 mask."""
    c = _counts(counts)
    out = np.empty((h, w), np.uint8)
    library().rle_decode(c.ctypes.data, len(c), h, w, out.ctypes.data)
    return out


def paste_mask_native(prob, box, out, thr=0.5):
    """Paste the ``(s, s)`` probabilities ``prob`` into the box ``[x1, y1,
    x2, y2)`` of the uint8 ``out`` (in place): 1 where the bilinear
    sample exceeds ``thr``."""
    prob = np.ascontiguousarray(prob, np.float32)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint8 (h, w) array")
    h, w = out.shape
    library().paste_mask(prob.ctypes.data, prob.shape[0], float(box[0]),
                         float(box[1]), float(box[2]), float(box[3]),
                         float(thr), out.ctypes.data, h, w)
    return out


def fill_poly_native(poly, h, w):
    """``(h, w)`` uint8 mask of the ``(n, 2)`` polygon ``poly`` (x, y),
    even-odd rule at half-pixel sample centres."""
    poly = np.ascontiguousarray(poly, np.float32).reshape(-1, 2)
    out = np.zeros((h, w), np.uint8)
    library().fill_poly(poly.ctypes.data, len(poly), out.ctypes.data, h, w)
    return out


def _packed(lists):
    flat = _counts(np.concatenate([np.asarray(c, np.int64) for c in lists])
                   if lists else [])
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(c) for c in lists], out=off[1:])
    return flat, off


def rle_iou_matrix(counts_a, counts_b):
    """``(len(counts_a), len(counts_b))`` float64 IoUs of every pair of two
    lists of run lengths (0 for an empty union), in one call."""
    (fa, oa), (fb, ob) = _packed(counts_a), _packed(counts_b)
    out = np.zeros((len(counts_a), len(counts_b)), np.float64)
    if out.size:
        library().rle_iou_matrix(fa.ctypes.data, oa.ctypes.data, len(oa) - 1,
                                 fb.ctypes.data, ob.ctypes.data, len(ob) - 1,
                                 out.ctypes.data)
    return out


def filter_rows_seq(padded, out_w, cn, k):
    """Rows of the ``(rows, in_len)`` float32 ``padded``: ``out[r, x]`` the
    left-to-right fused chain of ``padded[r, x + j * cn] * k[j]``, for
    ``out_w * cn`` outputs a row."""
    padded = np.ascontiguousarray(padded, np.float32)
    k = np.ascontiguousarray(k, np.float32)
    rows, in_len = padded.shape
    out = np.empty((rows, out_w * cn), np.float32)
    library().filter_rows_seq(padded.ctypes.data, rows, in_len,
                              out.ctypes.data, out_w * cn, cn,
                              k.ctypes.data, len(k))
    return out


def filter_cols_sym(padded, k):
    """Columns of the ``(rows + n - 1, len)`` float32 ``padded`` through
    the symmetric ``n``-tap ``k``: centre first, then the fused pairs."""
    padded = np.ascontiguousarray(padded, np.float32)
    k = np.ascontiguousarray(k, np.float32)
    rows = padded.shape[0] - len(k) + 1
    out = np.empty((rows, padded.shape[1]), np.float32)
    library().filter_cols_sym(padded.ctypes.data, rows, padded.shape[1],
                              out.ctypes.data, k.ctypes.data, len(k))
    return out


def filter_2d_fma(padded, rows, out_w, cn, dy, dx, f):
    """``out[y, x]``: the fused chain from 0 over the taps ``(dy, dx, f)``
    of ``padded[y + dy, x + dx * cn]`` (``out_w * cn`` outputs a row)."""
    padded = np.ascontiguousarray(padded, np.float32)
    dy, dx = (np.ascontiguousarray(v, np.int32) for v in (dy, dx))
    f = np.ascontiguousarray(f, np.float32)
    out = np.empty((rows, out_w * cn), np.float32)
    library().filter_2d_fma(padded.ctypes.data, rows, padded.shape[1],
                            out_w * cn, out.ctypes.data, cn, dy.ctypes.data,
                            dx.ctypes.data, f.ctypes.data, len(f))
    return out
