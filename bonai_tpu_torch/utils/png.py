"""PNG files without cv2: ``zlib`` and numpy.

:func:`write_png` writes what ``cv2.imwrite`` would for a BGR or gray
image of 8 bits, or a gray image of 16 (RGB or gray, non-interlaced,
filter type 0 on every row); :func:`read_png` returns what
``cv2.imread(path, IMREAD_COLOR)`` (or ``IMREAD_UNCHANGED``) does for an
8- or 16-bit gray, gray+alpha, RGB or RGBA PNG, with any of the five row
filters: ``IMREAD_UNCHANGED`` keeps 16-bit samples as ``uint16``,
``IMREAD_COLOR`` keeps their high byte.
Any other PNG (1-, 2- or 4-bit, palette, interlaced) raises
``NotImplementedError`` (ROADMAP.md item A3c); so does any other file
format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # PNG colour type -> samples


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img, level=1):
    """Write an ``(H, W)`` gray or ``(H, W, 3)`` BGR ``uint8`` image, or an
    ``(H, W)`` gray ``uint16`` one, to ``path`` as a PNG (channels swapped
    to RGB as ``cv2.imwrite`` does)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not ((img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)))
            or (img.dtype == np.uint16 and img.ndim == 2)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8 or "
                         f"(H, W) uint16, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img if img.ndim == 2 else img[..., ::-1]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(rows, rows.dtype.newbyteorder(">"))
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 1:] = rows                                 # filter type 0
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _paeth_row(line, prior, bpp):
    out, prior = bytearray(line.tobytes()), prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line, prior, bpp):
    out, prior = bytearray(line.tobytes()), prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row filters of the decompressed ``raw`` stream."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:                                 # None
            cur = line
        elif kind == 1:                               # Sub: a cumsum per lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                               # Up
            cur = line + prior
        elif kind == 3:                               # Average
            cur = _average_row(line, prior, bpp)
        elif kind == 4:                               # Paeth
            cur = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path, unchanged=False):
    """Read a PNG as an ``(H, W, 3)`` BGR ``uint8`` array, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` does (gray replicated, alpha
    dropped, 16-bit samples cut to their high byte); with ``unchanged``,
    as ``cv2.IMREAD_UNCHANGED`` does: gray ``(H, W)``, RGB as BGR, RGBA
    and gray+alpha as ``(H, W, 4)`` BGRA, in ``uint16`` for a 16-bit PNG.
    Raises ``FileNotFoundError`` for a missing file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise NotImplementedError(
            f"{path}: only PNG files are read without cv2 (ROADMAP.md A3c)")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = header
    if depth not in (8, 16) or color_type not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: PNG bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}; only 8- and 16-bit non-interlaced gray, "
            f"RGB and their alpha forms are read without cv2 (ROADMAP.md "
            f"A3c)")
    nch = _CHANNELS[color_type]
    nbytes = depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * nch * nbytes,
                   nch * nbytes)
    if nbytes == 2:
        px = px.view(">u2")
        px = px.astype(np.uint16) if unchanged else (px >> 8).astype(
            np.uint8)
    px = px.reshape(h, w, nch)
    if unchanged and nch == 1:
        return np.ascontiguousarray(px[..., 0])
    if nch <= 2:                                      # gray (+ alpha)
        px = np.concatenate([np.repeat(px[..., :1], 3, axis=2),
                             px[..., 1:]], axis=2)
    bgr = px[..., 2::-1]                              # RGB(A) -> BGR
    if unchanged and px.shape[2] == 4:
        bgr = np.concatenate([bgr, px[..., 3:]], axis=2)
    return np.ascontiguousarray(bgr)
