"""Baseline JPEG without cv2: numpy, bit for bit as libjpeg-turbo 3.1.

:func:`read_jpeg` returns what ``cv2.imread(path, IMREAD_COLOR)`` (or
``cv2.imdecode``) gives for a baseline Huffman-coded 8-bit JPEG, gray or
YCbCr, with 4:4:4, 4:2:2 (h2v1), 4:4:0 (h1v2) or 4:2:0 (h2v2) chroma,
restart markers and partial MCUs.  :func:`encode_jpeg` returns the bytes
of ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, q])`` (4:2:0
chroma, or gray, and no restart markers, as cv2 writes by default), and
:func:`jpeg_round_trip` is ``read_jpeg(encode_jpeg(img, q))`` without the
entropy coding.

The parts of libjpeg-turbo reproduced:

- encoding: the standard tables scaled by quality (``jcparam.c``), the
  fixed-point RGB -> YCbCr tables (``jccolor.c``), edge replication to
  whole blocks and MCUs with the DC-only dummy blocks (``jcprepct.c``,
  ``jccoefct.c``), the h2v2 downsampler with its alternating bias
  (``jcsample.c``), the accurate integer forward DCT (``jfdctint.c``) and
  the reciprocal quantiser (``jcdctmgr.c``), the standard Huffman tables
  and JFIF/DQT/SOF0/DHT/SOS markers (``jcmarker.c``);
- decoding: the accurate integer inverse DCT (``jidctint.c``, clamped as
  its SIMD version clamps), the "fancy" triangle upsamplers
  (``jdsample.c``) and the fixed-point YCbCr -> BGR tables
  (``jdcolor.c``).

Progressive, arithmetic-coded, lossless, 12-bit and CMYK files raise
``NotImplementedError`` naming what is missing, as does a file whose EXIF
orientation is not 1 (``cv2.imread`` would rotate it).

The Huffman decoder is Python over a 16-bit lookup table (about a
microsecond a symbol); everything else is vectorised numpy.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

# zigzag position -> natural (row-major) index
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, (n // 8) if (n // 8 + n % 8) % 2 else -(n // 8))))

# the standard quantisation tables (ITU T.81 K.1), natural order
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99], np.int64),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32, np.int64))

# the standard Huffman tables (K.3): 16 code counts, then the symbols
_STD_HUFF = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000"
                          "000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107"
        "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
        "292a3435363738393a434445464748494a535455565758595a63646566676869"
        "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
        "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000"
                          "000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "0002010204040304070504040001027700010203110405213106124151076171"
        "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
        "2728292a35363738393a434445464748494a535455565758595a636465666768"
        "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
        "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}

_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def quant_tables(quality):
    """The luma and chroma tables (natural order) of
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT)


def _huff_codes(spec):
    """JPEG canonical Huffman codes: ``{symbol: (code, length)}``."""
    counts, symbols = spec[:16], spec[16:]
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _huff_lut(spec):
    """A 65536-entry list: the next 16 bits -> ``length << 8 | symbol``
    (0 where no code starts)."""
    lut = np.zeros(1 << 16, np.int64)
    for sym, (code, length) in _huff_codes(spec).items():
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return lut.tolist()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# DCTs (``jfdctint.c``, ``jidctint.c``), over (..., 8, 8) int64 blocks
# ---------------------------------------------------------------------------

def _fdct_pass(d, axis, last):
    d = np.moveaxis(d, axis, -1)
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = np.empty_like(d)
    n = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    if last:
        out[..., 0] = _descale(t10 + t11, _PASS1_BITS)
        out[..., 4] = _descale(t10 - t11, _PASS1_BITS)
    else:
        out[..., 0] = (t10 + t11) << _PASS1_BITS
        out[..., 4] = (t10 - t11) << _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    out[..., 2] = _descale(z1 + t13 * _F0765, n)
    out[..., 6] = _descale(z1 - t12 * _F1847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[..., 7] = _descale(t4 + z1 + z3, n)
    out[..., 5] = _descale(t5 + z2 + z4, n)
    out[..., 3] = _descale(t6 + z2 + z3, n)
    out[..., 1] = _descale(t7 + z1 + z4, n)
    return np.moveaxis(out, -1, axis)


def fdct_islow(blocks):
    """``jpeg_fdct_islow`` of level-shifted samples: rows, then columns
    (outputs scaled by 8)."""
    return _fdct_pass(_fdct_pass(np.asarray(blocks, np.int64), -1, False),
                      -2, True)


def _idct_pass(d, axis, last):
    d = np.moveaxis(d, axis, -1)
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    t2 = z1 - z3 * _F1847
    t3 = z1 + z2 * _F0765
    t0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    t1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    n = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    out = np.empty_like(d)
    out[..., 0], out[..., 7] = _descale(t10 + t3, n), _descale(t10 - t3, n)
    out[..., 1], out[..., 6] = _descale(t11 + t2, n), _descale(t11 - t2, n)
    out[..., 2], out[..., 5] = _descale(t12 + t1, n), _descale(t12 - t1, n)
    out[..., 3], out[..., 4] = _descale(t13 + t0, n), _descale(t13 - t0, n)
    return np.moveaxis(out, -1, axis)


def idct_islow(coefs):
    """``jpeg_idct_islow`` of dequantised ``(..., 8, 8)`` coefficients:
    columns, then rows, level shift and clamp to ``uint8``."""
    d = _idct_pass(_idct_pass(np.asarray(coefs, np.int64), -2, False),
                   -1, True)
    return np.clip(d + 128, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# colour conversion (``jccolor.c``, ``jdcolor.c``)
# ---------------------------------------------------------------------------

def _fix(x):
    return int(x * 65536 + 0.5)


def bgr_to_ycc(img):
    """BGR ``uint8`` -> three ``int64`` planes Y, Cb, Cr."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + (128 << 16) + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + (128 << 16) + half - 1) >> 16
    return y, cb, cr


def ycc_to_bgr(y, cb, cr):
    """Three planes -> BGR ``uint8``, by ``jdcolor.c``'s tables."""
    y, cb, cr = (np.asarray(p, np.int64) for p in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# resampling (``jcsample.c``, ``jdsample.c``)
# ---------------------------------------------------------------------------

def _pad_edge(p, h, w):
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _downsample(p, factor, out_w):
    """``p`` (already edge-expanded to whole sampling groups) -> its
    ``factor`` 1 or 2 downsampled plane, ``out_w`` wide, with
    ``jcsample.c``'s alternating h2v2 bias."""
    if factor == 1:
        return p
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_w) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _upsample(p, hs, vs):
    """``jdsample.c``'s upsampling of a ``(h, w)`` component plane by
    ``(hs, vs)``: the triangle filters for 2x1, 1x2 and 2x2 (plain
    replication where the plane is at most 2 samples wide)."""
    p = np.asarray(p, np.int64)
    h, w = p.shape
    if (hs, vs) == (1, 1):
        return p
    if (hs, vs) not in ((2, 1), (1, 2), (2, 2)):
        raise NotImplementedError(f"JPEG chroma upsampling {hs}x{vs}")
    if hs == 2 and w <= 2:
        out = np.repeat(p, 2, axis=1)
        return np.repeat(out, vs, axis=0) if vs == 2 else out
    if (hs, vs) == (1, 2):
        up = np.concatenate([p[:1], p[:-1]])
        down = np.concatenate([p[1:], p[-1:]])
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if vs == 2:
        up = np.concatenate([p[:1], p[:-1]])
        down = np.concatenate([p[1:], p[-1:]])
        rows = np.empty((2 * h, w), np.int64)
        rows[0::2] = 3 * p + up
        rows[1::2] = 3 * p + down
        left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        out = np.empty((2 * h, 2 * w), np.int64)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
        out[:, 0] = (4 * rows[:, 0] + 8) >> 4
        out[:, -1] = (4 * rows[:, -1] + 7) >> 4
        return out
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((h, 2 * w), np.int64)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    out[:, 0] = p[:, 0]
    out[:, -1] = p[:, -1]
    return out


# ---------------------------------------------------------------------------
# the frame geometry shared by both directions
# ---------------------------------------------------------------------------

class _Frame:
    """Component sizes, block grids and MCU layout of a frame (``comps``:
    ``(id, h, v, quant_table)`` each)."""

    def __init__(self, height, width, comps):
        self.height, self.width, self.comps = height, width, comps
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))

    def comp_size(self, ci):
        _, h, v, _ = self.comps[ci]
        return (-(-self.height * v // self.vmax),
                -(-self.width * h // self.hmax))

    def blocks(self, ci):
        """Real blocks ``(rows, cols)`` of component ``ci``."""
        ch, cw = self.comp_size(ci)
        return -(-ch // 8), -(-cw // 8)

    def padded_blocks(self, ci):
        """Blocks of the interleaved MCU grid (dummy blocks included)."""
        _, h, v, _ = self.comps[ci]
        return self.mcuy * v, self.mcux * h


def _mcu_block_order(frame, cis):
    """For an interleaved scan over components ``cis``: per block in MCU
    order, its component and its (row, col) in that component's padded
    grid."""
    my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux),
                         indexing="ij")
    my, mx = my.reshape(-1), mx.reshape(-1)
    parts = []
    for ci in cis:
        _, h, v, _ = frame.comps[ci]
        for by in range(v):
            for bx in range(h):
                parts.append((ci, my * v + by, mx * h + bx))
    n = len(my)
    comp = np.stack([np.full(n, p[0]) for p in parts], 1).reshape(-1)
    rows = np.stack([p[1] for p in parts], 1).reshape(-1)
    cols = np.stack([p[2] for p in parts], 1).reshape(-1)
    return comp, rows, cols, len(parts)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _encode_coefficients(img, quality):
    """BGR or gray ``uint8`` -> ``(frame, [quantised (bh, bw, 64)
    natural-order coefficients per component], quant tables)``; each
    component's grid is the padded MCU grid, its dummy blocks DC-only."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    height, width = img.shape[:2]
    tables = quant_tables(quality)
    if img.ndim == 2:
        planes = [img.astype(np.int64)]
        comps = [(1, 1, 1, 0)]
    else:
        planes = list(bgr_to_ycc(img))
        comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    frame = _Frame(height, width, comps)
    coefs = []
    for ci, plane in enumerate(planes):
        _, h, v, tq = comps[ci]
        factor = frame.hmax // h                # 2 for 4:2:0 chroma, else 1
        bh, bw = frame.blocks(ci)
        ph, pw = frame.padded_blocks(ci)
        # rows padded to the sampling group, columns to whole blocks
        # (jcprepct.c, jcsample.c), then the downsampled rows to blocks
        full = _pad_edge(plane, -(-height // frame.vmax) * frame.vmax,
                         bw * 8 * factor)
        ds = _downsample(full, factor, bw * 8)
        ds = _pad_edge(ds, bh * 8, bw * 8)
        blocks = (ds - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        c = _quantise(fdct_islow(blocks).reshape(bh, bw, 64), tables[tq])
        out = np.zeros((ph, pw, 64), np.int64)
        out[:bh, :bw] = c
        if len(comps) > 1:
            _dummy_dcs(out, bh, bw, h, v)
        coefs.append(out)
    return frame, coefs, tables


def _quantise(c, table):
    """``jcdctmgr.c``'s quantiser: the reciprocal of ``8 * q`` with its
    correction, applied to ``|c|``, sign restored."""
    recip, corr, shift = _reciprocals(tuple(int(q) * 8 for q in table))
    a = np.abs(c)
    q = ((a + corr) * recip) >> (shift + 16)
    return np.where(c < 0, -q, q)


def _reciprocals(divisors):
    recip, corr, shift = [], [], []
    for d in divisors:
        if d == 1:
            recip.append(1), corr.append(0), shift.append(-16)
            continue
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq), corr.append(c), shift.append(r - 16)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def _dummy_dcs(out, bh, bw, h, v):
    """``jccoefct.c``'s dummy blocks of the last MCU column and row: zero
    AC, the DC of the block before them in the MCU."""
    ph, pw = out.shape[:2]
    for x in range(bw, pw):                     # right edge, real rows
        if x % h:
            out[:bh, x, 0] = out[:bh, x - 1, 0]
    for y in range(bh, ph):                     # bottom rows of the MCU
        for mx in range(pw // h):
            out[y, mx * h:(mx + 1) * h, 0] = out[y - 1, mx * h + h - 1, 0]


def _bit_length(a):
    return np.searchsorted(1 << np.arange(16), a, side="right")


def _scan_symbols(frame, coefs):
    """The scan's entropy-coded data: the Huffman-coded bytes (stuffed,
    padded with ones)."""
    ncomp = len(frame.comps)
    if ncomp == 1:
        bh, bw = frame.blocks(0)
        blocks = coefs[0][:bh, :bw].reshape(-1, 64)
        comp = np.zeros(len(blocks), np.int64)
    else:
        comp, rows, cols, _ = _mcu_block_order(frame, range(ncomp))
        blocks = np.empty((len(comp), 64), np.int64)
        for ci in range(ncomp):
            sel = comp == ci
            blocks[sel] = coefs[ci][rows[sel], cols[sel]]
    zz = blocks[:, ZIGZAG]
    nblk = len(zz)
    # DC differences, each component predicted from its previous block
    dc = zz[:, 0]
    prev = np.zeros(nblk, np.int64)
    for ci in range(ncomp):
        idx = np.nonzero(comp == ci)[0]
        prev[idx] = np.concatenate([[0], dc[idx[:-1]]])
    tables = {k: _huff_codes(v) for k, v in _STD_HUFF.items()}

    def lut(kind, tbl):
        codes = tables[(kind, tbl)]
        code = np.zeros(256, np.int64)
        size = np.zeros(256, np.int64)
        for s, (c, n) in codes.items():
            code[s], size[s] = c, n
        return code, size

    tsel = np.minimum(comp, 1)                  # luma table 0, chroma 1
    dcc = [lut(0, t) for t in (0, 1)]
    acc = [lut(1, t) for t in (0, 1)]
    # items: (block, key, huffman code, its size, extra bits, their size)
    keys, hcode, hsize, xbits, xsize, iblk = [], [], [], [], [], []

    def add(b, key, codes, sym, val, nbits):
        keys.append(b * 1024 + key)
        iblk.append(b)
        hcode.append(np.choose(tsel[b], [codes[0][0][sym], codes[1][0][sym]]))
        hsize.append(np.choose(tsel[b], [codes[0][1][sym], codes[1][1][sym]]))
        xbits.append(val)
        xsize.append(nbits)

    b = np.arange(nblk)
    diff = dc - prev
    nb = _bit_length(np.abs(diff))
    add(b, np.zeros(nblk, np.int64), dcc, nb,
        np.where(diff < 0, diff + (1 << nb) - 1, diff), nb)
    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)
    ki = ki + 1
    v = ac[bi, ki - 1]
    start = np.concatenate([[True], bi[1:] != bi[:-1]]) if len(bi) else \
        np.zeros(0, bool)
    prevk = np.where(start, 0, np.concatenate([[0], ki[:-1]]))
    run = ki - prevk - 1
    nzrl = run // 16
    for j in range(3):                          # ZRL codes (0xF0)
        sel = nzrl > j
        add(bi[sel], ki[sel] * 4 + j, acc, np.full(sel.sum(), 0xF0),
            np.zeros(sel.sum(), np.int64), np.zeros(sel.sum(), np.int64))
    nb = _bit_length(np.abs(v))
    add(bi, ki * 4 + 3, acc, (run % 16) * 16 + nb,
        np.where(v < 0, v + (1 << nb) - 1, v), nb)
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, bi, ki)
    eob = np.nonzero(last < 63)[0]
    add(eob, np.full(len(eob), 1023), acc, np.zeros(len(eob), np.int64),
        np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64))
    order = np.argsort(np.concatenate(keys), kind="stable")
    code = np.stack([np.concatenate(hcode)[order],
                     np.concatenate(xbits)[order]], 1).reshape(-1)
    size = np.stack([np.concatenate(hsize)[order],
                     np.concatenate(xsize)[order]], 1).reshape(-1)
    return _pack_bits(code, size)


def _pack_bits(code, size):
    """Concatenate ``size[i]``-bit codes, pad with 1-bits to a byte, stuff
    a 0 after each 0xFF."""
    code, size = np.asarray(code, np.int64), np.asarray(size, np.int64)
    keep = size > 0
    code, size = code[keep], size[keep]
    bits = ((code[:, None] >> np.arange(15, -1, -1)[None]) & 1).astype(
        np.uint8)
    mask = np.arange(16)[None] >= (16 - size[:, None])
    stream = bits[mask]
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    return np.packbits(stream).tobytes().replace(b"\xff", b"\xff\x00")


def _marker(kind, body):
    return struct.pack(">BBH", 0xFF, kind, len(body) + 2) + body


def encode_jpeg(img, quality=95):
    """``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, quality])`` of a
    BGR ``(H, W, 3)`` or gray ``(H, W)`` ``uint8`` image: baseline, the
    standard Huffman tables, 4:2:0 chroma, no restart markers."""
    frame, coefs, tables = _encode_coefficients(img, quality)
    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    ntab = 1 if len(frame.comps) == 1 else 2
    for t in range(ntab):
        out.append(_marker(0xDB, bytes([t]) + bytes(
            tables[t][ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, frame.height, frame.width,
                      len(frame.comps))
    for cid, h, v, tq in frame.comps:
        sof += bytes([cid, (h << 4) | v, tq])
    out.append(_marker(0xC0, sof))
    for t in range(ntab):
        for kind in (0, 1):
            out.append(_marker(0xC4, bytes([kind << 4 | t])
                               + _STD_HUFF[(kind, t)]))
    sos = bytes([len(frame.comps)])
    for cid, _, _, tq in frame.comps:
        sos += bytes([cid, (tq << 4) | tq])
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    out.append(_scan_symbols(frame, coefs))
    out.append(b"\xff\xd9")
    return b"".join(out)


def jpeg_round_trip(img, quality=95):
    """``read_jpeg(encode_jpeg(img, quality))`` without the entropy
    coding, which is lossless."""
    frame, coefs, tables = _encode_coefficients(img, quality)
    qt = {0: tables[0]}
    if len(tables) > 1:
        qt[1] = tables[1]
    return _reconstruct(frame, coefs, qt)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _reconstruct(frame, coefs, qtabs):
    """Quantised natural-order coefficients -> BGR ``uint8`` image."""
    planes = []
    for ci, (_, h, v, tq) in enumerate(frame.comps):
        c = coefs[ci]
        ph, pw = c.shape[:2]
        pix = idct_islow((c * qtabs[tq]).reshape(ph, pw, 8, 8))
        pix = pix.transpose(0, 2, 1, 3).reshape(ph * 8, pw * 8)
        ch, cw = frame.comp_size(ci)
        up = _upsample(pix[:ch, :cw], frame.hmax // h, frame.vmax // v)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    return ycc_to_bgr(*planes)


def _exif_orientation(body):
    """The orientation tag (0x0112) of an APP1 Exif body, else 1."""
    if body[:6] != b"Exif\x00\x00":
        return 1
    tiff = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None or len(tiff) < 8:
        return 1
    off = struct.unpack(end + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return 1
    n = struct.unpack(end + "H", tiff[off:off + 2])[0]
    for i in range(n):
        e = tiff[off + 2 + 12 * i:off + 14 + 12 * i]
        if len(e) < 12:
            break
        tag, typ = struct.unpack(end + "HH", e[:4])
        if tag == 0x0112:
            return struct.unpack(end + "H", e[8:10])[0] if typ == 3 else 1
    return 1


def _entropy_segments(data, pos):
    """The scan's data from ``pos``: its restart segments, unstuffed, and
    the position of the marker that ends it."""
    segs, start, i, n = [], pos, pos, len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG scan runs past the end of the data")
        m = data[i + 1]
        if m == 0x00 or m == 0xFF:
            i += 1 if m == 0xFF else 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = i = i + 2
            continue
        return segs, i


def _decode_scan(segs, frame, scomps, coefs, dc_luts, ac_luts, interval):
    """Huffman-decode one baseline scan into ``coefs`` (per component
    ``(bh, bw, 64)`` zigzag order)."""
    if len(scomps) == 1:
        ci = scomps[0][0]
        bh, bw = frame.blocks(ci)
        pw = coefs[ci].shape[1]
        flat = (np.arange(bh)[:, None] * pw + np.arange(bw)[None]).reshape(-1)
        bcomp = [ci] * len(flat)
        bflat = flat.tolist()
        per_mcu = 1
    else:
        comp, rows, cols, per_mcu = _mcu_block_order(
            frame, [s[0] for s in scomps])
        bcomp = comp.tolist()
        bflat = (rows * np.array([coefs[c].shape[1] for c in
                                  range(len(coefs))])[comp] + cols).tolist()
    tabs = {ci: (dc_luts[td], ac_luts[ta]) for ci, td, ta in scomps}
    n_mcu = len(bflat) // per_mcu
    mcus_per_seg = interval or n_mcu
    out = {ci: ([], []) for ci, _, _ in scomps}
    blk = 0
    for sidx in range(-(-n_mcu // mcus_per_seg)):
        data = segs[sidx] if sidx < len(segs) else b""
        raw = np.frombuffer(data + b"\x00" * 8, np.uint8).astype(np.int64)
        win = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8)
               | raw[3:]).tolist()
        p = 0
        pred = {ci: 0 for ci, _, _ in scomps}
        nblk = min(mcus_per_seg, n_mcu - sidx * mcus_per_seg) * per_mcu
        for _ in range(nblk):
            ci = bcomp[blk]
            base = bflat[blk] * 64
            blk += 1
            dlut, alut = tabs[ci]
            pos_list, val_list = out[ci]
            e = dlut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            p += e >> 8
            s = e & 0xFF
            if s:
                r = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if r < (1 << (s - 1)):
                    r -= (1 << s) - 1
                pred[ci] += r
            pos_list.append(base)
            val_list.append(pred[ci])
            k = 1
            while k < 64:
                e = alut[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                p += e >> 8
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    r = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if r < (1 << (s - 1)):
                        r -= (1 << s) - 1
                    pos_list.append(base + k)
                    val_list.append(r)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
    for ci, (pos, val) in out.items():
        flat = coefs[ci].reshape(-1)
        flat[np.asarray(pos, np.int64)] = np.asarray(val, np.int64)


def read_jpeg(src):
    """A baseline JPEG (a path or its bytes) as ``(H, W, 3)`` BGR
    ``uint8``, as ``cv2.imread(path, IMREAD_COLOR)`` / ``cv2.imdecode``
    return it (gray replicated).  Raises ``FileNotFoundError`` for a
    missing file and ``NotImplementedError`` for what is not decoded."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data, name = bytes(src), "JPEG data"
    else:
        with open(src, "rb") as f:
            data = f.read()
        name = str(src)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qtabs, dc_luts, ac_luts = {}, {}, {}
    frame, coefs, interval, adobe_rgb = None, None, 0, False
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF or m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if m == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                width = 2 if pq else 1
                vals = np.frombuffer(body[i + 1:i + 1 + 64 * width],
                                     ">u2" if pq else np.uint8)
                t = np.zeros(64, np.int64)
                t[ZIGZAG] = vals
                qtabs[tq] = t
                i += 1 + 64 * width
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                count = sum(body[i + 1:i + 17])
                spec = body[i + 1:i + 17 + count]
                (ac_luts if tc else dc_luts)[th] = _huff_lut(spec)
                i += 17 + count
        elif m == 0xDD:
            interval = struct.unpack(">H", body[:2])[0]
        elif m in (0xC0, 0xC1):
            prec, height, width, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise NotImplementedError(
                    f"{name}: {prec}-bit JPEG; only 8-bit samples are "
                    f"decoded without cv2")
            if nc not in (1, 3):
                raise NotImplementedError(
                    f"{name}: JPEG with {nc} components (CMYK or other); "
                    f"only gray and YCbCr are decoded without cv2")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                      body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(nc)]
            frame = _Frame(height, width, comps)
            coefs = [np.zeros(frame.padded_blocks(i) + (64,), np.int64)
                     for i in range(nc)]
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            kinds = [k for k, on in (
                ("progressive", m & 3 == 2), ("lossless", m & 3 == 3),
                ("hierarchical", m & 7 >= 5),
                ("arithmetic-coded", m >= 0xC9)) if on]
            raise NotImplementedError(
                f"{name}: {', '.join(kinds)} JPEG (SOF 0x{m:02X}); only "
                f"baseline and extended sequential Huffman JPEGs are "
                f"decoded without cv2")
        elif m == 0xE1:
            o = _exif_orientation(body)
            if o != 1:
                raise NotImplementedError(
                    f"{name}: EXIF orientation {o}; cv2.imread would "
                    f"rotate the image, which is not decoded without cv2")
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_rgb = body[11] == 0
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            ns = body[0]
            ids = [c[0] for c in frame.comps]
            scomps = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
                       body[2 + 2 * i] & 15) for i in range(ns)]
            segs, pos = _entropy_segments(data, pos)
            _decode_scan(segs, frame, scomps, coefs, dc_luts, ac_luts,
                         interval)
    if frame is None:
        raise ValueError(f"{name}: no frame in the JPEG data")
    if adobe_rgb and len(frame.comps) == 3:
        raise NotImplementedError(
            f"{name}: an Adobe RGB JPEG; only YCbCr is decoded without cv2")
    natural = [np.empty_like(c) for c in coefs]
    for c, nat in zip(coefs, natural):
        nat[..., ZIGZAG] = c
    return _reconstruct(frame, natural, qtabs)
