"""``bonai_tpu_torch/utils/jpeg.py`` and the 16-bit paths of
``utils/png.py`` against cv2 5.0 (libjpeg-turbo 3.1, libpng), all exact:

- ``read_jpeg`` on ``cv2.imencode`` bytes at qualities 15, 25, 40, 60, 80
  and 95, sampling 4:2:0, 4:2:2, 4:4:0 and 4:4:4, with and without a
  restart interval, at 67x45 (partial MCUs), 64^2, 23x17 and one- and
  two-pixel strips; gray JPEGs read as ``IMREAD_COLOR`` reads them;
- ``encode_jpeg`` gives cv2's default bytes (4:2:0 or gray, no restart
  markers), and ``jpeg_round_trip`` equals both
  ``read_jpeg(encode_jpeg(...))`` and cv2's own round trip;
- a progressive JPEG and one whose EXIF orientation is 6 raise
  ``NotImplementedError``;
- 16-bit gray, RGB and RGBA PNGs read as ``IMREAD_UNCHANGED`` and
  ``IMREAD_COLOR`` read them, and ``write_png``'s 16-bit gray as cv2
  reads it back; ``LoadImageFromFile`` picks the decoder by signature.
"""

import struct

import cv2
import numpy as np
import pytest

from bonai_tpu_torch.datasets.pipelines.transforms import (LoadImageFromFile,
                                                           imread)
from bonai_tpu_torch.utils.jpeg import encode_jpeg, jpeg_round_trip, read_jpeg
from bonai_tpu_torch.utils.png import read_png, write_png

QUALITIES = (15, 25, 40, 60, 80, 95)
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = ((45, 67), (64, 64), (17, 23), (1, 9), (2, 7))


def _image(h, w, seed=0):
    """Smooth colour fields plus noise: both flat and busy blocks."""
    rs = np.random.RandomState(seed)
    base = rs.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32) * 255
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rs.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _cv2_encode(img, q, sampling="420", rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, q]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_codec_matches_libjpeg_turbo(size, sampling):
    img = _image(*size)
    for q in QUALITIES:
        for rst in (0, 3):
            data = _cv2_encode(img, q, sampling, rst)
            ref = _cv2_decode(data)
            np.testing.assert_array_equal(read_jpeg(data), ref)
            if sampling == "420" and not rst:
                assert encode_jpeg(img, q) == data
                np.testing.assert_array_equal(jpeg_round_trip(img, q), ref)


@pytest.mark.parametrize("size", SIZES)
def test_gray_jpeg(size):
    gray = _image(*size)[..., 1]
    for q in (25, 95):
        data = _cv2_encode(gray, q)
        assert encode_jpeg(gray, q) == data
        np.testing.assert_array_equal(read_jpeg(data), _cv2_decode(data))
        np.testing.assert_array_equal(jpeg_round_trip(gray, q),
                                      _cv2_decode(data))


def test_round_trip_equals_entropy_coded_path_at_tile_size():
    """At 500x375 (a VOC image) the shortcut and the full codec agree,
    and a file read from disk decodes as ``cv2.imread`` reads it."""
    img = _image(375, 500, seed=3)
    for q in (15, 60, 95):
        data = encode_jpeg(img, q)
        np.testing.assert_array_equal(jpeg_round_trip(img, q),
                                      read_jpeg(data))
        np.testing.assert_array_equal(read_jpeg(data), _cv2_decode(data))


def test_unsupported_jpeg_raises(tmp_path):
    img = _image(40, 40)
    _, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        read_jpeg(prog.tobytes())
    # an APP1 Exif block with orientation 6 after SOI
    tiff = (b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0) + b"\x00" * 4)
    body = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    data = encode_jpeg(img, 90)
    rotated = data[:2] + app1 + data[2:]
    assert _cv2_decode(rotated).shape == (40, 40, 3)
    with pytest.raises(NotImplementedError, match="orientation 6"):
        read_jpeg(rotated)
    path = tmp_path / "x.bmp"
    cv2.imwrite(str(path), img)
    with pytest.raises(NotImplementedError, match="only PNG"):
        imread(str(path))


@pytest.mark.parametrize("shape", [(13, 17), (5, 7, 3), (6, 9, 4)])
def test_png_16_bit_reads_as_cv2(tmp_path, shape):
    rs = np.random.RandomState(1)
    img = (rs.rand(*shape) * 65535).astype(np.uint16)
    img[0, 0] = 65535                      # the extremes
    img[-1, -1] = 0
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    got = read_png(path, unchanged=True)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(read_png(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_16_bit_write_and_filters(tmp_path):
    rs = np.random.RandomState(2)
    img = (rs.rand(31, 47) * 65535).astype(np.uint16)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(read_png(path, unchanged=True), img)
    # cv2 at its highest compression filters rows (Sub, Up, Average, Paeth)
    ramp = np.tile(np.arange(300, dtype=np.uint16) * 200, (40, 1))
    ramp[::3] += rs.randint(0, 300, ramp[::3].shape).astype(np.uint16)
    cv2.imwrite(path, ramp, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    np.testing.assert_array_equal(read_png(path, unchanged=True), ramp)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.int32))


def test_load_image_picks_the_decoder_by_signature(tmp_path):
    img = _image(37, 53, seed=4)
    jpg = tmp_path / "a.png"                # a JPEG under a PNG name
    jpg.write_bytes(encode_jpeg(img, 85))
    png = tmp_path / "b.jpg"                # and a PNG under a JPEG name
    write_png(str(png), img)
    load = LoadImageFromFile()
    for path, ref in ((jpg, cv2.imread(str(jpg))), (png, img)):
        out = load({"img_prefix": str(tmp_path),
                    "img_info": {"filename": path.name}})
        np.testing.assert_array_equal(out["img"], ref)
