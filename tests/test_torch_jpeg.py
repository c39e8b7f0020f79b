"""The port's JPEG codec (cocodet_tpu_torch/csrc/host/jpeg.cpp through
data/image_io.py) against cv2, which the JAX package reads and writes
its images with (cocodet_tpu/data/coco.py:141, data/folder.py:107, 171,
data/synthetic.py:288), and against its plain versions
(data/jpeg_plain.py).

Tolerances: none. ``read_image`` equals ``cv2.imread`` bit for bit on files
cv2 writes from seeded images (smooth fields plus noise, as the synthetic
set draws them) at every size, quality, sampling, restart interval and
table choice below, grey, and with each EXIF orientation spliced in;
``write_image`` on ``.jpg`` writes ``cv2.imwrite``'s bytes, colour and grey.
The reference is cv2 5.0.0 on libjpeg-turbo 3.1.2. The decode matrix also confirms
that libjpeg-turbo runs with API version 62 (libjpeg 6b's decoder: no
DCT-domain scaling of the chroma): the port decodes that way and agrees on
every file.
"""

import struct

import cv2
import numpy as np
import pytest

from cocodet_tpu_torch.data import image_io, jpeg_plain

SIZES = [(1, 1), (7, 9), (17, 33), (255, 257), (480, 640)]
QUALITIES = [50, 75, 95, 100]
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111}
EXTRAS = {"plain": [], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
          "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1]}


def seeded_image(h: int, w: int, seed: int = 0, grey: bool = False) -> np.ndarray:
    """A smooth colour field plus noise, as the synthetic set draws them."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    phase = rs.uniform(0, 6, 3)
    base = np.stack([np.sin(xx / 7 + p) * 60 + np.cos(yy / 11 - p) * 50 + 128 for p in phase], -1)
    img = np.clip(base + rs.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img[..., 0]) if grey else img


def cv2_jpeg(img, params=()) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def cv2_read(data: bytes, tmp_path, name="f.jpg") -> np.ndarray:
    path = tmp_path / name
    path.write_bytes(data)
    return cv2.imread(str(path))


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_matches_cv2(tmp_path, h, w):
    img = seeded_image(h, w, seed=h * 1000 + w)
    n = 0
    for q in QUALITIES:
        for sname, sf in SAMPLINGS.items():
            for ename, extra in EXTRAS.items():
                data = cv2_jpeg(img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf, *extra])
                path = tmp_path / "f.jpg"
                path.write_bytes(data)
                got, want = image_io.read_image(str(path)), cv2.imread(str(path))
                assert got.shape == want.shape, (q, sname, ename)
                assert np.array_equal(got, want), (q, sname, ename, int((got != want).sum()))
                n += 1
    assert n == len(QUALITIES) * len(SAMPLINGS) * len(EXTRAS)


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_grey_matches_cv2(tmp_path, h, w):
    for q in QUALITIES:
        data = cv2_jpeg(seeded_image(h, w, seed=q, grey=True), [cv2.IMWRITE_JPEG_QUALITY, q])
        got = image_io.decode_jpeg(data)
        want = cv2_read(data, tmp_path)
        assert got.shape == want.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("grey", [False, True])
def test_encode_matches_cv2_bytes(tmp_path, h, w, grey):
    img = seeded_image(h, w, seed=7, grey=grey)
    path = tmp_path / "out.jpg"
    image_io.write_image(str(path), img)
    cv2.imwrite(str(tmp_path / "ref.jpg"), img)
    assert path.read_bytes() == (tmp_path / "ref.jpg").read_bytes()
    assert image_io.encode_jpeg(img) == cv2_jpeg(img)


@pytest.mark.parametrize("h,w", SIZES[:3] + [(40, 37)])
def test_native_matches_plain(h, w):
    """The C++ against the plain Python/numpy stages, decode and encode."""
    img = seeded_image(h, w, seed=3)
    for sf in SAMPLINGS.values():
        for extra in EXTRAS.values():
            data = cv2_jpeg(img, [cv2.IMWRITE_JPEG_QUALITY, 75,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf, *extra])
            plain, orientation = jpeg_plain.decode(data)
            assert orientation == 0
            np.testing.assert_array_equal(image_io.decode_jpeg(data), plain)
    for grey in (False, True):
        x = seeded_image(h, w, seed=4, grey=grey)
        assert image_io.encode_jpeg(x) == jpeg_plain.encode(x)


def test_plain_stages():
    """The plain IDCT's range limit, the Huffman code tables and the quality
    scaling (jcparam.c) on values whose answers are known."""
    values = np.asarray([-600, -129, -128, -1, 0, 127, 128, 511, 512, 1024])
    np.testing.assert_array_equal(  # -600 and 1024 wrap: a mask, not a clamp
        jpeg_plain.idct_range_limit(values), [255, 0, 0, 127, 128, 255, 255, 255, 0, 128])
    codes = jpeg_plain.huffman_codes(*jpeg_plain.DC_LUMA)
    assert codes[(2, 0b00)] == 0 and codes[(3, 0b010)] == 1 and codes[(9, 0b111111110)] == 11
    assert jpeg_plain.quant_table(jpeg_plain.STD_LUMA_Q, 95)[:4].tolist() == [2, 1, 1, 2]
    assert jpeg_plain.quant_table(jpeg_plain.STD_LUMA_Q, 10).max() == 255  # baseline limit
    assert jpeg_plain.quant_table(jpeg_plain.STD_LUMA_Q, 100).tolist() == [1] * 64
    flat = np.zeros((1, 64), np.int64)
    flat[0, 0] = 10  # DC 10 at quantiser 1: every sample 128 + 10 / 8 rounded
    np.testing.assert_array_equal(jpeg_plain.idct_islow(flat, np.ones(64, np.int64)),
                                  np.full((1, 8, 8), 129, np.uint8))


def _exif(orientation: int, intel: bool) -> bytes:
    e = "<" if intel else ">"
    tiff = ((b"II*\x00" if intel else b"MM\x00*") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + b"\x00" * 4)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, orientation):
    data = cv2_jpeg(seeded_image(17, 33, seed=orientation))
    for intel in (True, False):
        spliced = data[:2] + _exif(orientation, intel) + data[2:]
        want = cv2_read(spliced, tmp_path, "o.jpg")
        got = image_io.read_image(str(tmp_path / "o.jpg"))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        plain, o = jpeg_plain.decode(spliced)
        assert o == orientation
        np.testing.assert_array_equal(image_io.apply_orientation(plain, o), want)


@pytest.mark.parametrize("orientation", [0, 9, 300])
def test_exif_orientation_out_of_range_is_ignored(tmp_path, orientation):
    data = cv2_jpeg(seeded_image(9, 14, seed=1))
    spliced = data[:2] + _exif(orientation, True) + data[2:]
    np.testing.assert_array_equal(image_io.decode_jpeg(spliced), cv2_read(spliced, tmp_path))


def test_unsupported_features_raise_by_name(tmp_path):
    img = seeded_image(16, 24)
    prog = cv2_jpeg(img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        image_io.decode_jpeg(prog)
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        jpeg_plain.decode(prog)
    base = bytearray(cv2_jpeg(img))
    sof = base.index(b"\xff\xc0")
    for marker, name in ((0xC9, "arithmetic-coded JPEG"), (0xC3, "lossless JPEG")):
        f = bytearray(base)
        f[sof + 1] = marker
        with pytest.raises(NotImplementedError, match=name):
            image_io.decode_jpeg(bytes(f))
    f = bytearray(base)
    f[sof + 4] = 12  # sample precision
    with pytest.raises(NotImplementedError, match="12-bit JPEG"):
        image_io.decode_jpeg(bytes(f))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_truncated_data_raises(cut):
    data = cv2_jpeg(seeded_image(64, 80, seed=2))
    with pytest.raises(ValueError):
        image_io.decode_jpeg(data[:int(len(data) * cut)])
    with pytest.raises(ValueError):
        image_io.decode_jpeg(b"\xff\xd8not a jpeg")


def test_write_then_read_roundtrip(tmp_path):
    """The synthetic set's path: the port writes, both read the same array."""
    img = seeded_image(120, 90, seed=9)
    path = str(tmp_path / "000000000001.jpg")
    image_io.write_image(path, img)
    np.testing.assert_array_equal(image_io.read_image(path), cv2.imread(path))
