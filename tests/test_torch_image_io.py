"""The port's image files and host native code against cv2 and the JAX
package: cocodet_tpu_torch/data/image_io.py (PNG read and write; JPEG in
tests/test_torch_jpeg.py),
csrc/host/png.cpp (row un-filtering), csrc/host/preproc.cpp (letterbox and
the uint8 resize) and ops/host_build.py.

Tolerances: none. PNG reads and writes are exact both ways against cv2
with every row filter; the C++ un-filter equals its numpy plain version;
the letterbox equals ``cocodet_tpu.layers.fast_preproc.letterbox`` bit for
bit; the resize equals ``cv2.resize`` INTER_LINEAR on every pixel (0 of
the pixels drawn here differ, where tests/test_fast_preproc.py holds the
JAX native letterbox to cv2 within mean |d| < 0.6 and 99th percentile 2).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from cocodet_tpu.data.transforms import letterbox as jax_letterbox
from cocodet_tpu.layers import fast_preproc
from cocodet_tpu_torch.data import image_io, transforms
from cocodet_tpu_torch.ops import host_build
from torch_port_utils import private_native_builds


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native letterbox, built for this process before any JAX
    reference runs (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _filter_rows(raw: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """PNG forward filter ``kind`` of every row of (h, row) raw bytes; the
    predictors read raw (unfiltered) neighbours, so this vectorises."""
    r = raw.astype(np.int64)
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    ul = np.zeros_like(r)
    ul[1:, bpp:] = r[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    out = ((r - pred) & 255).astype(np.uint8)
    return np.concatenate([np.full((raw.shape[0], 1), kind, np.uint8), out], axis=1)


def _png(path, px: np.ndarray, color: int, kinds, plte: bytes = b""):
    """Write an 8-bit PNG of (h, w, cn) file-order samples, row y filtered
    with kinds[y % len(kinds)]."""
    h, w, cn = px.shape
    raw = px.reshape(h, w * cn)
    rows = np.concatenate([_filter_rows(raw, kinds[y % len(kinds)], cn)[y:y + 1]
                           for y in range(h)])

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + (chunk(b"PLTE", plte) if plte else b"")
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _file_filters(path):
    with open(path, "rb") as f:
        hdr, idat, _ = image_io.read_png_chunks(f.read())
    cn = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[hdr["color"]]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(hdr["height"], -1)
    assert rows.shape[1] == hdr["width"] * cn + 1
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_read_each_filter_matches_cv2(tmp_path, kind):
    rs = np.random.RandomState(kind)
    # smooth content with noise, so every predictor has work to do
    img = (np.add.outer(np.arange(23), np.arange(31))[..., None] * [3, 5, 7]
           + rs.randint(0, 40, (23, 31, 3))).astype(np.uint8)
    path = str(tmp_path / f"f{kind}.png")
    _png(path, img[..., ::-1], 2, [kind])
    assert _file_filters(path) == {kind}
    want = cv2.imread(path)
    np.testing.assert_array_equal(image_io.read_image(path), want)
    np.testing.assert_array_equal(want, img)


def test_read_mixed_filters_matches_cv2(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (40, 17, 3)).astype(np.uint8)
    path = str(tmp_path / "mixed.png")
    _png(path, img[..., ::-1], 2, [4, 3, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(image_io.read_image(path), cv2.imread(path))


CV2_FILTERS = {"NONE": {0}, "SUB": {1}, "UP": {2}, "AVG": {3}, "PAETH": {4},
               "ALL_FILTERS": None, "default": None}


@pytest.mark.parametrize("flag", list(CV2_FILTERS))
def test_cv2_written_files(tmp_path, flag):
    """Files libpng writes through cv2, with each filter forced and with its
    own adaptive choice (ALL_FILTERS mixes Sub, Up and Paeth rows on these
    images), read exactly."""
    rs = np.random.RandomState(1)
    h, w = 64, 96
    ramp = np.add.outer(np.arange(h), 2 * np.arange(w))[..., None] * [1, 2, 3]
    from cocodet_tpu_torch.data.synthetic import _draw_background

    images = {
        "noise": rs.randint(0, 256, (h, w, 3)),
        "ramp_noise": ramp + rs.randint(0, 8, (h, w, 3)),
        "columns": np.tile(rs.randint(0, 256, (1, w, 3)), (h, 1, 1)),
        "blocks": np.kron(rs.randint(0, 256, (8, 12, 3)), np.ones((8, 8, 1))),
        "synthetic": _draw_background(np.random.RandomState(3), h, w),
    }
    params = [] if flag == "default" else [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_FILTER_{flag}",
                                        getattr(cv2, f"IMWRITE_PNG_{flag}", None))]
    chosen = set()
    for name, img in images.items():
        img = np.asarray(img).astype(np.uint8)
        path = str(tmp_path / f"{name}.png")
        assert cv2.imwrite(path, img, params)
        chosen |= _file_filters(path)
        np.testing.assert_array_equal(image_io.read_image(path), img, err_msg=name)
    if CV2_FILTERS[flag] is not None:
        assert chosen == CV2_FILTERS[flag]
    elif flag == "ALL_FILTERS":
        assert len(chosen) >= 3, chosen


def test_write_is_read_by_cv2(tmp_path):
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    image_io.write_image(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    grey = img[..., 0].copy()
    image_io.write_image(path, grey)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), grey)


@pytest.mark.parametrize("color", [0, 3, 4, 6])
def test_colour_types_match_cv2(tmp_path, color):
    """Grey, palette, grey + alpha and RGBA read as cv2.IMREAD_COLOR does."""
    rs = np.random.RandomState(color)
    cn = {0: 1, 3: 1, 4: 2, 6: 4}[color]
    px = rs.randint(0, 256, (19, 13, cn)).astype(np.uint8)
    plte = b""
    if color == 3:
        px = px % 16
        plte = rs.randint(0, 256, 48).astype(np.uint8).tobytes()
    path = str(tmp_path / f"c{color}.png")
    _png(path, px, color, [1, 4, 3], plte)
    np.testing.assert_array_equal(image_io.read_image(path), cv2.imread(path))


def test_jpeg_raises(tmp_path):
    """What JPEG support still refuses: a progressive file (cv2 writes one),
    by name, and a write to an extension other than JPEG's and PNG's."""
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        image_io.read_image(path)
    with pytest.raises(NotImplementedError, match="JPEG and PNG"):
        image_io.write_image(str(tmp_path / "x.bmp"), np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_unfilter_matches_plain(bpp):
    rs = np.random.RandomState(bpp)
    h, row = 9, 7 * bpp
    data = rs.randint(0, 256, (h, row + 1)).astype(np.uint8)
    data[:, 0] = np.arange(h) % 5
    flat = data.reshape(-1)
    np.testing.assert_array_equal(image_io.unfilter(flat, h, row, bpp),
                                  image_io.unfilter_plain(flat, h, row, bpp))
    bad = flat.copy()
    bad[2 * (row + 1)] = 9
    with pytest.raises(ValueError, match="row 2"):
        image_io.unfilter(bad, h, row, bpp)


RESIZE_CASES = [((100, 80), (614, 768)), ((300, 500), (768, 460)), ((512, 384), (832, 624)),
                ((640, 480), (48, 64)), ((37, 53), (97, 71)), ((60, 120), (120, 60)),
                ((1, 2), (4, 1)), ((256, 256), (128, 128))]


@pytest.mark.parametrize("hw,size", RESIZE_CASES)
def test_resize_matches_cv2(hw, size):
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    got = transforms.resize(img, size)
    plain = transforms.resize(img, size, use_native=False)
    assert int((got != want).sum()) == 0 and int((plain != want).sum()) == 0


@pytest.mark.parametrize("hw", [(100, 80), (60, 120), (640, 480), (511, 300), (768, 614)])
def test_letterbox_matches_jax(hw):
    img = np.random.RandomState(0).randint(0, 256, hw + (3,)).astype(np.uint8)
    got, r = transforms.letterbox(img, (768, 768))
    want, r_want = fast_preproc.letterbox(img, (768, 768))
    assert r == r_want
    np.testing.assert_array_equal(got, want)
    # the plain versions: the resize is cv2's, so the JAX cv2 path is equal too
    got, r = transforms.letterbox(img, (96, 64), use_native=False)
    want, r_want = jax_letterbox(img, (96, 64), use_native=False)
    assert r == r_want
    np.testing.assert_array_equal(got, want)


def test_val_transform_legacy():
    from cocodet_tpu.data.transforms import ValTransform as JaxVal

    img = np.random.RandomState(1).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    for legacy in (False, True):
        got, t = transforms.ValTransform(legacy)(img, None, (64, 64))
        want, tw = JaxVal(legacy)(img, None, (64, 64))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t, tw)


def test_jax_letterbox_is_the_private_native_build(jax_native, monkeypatch):
    """The module's fixture: JAX's letterbox loads the native library built
    for this process, outside the JAX package's tree, takes its native path,
    and equals the port's letterbox and the library's, bit for bit."""
    path = jax_native["_preproc.so"]
    package = os.path.dirname(os.path.dirname(os.path.abspath(fast_preproc.__file__)))
    assert os.path.isfile(path) and fast_preproc._lib._name == path
    assert not os.path.abspath(path).startswith(package + os.sep)
    calls = []
    native = fast_preproc.letterbox
    monkeypatch.setattr(fast_preproc, "letterbox",
                        lambda *a, **kw: calls.append(a[1]) or native(*a, **kw))
    img = np.random.RandomState(2).randint(0, 256, (300, 500, 3)).astype(np.uint8)
    want, r_want = jax_letterbox(img, (416, 352), use_native=True)
    assert calls == [(416, 352)]
    for got, r in (native(img, (416, 352)), transforms.letterbox(img, (416, 352))):
        assert r == r_want and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_failed_build_or_probe_raises(tmp_path, monkeypatch):
    """No quiet fallback: a library that does not compile, or fails its
    probe, raises."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    (tmp_path / "fine.cpp").write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(host_build, "CSRC", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="broken.cpp"):
        host_build.load("broken", lambda lib: None)

    def probe(lib):
        raise RuntimeError("probe failed")

    with pytest.raises(RuntimeError, match="probe failed"):
        host_build.load("fine", probe)
    assert host_build.load("fine", lambda lib: None).one() == 1
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "build").glob("*.so")) == ["libfine"]
