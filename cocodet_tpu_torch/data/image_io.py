"""Image files without cv2 or PIL: JPEG and 8-bit PNG.

``read_image`` and ``write_image`` are the port's counterparts of
``cv2.imread(path)`` and ``cv2.imwrite(path, img)``, which the JAX package's
datasets and synthetic generator call (cocodet_tpu/data/coco.py:141,
data/folder.py:107, 171, data/synthetic.py:288). As with cv2, arrays are BGR
in memory.

JPEG runs in host C++ (``csrc/host/jpeg.cpp``), which computes what
libjpeg-turbo computes under OpenCV's settings: ``read_image`` equals
``cv2.imread`` bit for bit (baseline and extended sequential Huffman, 1 or 3
components, any integral sampling, restart intervals, the EXIF orientation
applied as ``IMREAD_COLOR`` applies it), and ``write_image`` on a ``.jpg``
or ``.jpeg`` path writes the bytes ``cv2.imwrite`` writes with no
parameters. Progressive, arithmetic-coded, lossless, 12-bit and CMYK/YCCK
files raise ``NotImplementedError`` naming the feature; truncated or
corrupt data raises ``ValueError``. The library is bound with
``ctypes.CDLL``, so a call releases the GIL and the loader's threads decode
in parallel. ``data/jpeg_plain.py`` holds its plain versions.

PNG: the standard library's ``zlib`` inflates, and the row un-filtering runs
in host C++ (``csrc/host/png.cpp``): Sub, Average and Paeth depend on the
byte decoded just before, so a row cannot be vectorised. ``unfilter_plain``
is its numpy plain version. The reader takes every 8-bit colour type (grey,
RGB, palette, grey + alpha, RGBA; alpha is dropped, grey is repeated to
three channels, as ``cv2.IMREAD_COLOR`` does); 16-bit and interlaced files
raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops import host_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def _bind(lib: ctypes.CDLL) -> None:
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    # probe: one Paeth row and one Average row of 2 one-byte pixels
    data = np.asarray([4, 1, 2, 3, 5, 6], np.uint8)
    out = np.empty(4, np.uint8)
    rc = lib.png_unfilter(host_build.ptr(data, ctypes.c_uint8), 2, 2, 1,
                          host_build.ptr(out, ctypes.c_uint8))
    if rc != 0 or out.tolist() != [1, 3, 5, 10]:
        raise RuntimeError(f"libpng probe failed: rc {rc}, {out.tolist()}")


def unfilter(filtered: np.ndarray, h: int, row: int, bpp: int) -> np.ndarray:
    """(h * (1 + row),) filtered bytes -> (h, row) raw bytes, in C++."""
    lib = host_build.load("png", _bind)
    filtered = np.ascontiguousarray(filtered, np.uint8)
    if filtered.size != h * (row + 1):
        raise ValueError(f"{filtered.size} bytes for {h} rows of {row} + 1")
    out = np.empty((h, row), np.uint8)
    rc = lib.png_unfilter(host_build.ptr(filtered, ctypes.c_uint8), h, row, bpp,
                          host_build.ptr(out, ctypes.c_uint8))
    if rc:
        raise ValueError(f"PNG row {rc - 1} has an unknown filter type "
                         f"{int(filtered[(rc - 1) * (row + 1)])}")
    return out


def unfilter_plain(filtered: np.ndarray, h: int, row: int, bpp: int) -> np.ndarray:
    """The plain version of ``unfilter`` (PNG spec, section 9), a byte at a
    time for Average and Paeth: about a second for a 512 x 512 image."""
    rows = np.asarray(filtered, np.uint8).reshape(h, row + 1)
    out = np.zeros((h, row), np.uint8)
    prev = np.zeros(row, np.int64)
    for y in range(h):
        kind, s = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        cur = np.zeros(row + bpp, np.int64)  # bpp zeros on the left
        if kind == 0:
            cur[bpp:] = s
        elif kind == 1:
            for i in range(row):
                cur[bpp + i] = (s[i] + cur[i]) & 255
        elif kind == 2:
            cur[bpp:] = (s + prev) & 255
        elif kind in (3, 4):
            up = np.concatenate([np.zeros(bpp, np.int64), prev])
            for i in range(row):
                a, b, c = cur[i], up[bpp + i], up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[bpp + i] = (s[i] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type {kind}")
        prev = cur[bpp:]
        out[y] = prev
    return out


def read_png_chunks(data: bytes) -> Tuple[dict, bytes, bytes]:
    """(IHDR fields, concatenated IDAT bytes, PLTE bytes) of a PNG file."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, plte, ihdr = 8, [], b"", None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if kind == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            ihdr = dict(width=w, height=h, depth=depth, color=color, compression=comp,
                        filter=filt, interlace=interlace)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None:
        raise ValueError("PNG file without IHDR")
    return ihdr, b"".join(idat), plte


def _bind_jpeg(lib: ctypes.CDLL) -> None:
    u8, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [u8, ctypes.c_size_t, i32, ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [u8, ctypes.c_size_t, u8, ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_encode.restype = ctypes.c_long
    lib.jpeg_encode.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8, ctypes.c_long]
    # probe: a flat 16 x 16 BGR (10, 200, 60) square through the encoder and
    # back: libjpeg-turbo writes 635 bytes and reads them as (10, 200, 59)
    img = np.empty((16, 16, 3), np.uint8)
    img[:] = (10, 200, 60)
    buf = np.empty(4096, np.uint8)
    size = lib.jpeg_encode(host_build.ptr(img, ctypes.c_uint8), 16, 16, 3,
                           host_build.ptr(buf, ctypes.c_uint8), buf.size)
    out = np.zeros((16, 16, 3), np.uint8)
    msg = ctypes.create_string_buffer(160)
    rc = lib.jpeg_decode(host_build.ptr(buf, ctypes.c_uint8), size,
                         host_build.ptr(out, ctypes.c_uint8), msg, len(msg))
    if rc or size != 635 or out.reshape(-1, 3).tolist() != [[10, 200, 59]] * 256:
        raise RuntimeError(f"libjpeg probe failed: rc {rc} {msg.value!r}, {size} bytes, "
                           f"pixel {out[0, 0].tolist()}")


def _jpeg_lib() -> ctypes.CDLL:
    return host_build.load("jpeg", _bind_jpeg)


def _jpeg_raise(rc: int, msg: bytes, where: str):
    text = f"{where}: {msg.decode()}"
    if rc == 1:
        raise NotImplementedError(f"{text} is not supported: the port decodes baseline and "
                                  "extended sequential Huffman JPEG, 8-bit, 1 or 3 components "
                                  "(ROADMAP Queue 1 item 7)")
    raise ValueError(text)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image turned as OpenCV turns it for an EXIF orientation (1-8; any
    other value leaves it as it is)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, where: str = "JPEG") -> np.ndarray:
    """(H, W, 3) uint8 BGR of a JPEG file's bytes, as ``cv2.imdecode`` gives
    it with ``IMREAD_COLOR``, the EXIF orientation applied; ``where`` names
    the file in errors."""
    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    msg = ctypes.create_string_buffer(160)
    rc = lib.jpeg_header(host_build.ptr(buf, ctypes.c_uint8), buf.size,
                         host_build.ptr(info, ctypes.c_int32), msg, len(msg))
    if rc:
        _jpeg_raise(rc, msg.value, where)
    out = np.empty((int(info[0]), int(info[1]), 3), np.uint8)
    rc = lib.jpeg_decode(host_build.ptr(buf, ctypes.c_uint8), buf.size,
                         host_build.ptr(out, ctypes.c_uint8), msg, len(msg))
    if rc:
        _jpeg_raise(rc, msg.value, where)
    return apply_orientation(out, int(info[3]))


def encode_jpeg(img: np.ndarray) -> bytes:
    """The bytes ``cv2.imencode('.jpg', img)`` makes of an (H, W, 3) BGR or
    (H, W) grey uint8 image (quality 95, 4:2:0 for colour)."""
    img = _check_writable(img)
    lib = _jpeg_lib()
    img = np.ascontiguousarray(img)
    cn = 1 if img.ndim == 2 else 3
    cap = img.size // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        size = lib.jpeg_encode(host_build.ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                               cn, host_build.ptr(out, ctypes.c_uint8), cap)
        if size <= cap:
            return out[:size].tobytes()
        cap = size


def _check_writable(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_image takes (H, W, 3) or (H, W) uint8, got "
                         f"{img.shape} {img.dtype}")
    if img.shape[0] < 1 or img.shape[1] < 1 or max(img.shape[:2]) > 65500:
        raise ValueError(f"cannot write an image of {img.shape[1]} x {img.shape[0]} pixels")
    return img


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of an image file, as ``cv2.imread(path)`` gives
    it for a JPEG or an 8-bit PNG. Raises ``NotImplementedError`` for the
    JPEG features above, 16-bit and interlaced PNG, and ``ValueError`` for
    anything else it cannot read."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, str(path))
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: neither a JPEG nor a PNG file")
    hdr, idat, plte = read_png_chunks(data)
    h, w, color = hdr["height"], hdr["width"], hdr["color"]
    if hdr["depth"] != 8 or hdr["interlace"] != 0:
        raise NotImplementedError(f"{path}: {hdr['depth']}-bit, interlace "
                                  f"{hdr['interlace']}: the port reads 8-bit "
                                  "non-interlaced PNG")
    if color not in _CHANNELS or hdr["compression"] or hdr["filter"]:
        raise ValueError(f"{path}: unsupported PNG header {hdr}")
    cn = _CHANNELS[color]
    raw = unfilter(np.frombuffer(zlib.decompress(idat), np.uint8), h, w * cn, cn)
    px = raw.reshape(h, w, cn)
    if color == 3:
        pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if int(px.max(initial=0)) >= len(pal):
            raise ValueError(f"{path}: palette index past its {len(pal)} PLTE entries")
        rgb = pal[px[..., 0]]
    elif cn <= 2:  # grey, grey + alpha
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:  # RGB, RGBA
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_image(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) BGR or (H, W) grey uint8 image as ``cv2.imwrite(path,
    img)`` does: on a ``.jpg`` or ``.jpeg`` path the same bytes (quality 95,
    4:2:0, standard tables), on a ``.png`` path a PNG with every row filtered
    with Sub (vectorised: a difference along the row); any other extension
    raises."""
    ext = str(path).lower().rsplit(".", 1)[-1]
    if ext in ("jpg", "jpeg"):
        data = encode_jpeg(img)
        with open(path, "wb") as f:
            f.write(data)
        return
    if ext != "png":
        raise NotImplementedError(f"{path}: the port writes JPEG and PNG only")
    img = _check_writable(img)
    h, w = img.shape[:2]
    px = img[..., ::-1] if img.ndim == 3 else img[..., None]  # BGR -> RGB
    cn = px.shape[2]
    raw = np.ascontiguousarray(px).reshape(h, w * cn)
    sub = raw.copy()
    sub[:, cn:] = raw[:, cn:] - raw[:, :-cn]  # uint8 wraps: mod 256
    rows = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if cn == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
