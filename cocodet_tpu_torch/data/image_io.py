"""Image files without cv2 or PIL: 8-bit PNG read and written with the
standard library's ``zlib`` and numpy.

``read_image`` and ``write_image`` are the port's counterparts of
``cv2.imread(path)`` and ``cv2.imwrite(path, img)``, which the JAX package's
datasets and synthetic generator call (cocodet_tpu/data/coco.py:138,
data/folder.py:176, data/synthetic.py:290). As with cv2, arrays are BGR in
memory and RGB in the file, so either library reads the other's files to
the same array. The reader takes every 8-bit colour type (grey, RGB,
palette, grey + alpha, RGBA; alpha is dropped, grey is repeated to three
channels, as ``cv2.IMREAD_COLOR`` does) and undoes all five row filters,
which an encoder such as libpng picks row by row. The un-filtering runs in
host C++ (``csrc/host/png.cpp``): Sub, Average and Paeth depend on the byte
decoded just before, so a row cannot be vectorised. ``unfilter_plain`` is
its numpy plain version. JPEG, 16-bit and interlaced files raise
``NotImplementedError``; they are never guessed at.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops import host_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_TODO = ("JPEG decoding is not ported (ROADMAP Queue 1 item 1); the port "
             "reads 8-bit PNG")
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


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR of an image file, as ``cv2.imread(path)`` gives
    it for an 8-bit PNG. Raises ``NotImplementedError`` for JPEG, 16-bit and
    interlaced PNG, and ``ValueError`` for anything else it cannot read."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(f"{path}: {JPEG_TODO}")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
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
    """Write an (H, W, 3) BGR or (H, W) grey uint8 image as PNG, as
    ``cv2.imwrite(path, img)`` does for a ``.png`` path, every row filtered
    with Sub (vectorised: a difference along the row); any other extension
    raises."""
    if not str(path).lower().endswith(".png"):
        raise NotImplementedError(f"{path}: the port writes PNG only ({JPEG_TODO})")
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_image takes (H, W, 3) or (H, W) uint8, got "
                         f"{img.shape} {img.dtype}")
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
