"""Host-side image transforms of the evaluation path (cocodet_tpu/data/
transforms.py:31-38, 120-145, 194-208): ``xyxy2cxcywh``, ``letterbox``,
``ValTransform``, and ``resize``, the port's ``cv2.resize`` (INTER_LINEAR
on uint8).

``letterbox`` and ``resize`` run in host C++ (``csrc/host/preproc.cpp``):
the letterbox is the JAX package's native one, copied, and equals it bit
for bit; the resize computes OpenCV's fixed-point arithmetic and equals
``cv2.resize`` on every pixel the tests draw. ``use_native=False`` selects
their plain numpy versions, which the tests hold the C++ against. Where the
JAX package's letterbox falls back to cv2 quietly when its library is
missing, the port's raises. The training transforms are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import host_build


def xyxy2cxcywh(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 2] = boxes[:, 2] - boxes[:, 0]
    out[:, 3] = boxes[:, 3] - boxes[:, 1]
    out[:, 0] = boxes[:, 0] + out[:, 2] * 0.5
    out[:, 1] = boxes[:, 1] + out[:, 3] * 0.5
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.letterbox_u8.restype = ctypes.c_float
    lib.letterbox_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int, f32, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.resize_u8.restype = None
    lib.resize_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8,
                              ctypes.c_int, ctypes.c_int]
    # probes: a 2x2 -> 4x4 letterbox returns ratio 2.0; a 1x2 -> 1x4 resize
    # of [0, 255] gives cv2's [0, 64, 191, 255]
    img = np.zeros((2, 2, 3), np.uint8)
    out = np.empty((4, 4, 3), np.float32)
    r = lib.letterbox_u8(host_build.ptr(img, ctypes.c_uint8), 2, 2,
                         host_build.ptr(out, ctypes.c_float), 4, 4, 114.0, 1)
    row = np.asarray([[0, 255]], np.uint8)
    wide = np.empty((1, 4), np.uint8)
    lib.resize_u8(host_build.ptr(row, ctypes.c_uint8), 1, 2, 1,
                  host_build.ptr(wide, ctypes.c_uint8), 1, 4)
    if abs(float(r) - 2.0) > 1e-5 or wide.tolist() != [[0, 64, 191, 255]]:
        raise RuntimeError(f"libpreproc probe failed: ratio {r}, resize {wide.tolist()}")


def _lib() -> ctypes.CDLL:
    return host_build.load("preproc", _bind)


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source indices and 11-bit weights of each destination coordinate, as
    OpenCV sets them up for INTER_LINEAR (see csrc/host/preproc.cpp)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo], s[hi] = 0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048.0)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_plain(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The plain version of ``resize``, whole arrays in int64."""
    h, w = size[1], size[0]
    x0, x1, a0, a1 = _linear_taps(img.shape[1], w, True)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], h, False)
    src = img.astype(np.int64).reshape(img.shape[0], img.shape[1], -1)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    top, bot = rows[y0] >> 4, rows[y1] >> 4
    v = (((b0[:, None, None] * top) >> 16) + ((b1[:, None, None] * bot) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])


def resize(img: np.ndarray, size: Tuple[int, int], use_native: bool = True) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` of an
    (H, W) or (H, W, C) uint8 image; ``size`` is (width, height), as cv2
    takes it."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes (H, W[, C]) uint8, got {img.shape} {img.dtype}")
    if not use_native:
        return resize_plain(img, size)
    img = np.ascontiguousarray(img)
    cn = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((size[1], size[0]) + img.shape[2:], np.uint8)
    _lib().resize_u8(host_build.ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1], cn,
                     host_build.ptr(out, ctypes.c_uint8), size[1], size[0])
    return out


def letterbox_plain(img: np.ndarray, input_size: Tuple[int, int],
                    pad_value: int = 114) -> Tuple[np.ndarray, float]:
    """The plain version of ``letterbox``: the JAX package's own when its
    native library is absent (transforms.py:138-145), cv2.resize replaced by
    ``resize_plain``."""
    padded = np.full((input_size[0], input_size[1], 3), pad_value, np.uint8)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    nw, nh = int(img.shape[1] * r), int(img.shape[0] * r)
    resized = resize_plain(img, (nw, nh))
    if resized.ndim == 2:
        resized = resized[..., None].repeat(3, axis=2)
    padded[:nh, :nw] = resized
    return np.ascontiguousarray(padded, dtype=np.float32), r


def letterbox(img: np.ndarray, input_size: Tuple[int, int], pad_value: int = 114,
              use_native: bool = True) -> Tuple[np.ndarray, float]:
    """Ratio-preserving bilinear resize + pad top-left, HWC float32: the JAX
    package's native letterbox (layers/fast_preproc) for (H, W, 3) uint8,
    the plain version otherwise or when asked."""
    if not (use_native and img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8):
        return letterbox_plain(img, input_size, pad_value)
    img = np.ascontiguousarray(img)
    out = np.empty((input_size[0], input_size[1], 3), np.float32)
    r = _lib().letterbox_u8(host_build.ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                            host_build.ptr(out, ctypes.c_float), input_size[0],
                            input_size[1], float(pad_value), 1)
    return out, float(r)


class ValTransform:
    """Letterbox only (cocodet_tpu/data/transforms.py:194-208); ``legacy``
    normalizes as the yolov5-style models want."""

    def __init__(self, legacy: bool = False):
        self.legacy = legacy

    def __call__(self, img: np.ndarray, res, input_size: Tuple[int, int]):
        img, r = letterbox(img, input_size)
        if self.legacy:
            img = img[..., ::-1].copy()  # BGR -> RGB
            img /= 255.0
            img -= np.array([0.485, 0.456, 0.406])
            img /= np.array([0.229, 0.224, 0.225])
        return img, np.zeros((1, 5), np.float32)
