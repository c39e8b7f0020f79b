"""Host-side image transforms (cocodet_tpu/data/transforms.py): the
evaluation path's ``xyxy2cxcywh``, ``letterbox``, ``ValTransform`` and
``resize`` (the port's ``cv2.resize``, INTER_LINEAR on uint8), and the host
mosaic path's ``augment_hsv``, ``get_affine_matrix``,
``apply_affine_to_bboxes``, ``random_affine``, ``mirror`` and
``TrainTransform``, which draw from the caller's ``random.Random`` in the
JAX package's order.

The pixel work runs in host C++. ``csrc/host/preproc.cpp``: the letterbox
is the JAX package's native one, copied, and equals it bit for bit; the
resize computes OpenCV's fixed-point arithmetic and equals ``cv2.resize``
on every pixel the tests draw. ``csrc/host/warp.cpp``: ``warp_affine``,
``bgr_to_hsv`` and ``hsv_to_bgr`` equal ``cv2.warpAffine`` (INTER_LINEAR,
constant border) and ``cv2.cvtColor`` (BGR<->HSV) on uint8 bit for bit; the
source file says which float operations of OpenCV 5's kernels that takes.
The resize and letterbox take ``use_native=False`` for their plain numpy
versions; the warp and HSV conversions have theirs beside them
(``*_plain``). The tests hold the C++ against those. Where the JAX
package's letterbox falls back to cv2 quietly when its library is missing,
the port's raises.
"""

from __future__ import annotations

import ctypes
import math
import random
from typing import Optional, Tuple

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


# ----------------------------------------------------------------------------
# the host mosaic path: warp and HSV (csrc/host/warp.cpp) and their plain versions

WARP_LANES = 16  # pixels a step of cv2's vector warp loop (see csrc/host/warp.cpp)
HSV_LANES = 32   # pixels a step of cv2's vector HSV->BGR loop
BORDER = 114     # random_affine's borderValue, each channel


def _bind_warp(lib: ctypes.CDLL) -> None:
    u8, f64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double)
    lib.warp_affine_u8.restype = None
    lib.warp_affine_u8.argtypes = [u8, ctypes.c_int, ctypes.c_int, f64, u8, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.bgr_to_hsv_u8.restype = None
    lib.bgr_to_hsv_u8.argtypes = [u8, u8, ctypes.c_long]
    lib.hsv_to_bgr_u8.restype = None
    lib.hsv_to_bgr_u8.argtypes = [u8, u8, ctypes.c_int, ctypes.c_int]
    # probes: a half-pixel shift of [0, 255] lerps to cv2's 128 (127.5 to
    # even); BGR (0, 0, 255) is HSV (0, 255, 255) and back
    src = np.asarray([[[0, 0, 0], [255, 255, 255]]], np.uint8)
    m = np.asarray([[1.0, 0.0, -0.5], [0.0, 1.0, 0.0]])
    out = np.empty((1, 1, 3), np.uint8)
    lib.warp_affine_u8(host_build.ptr(src, ctypes.c_uint8), 1, 2,
                       host_build.ptr(m, ctypes.c_double), host_build.ptr(out, ctypes.c_uint8),
                       1, 1, 114)
    red = np.asarray([0, 0, 255], np.uint8)
    hsv, back = np.empty(3, np.uint8), np.empty(3, np.uint8)
    lib.bgr_to_hsv_u8(host_build.ptr(red, ctypes.c_uint8), host_build.ptr(hsv, ctypes.c_uint8), 1)
    lib.hsv_to_bgr_u8(host_build.ptr(hsv, ctypes.c_uint8), host_build.ptr(back, ctypes.c_uint8),
                      1, 1)
    if out.ravel().tolist() != [128] * 3 or hsv.tolist() != [0, 255, 255] \
            or back.tolist() != [0, 0, 255]:
        raise RuntimeError(f"libwarp probe failed: warp {out.ravel().tolist()}, hsv "
                           f"{hsv.tolist()}, back {back.tolist()}")


def _warp_lib() -> ctypes.CDLL:
    return host_build.load("warp", _bind_warp)


def fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as fmaf: the f64 product is exact and
    TwoSum gives the f64 sum's error, which settles the ties that rounding
    the sum to f32 would otherwise break wrongly."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    toward = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    tie = (d != 0) & (np.abs(d) * 2 == np.abs(toward.astype(np.float64) - r.astype(np.float64)))
    return np.where(tie & (e != 0) & (np.sign(e) == np.sign(d)), toward, r).astype(np.float32)


def _invert_affine(m) -> np.ndarray:
    """cv2.warpAffine's f64 inversion of the forward matrix, cast to f32."""
    M = np.asarray(m, np.float64).reshape(6).tolist()
    D = M[0] * M[4] - M[1] * M[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = M[4] * D, M[0] * D
    M[0], M[1], M[3], M[4] = a11, M[1] * -D, M[3] * -D, a22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return np.asarray(M, np.float32)


def warp_affine_plain(img: np.ndarray, m, dsize: Tuple[int, int]) -> np.ndarray:
    """The plain version of ``warp_affine``, whole arrays in f32."""
    F = _invert_affine(m)
    dw, dh = dsize
    sh, sw = img.shape[:2]
    f32 = np.float32
    x = np.arange(dw, dtype=f32)[None, :]
    y = np.arange(dh, dtype=f32)[:, None]
    vec = np.arange(dw)[None, :] < dw - dw % WARP_LANES
    rx, ry = (y * F[1]) + F[2], (y * F[4]) + F[5]
    sx = np.where(vec, fma32(F[0], x, rx), fma32(x, F[0], y * F[1]) + F[2])
    sy = np.where(vec, fma32(F[3], x, ry), fma32(x, F[3], y * F[4]) + F[5])
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)

    def tap(yy, xx):
        inside = ((xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh))[..., None]
        px = img[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)].astype(f32)
        return np.where(inside, px, f32(BORDER))

    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = fma32(a, p01 - p00, p00)
    v1 = fma32(a, p11 - p10, p10)
    return np.clip(np.rint(fma32(b, v1 - v0, v0)), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, m, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=(114, 114, 114))`` of an
    (H, W, 3) uint8 image (INTER_LINEAR, constant border); ``dsize`` is
    (width, height), as cv2 takes it."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"warp_affine takes (H, W, 3) uint8, got {img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    m = np.ascontiguousarray(m, np.float64).reshape(2, 3)
    out = np.empty((dsize[1], dsize[0], 3), np.uint8)
    _warp_lib().warp_affine_u8(host_build.ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                               host_build.ptr(m, ctypes.c_double),
                               host_build.ptr(out, ctypes.c_uint8), dsize[1], dsize[0], BORDER)
    return out


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    i[0] = 1
    sdiv = np.rint((255 << 12) / i).astype(np.int64)
    hdiv = np.rint((180 << 12) / (6 * i)).astype(np.int64)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


def bgr_to_hsv_plain(img: np.ndarray) -> np.ndarray:
    """The plain version of ``bgr_to_hsv``: OpenCV's 12-bit division tables."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr_plain(img: np.ndarray) -> np.ndarray:
    """The plain version of ``hsv_to_bgr``, whole arrays in f32."""
    f32 = np.float32
    h = img[..., 0].astype(f32)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h * f32(6.0 / 180), f32(6.0))
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    sector, h = np.where(bad, 0, sector), np.where(bad, f32(0), h)
    one = f32(1)
    tab = np.stack([v, v * (one - s), v * fma32(-s, h, one), v * fma32(-s, one - h, one)])
    order = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    idx = order[sector]  # (..., 3): the tab rows of b, g, r
    bgr = np.take_along_axis(np.moveaxis(tab, 0, -1), idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * f32(255)
    vec = (np.arange(img.shape[1]) < img.shape[1] - img.shape[1] % HSV_LANES)[None, :, None]
    return np.clip(np.where(vec, np.floor(bgr), np.rint(bgr)), 0, 255).astype(np.uint8)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of (H, W, 3) uint8."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    _warp_lib().bgr_to_hsv_u8(host_build.ptr(img, ctypes.c_uint8),
                              host_build.ptr(out, ctypes.c_uint8), img.size // 3)
    return out


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` of (H, W, 3) uint8."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty_like(img)
    _warp_lib().hsv_to_bgr_u8(host_build.ptr(img, ctypes.c_uint8),
                              host_build.ptr(out, ctypes.c_uint8), img.shape[0], img.shape[1])
    return out


# ----------------------------------------------------------------------------
# the training transforms (cocodet_tpu/data/transforms.py:40-191)

def augment_hsv(img: np.ndarray, hgain: float = 5, sgain: float = 30, vgain: float = 30,
                rng: Optional[random.Random] = None) -> None:
    """In-place random HSV jitter (transforms.py:40-51)."""
    rng = rng or random
    gains = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain]
    gains *= np.array([rng.randint(0, 1) for _ in range(3)])
    gains = gains.astype(np.int16)
    hsv = bgr_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + gains[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + gains[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + gains[2], 0, 255)
    img[...] = hsv_to_bgr(hsv.astype(img.dtype))


def _rand(value, center: float = 0.0, rng: Optional[random.Random] = None):
    rng = rng or random
    if isinstance(value, (int, float)):
        return rng.uniform(center - value, center + value)
    return rng.uniform(value[0], value[1])


def rotation_matrix_2d(angle: float, scale: float, center=(0.0, 0.0)) -> np.ndarray:
    """cv2.getRotationMatrix2D's f64 arithmetic (imgwarp.cpp)."""
    angle = angle * (math.pi / 180)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def get_affine_matrix(target_size: Tuple[int, int], degrees=10.0, translate=0.1, scales=0.1,
                      shear=10.0, rng: Optional[random.Random] = None):
    """Rotation + scale + shear + translate matrix and the scale
    (transforms.py:61-79)."""
    tw, th = target_size
    angle = _rand(degrees, rng=rng)
    scale = _rand(scales, center=1.0, rng=rng)
    if scale <= 0.0:
        raise ValueError("scale must be positive")
    rot = rotation_matrix_2d(angle, scale)
    m = np.ones((2, 3))
    shear_x = math.tan(_rand(shear, rng=rng) * math.pi / 180)
    shear_y = math.tan(_rand(shear, rng=rng) * math.pi / 180)
    m[0] = rot[0] + shear_y * rot[1]
    m[1] = rot[1] + shear_x * rot[0]
    m[0, 2] = _rand(translate, rng=rng) * tw
    m[1, 2] = _rand(translate, rng=rng) * th
    return m, scale


def apply_affine_to_bboxes(targets: np.ndarray, target_size, m: np.ndarray):
    """Warp xyxy boxes through m and clip them to the target
    (transforms.py:82-94)."""
    n = len(targets)
    tw, th = target_size
    corners = np.ones((4 * n, 3))
    corners[:, :2] = targets[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(4 * n, 2)
    corners = (corners @ m.T).reshape(n, 8)
    xs, ys = corners[:, 0::2], corners[:, 1::2]
    new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    new[:, 0::2] = new[:, 0::2].clip(0, tw)
    new[:, 1::2] = new[:, 1::2].clip(0, th)
    targets[:, :4] = new
    return targets


def random_affine(img, targets=(), target_size=(640, 640), degrees=10.0, translate=0.1,
                  scales=0.1, shear=10.0, rng: Optional[random.Random] = None):
    """transforms.py:97-105, ``cv2.warpAffine`` replaced by ``warp_affine``."""
    m, scale = get_affine_matrix(target_size, degrees, translate, scales, shear, rng)
    img = warp_affine(img, m, target_size)
    if len(targets) > 0:
        targets = apply_affine_to_bboxes(targets, target_size, m)
    return img, targets


def mirror(image: np.ndarray, boxes: np.ndarray, prob: float = 0.5,
           rng: Optional[random.Random] = None):
    """Horizontal flip (transforms.py:108-117)."""
    rng = rng or random
    _, width, _ = image.shape
    if rng.random() < prob:
        image = image[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


class TrainTransform:
    """HSV + flip + letterbox + label padding (transforms.py:148-191).

    Output: image (H, W, 3) float32, labels (max_labels, 5) [class, cx, cy,
    w, h] zero-padded."""

    def __init__(self, max_labels: int = 50, flip_prob: float = 0.5, hsv_prob: float = 1.0):
        self.max_labels = max_labels
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob

    def __call__(self, image: np.ndarray, targets: np.ndarray, input_dim: Tuple[int, int],
                 rng: Optional[random.Random] = None):
        rng = rng or random
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()
        if len(boxes) == 0:
            image, _ = letterbox(image, input_dim)
            return image, np.zeros((self.max_labels, 5), np.float32)

        image_o, targets_o = image.copy(), targets.copy()

        if rng.random() < self.hsv_prob:
            augment_hsv(image, rng=rng)
        image_t, boxes = mirror(image, boxes, self.flip_prob, rng=rng)
        image_t, r = letterbox(image_t, input_dim)
        boxes = xyxy2cxcywh(boxes) * r

        keep = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
        boxes_t, labels_t = boxes[keep], labels[keep]
        if len(boxes_t) == 0:
            # degenerate aug: fall back to the clean image (transforms.py:183-187)
            image_t, r_o = letterbox(image_o, input_dim)
            boxes_t = xyxy2cxcywh(targets_o[:, :4]) * r_o
            labels_t = targets_o[:, 4]

        merged = np.hstack([labels_t[:, None], boxes_t])
        padded = np.zeros((self.max_labels, 5), np.float32)
        padded[: min(len(merged), self.max_labels)] = merged[: self.max_labels]
        return image_t, np.ascontiguousarray(padded, np.float32)
