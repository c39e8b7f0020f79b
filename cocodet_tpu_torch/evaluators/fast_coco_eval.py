"""ctypes binding of the native COCO eval kernels (``csrc/host/cocoeval.cpp``,
a copy of the JAX package's), the port's counterpart of
cocodet_tpu/layers/fast_coco_eval/__init__.py:99-137: ``match_image`` (the
plain version is ``coco_metric.match_image``) and ``accumulate_pr``. The
library is built at first use (``ops/host_build.py``) and probed once; a
failed build or probe raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import host_build

_ptr = host_build.ptr


def _bind(lib: ctypes.CDLL) -> None:
    lib.match_image.restype = None
    lib.match_image.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.accumulate_pr.restype = None
    lib.accumulate_pr.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    # probe: one det at IoU 0.9 with one GT matches it at threshold 0.5
    ious = np.asarray([[0.9]], np.float64)
    thrs = np.asarray([0.5], np.float64)
    dm = np.full((1, 1), 7, np.int64)
    di = np.empty((1, 1), np.uint8)
    z = np.zeros(1, np.uint8)
    lib.match_image(_ptr(ious, ctypes.c_double), 1, 1, _ptr(z, ctypes.c_uint8),
                    _ptr(z, ctypes.c_uint8), _ptr(thrs, ctypes.c_double), 1,
                    _ptr(dm, ctypes.c_int64), _ptr(di, ctypes.c_uint8))
    if int(dm[0, 0]) != 0:
        raise RuntimeError(f"libcocoeval probe failed: match {int(dm[0, 0])}, want 0")


def load() -> ctypes.CDLL:
    return host_build.load("cocoeval", _bind)


def match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                gt_crowd: np.ndarray, iou_thrs: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Native greedy matching; same contract as coco_metric.match_image."""
    lib = load()
    nd, ng = ious.shape
    nt = len(iou_thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    g_ign = np.ascontiguousarray(gt_ignore, np.uint8)
    g_crd = np.ascontiguousarray(gt_crowd, np.uint8)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    dt_match = np.empty((nt, nd), np.int64)
    dt_ignore = np.empty((nt, nd), np.uint8)
    lib.match_image(
        _ptr(ious, ctypes.c_double), nd, ng,
        _ptr(g_ign, ctypes.c_uint8), _ptr(g_crd, ctypes.c_uint8),
        _ptr(thrs, ctypes.c_double), nt,
        _ptr(dt_match, ctypes.c_int64), _ptr(dt_ignore, ctypes.c_uint8))
    return dt_match, dt_ignore.astype(bool)


def accumulate_pr(matched: np.ndarray, ignored: np.ndarray, npig: int,
                  recall_thrs: np.ndarray) -> Tuple[np.ndarray, float]:
    lib = load()
    nd = len(matched)
    m = np.ascontiguousarray(matched, np.uint8)
    ig = np.ascontiguousarray(ignored, np.uint8)
    rt = np.ascontiguousarray(recall_thrs, np.float64)
    prec = np.empty(len(rt), np.float64)
    rec = ctypes.c_double(0.0)
    lib.accumulate_pr(
        _ptr(m, ctypes.c_uint8), _ptr(ig, ctypes.c_uint8), nd,
        int(npig), _ptr(rt, ctypes.c_double), len(rt),
        _ptr(prec, ctypes.c_double), ctypes.byref(rec))
    return prec, rec.value
