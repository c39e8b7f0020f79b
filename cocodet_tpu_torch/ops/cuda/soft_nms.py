"""Gaussian soft-NMS score decay (cocodet_tpu/ops/nms.py::_soft_keep_scores,
:157-175).

For B images of K score-sorted, class-offset candidates, every valid row i
multiplies the score of each later row j by ``exp(-(iou(i, j) ** 2) /
sigma)``, sigma 0.5, in the order of i. The decay does not read the running
scores, so each row's result is its own product of factors, taken in i
order. After each multiply a result below the smallest normal f32 is
flushed to zero, as XLA computes it on the CPU and the TPU: in a cluster of
some 55 overlapping same-class rows the product leaves the normal range,
and whether a row is kept (``s > 0``) turns on that flush. The IoU
threshold plays no part, in JAX or here.

``soft_decay`` runs ``csrc/soft_nms.cu::soft_decay_kernel`` for CUDA
tensors: producer warps compute a tile's factors, skipping the division and
``expf`` of finite pairs that do not overlap (their factor is exactly 1),
and one lane a column multiplies the factors that are not 1 in row order,
``/ 0.5`` taken as the exact ``* 2`` (the source's header has the design,
why each rewrite is exact and the bound counted from the data). Its plain
version, ``soft_decay_plain``, runs for CPU tensors only. It never falls
back; its launches are counted in ``soft_decay.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..boxes import pairwise_iou
from . import build

_SOURCE = "soft_nms"
SIGMA = 0.5
FLT_MIN = torch.finfo(torch.float32).tiny


def _flush(s: torch.Tensor) -> torch.Tensor:
    """Values below FLT_MIN in magnitude become zeros of their sign."""
    return torch.where(s.abs() < FLT_MIN, s * 0.0, s)


def soft_decay_plain(boxes: torch.Tensor, valid: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """(B, K) decayed scores of (B, K, 4) xyxy ``boxes`` (class-offset,
    score-sorted), ``valid`` (B, K) bool and ``scores`` (B, K) f32: the
    kernel's chain in PyTorch ops, one row i at a time, each product rounded
    and flushed as the kernel does."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    decay = torch.exp(-(iou * iou) / SIGMA)                         # (B, K, K)
    one = torch.ones((), dtype=decay.dtype, device=decay.device)
    s = _flush(scores.clone())
    for i in range(k - 1):
        factor = torch.where(valid[:, i, None], decay[:, i, i + 1:], one)
        s[:, i + 1:] = _flush(s[:, i + 1:] * factor)
    return s


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_soft_decay.argtypes = [p, p, p, p, i, i, p]
    lib.cocodet_soft_decay.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def soft_decay(boxes: torch.Tensor, valid: torch.Tensor,
               scores: torch.Tensor) -> torch.Tensor:
    """(B, K) f32 decayed scores (module docstring) of ``boxes`` (B, K, 4)
    f32, ``valid`` (B, K) bool and ``scores`` (B, K) f32."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return soft_decay_plain(boxes, valid, scores)
    if boxes.device.type != "cuda":
        raise ValueError(f"soft_decay runs on cpu or cuda, not {boxes.device}")
    b, k, _ = boxes.shape
    _check("boxes", boxes, torch.float32, (b, k, 4), boxes.device)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    _check("valid", valid, torch.bool, (b, k), boxes.device)
    _check("scores", scores, torch.float32, (b, k), boxes.device)
    out = torch.empty((b, k), dtype=torch.float32, device=boxes.device)
    if b * k == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_soft_decay(boxes.data_ptr(), valid.data_ptr(), scores.data_ptr(),
                                       out.data_ptr(), b, k, stream)
    if rc != 0:
        raise RuntimeError(f"soft_decay kernel launch failed: CUDA error {rc}")
    soft_decay.launches += 1
    return out


soft_decay.launches = 0


def reset_launch_counts() -> None:
    soft_decay.launches = 0
