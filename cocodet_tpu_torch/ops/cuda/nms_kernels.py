"""NMS kernels: overlap matrix and exact greedy keep.

``overlap_matrix`` ports the Pallas TPU kernel
cocodet_tpu/ops/pallas/nms_kernels.py::overlap_matrix; ``greedy_keep``
replaces the XLA loops of cocodet_tpu/ops/nms.py::_greedy_keep and
_greedy_keep_tiled. Both kernels are in ``cocodet_tpu_torch/csrc/
nms_kernels.cu`` (see its header for their bounds and design).

Each wrapper takes the plain PyTorch version for tensors on the CPU, and
only there. For CUDA tensors it launches the kernel or raises; it never falls
back. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..boxes import pairwise_iou
from . import build

_SOURCE = "nms_kernels"
MAX_KEEP_K = 32768  # greedy_keep holds K flag bytes in shared memory


def overlap_matrix_plain(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """(B, K, K) f32 0/1: IoU > thr and r < c and valid[r] and valid[c]."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes.device)
    order = torch.arange(k, device=boxes.device)
    hit = (iou > thr) & (order[:, None] < order[None, :])
    hit = hit & valid[..., :, None] & valid[..., None, :]
    return hit.to(torch.float32)


def greedy_keep_plain(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K) bool exact sequential greedy keep over a strictly
    upper-triangular (B, K, K) overlap matrix: walk the rows in score order;
    a row that is valid and not yet removed is kept and removes every column
    its row marks. One step per row, batched over images, no host sync."""
    hits = overlap != 0
    removed = ~valid
    keep = torch.zeros_like(valid)
    for r in range(valid.shape[-1]):
        take = ~removed[:, r]
        keep[:, r] = take
        removed = removed | (take[:, None] & hits[:, r, :])
    return keep


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_overlap_matrix.argtypes = [p, p, p, i, i, ctypes.c_float, p]
    lib.cocodet_overlap_matrix.restype = i
    lib.cocodet_greedy_keep.argtypes = [p, p, p, i, i, p]
    lib.cocodet_greedy_keep.restype = i
    return lib


def overlap_matrix(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """(B, K, K) f32 0/1 strictly upper-triangular overlap matrix of
    score-sorted xyxy ``boxes`` (B, K, 4) f32 with ``valid`` (B, K) bool."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return overlap_matrix_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"overlap_matrix runs on cpu or cuda, not {boxes.device}")
    b, k, _ = boxes.shape
    _check_cuda("boxes", boxes, torch.float32, (b, k, 4), boxes.device)
    _check_cuda("valid", valid, torch.bool, (b, k), boxes.device)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    out = torch.empty((b, k, k), dtype=torch.float32, device=boxes.device)
    if b * k == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_overlap_matrix(
            boxes.data_ptr(), valid.data_ptr(), out.data_ptr(), b, k,
            float(iou_threshold), stream)
    _raise_on(rc, "overlap_matrix")
    overlap_matrix.launches += 1
    return out


overlap_matrix.launches = 0


def greedy_keep(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K) bool exact greedy keep mask from ``overlap_matrix`` output."""
    if overlap.dim() != 3 or overlap.shape[-1] != overlap.shape[-2]:
        raise ValueError(f"overlap must be (B, K, K), got {tuple(overlap.shape)}")
    if overlap.device.type == "cpu":
        return greedy_keep_plain(overlap, valid)
    if overlap.device.type != "cuda":
        raise ValueError(f"greedy_keep runs on cpu or cuda, not {overlap.device}")
    b, k, _ = overlap.shape
    if k > MAX_KEEP_K:
        raise ValueError(f"greedy_keep takes K <= {MAX_KEEP_K}, got {k}")
    _check_cuda("overlap", overlap, torch.float32, (b, k, k), overlap.device)
    _check_cuda("valid", valid, torch.bool, (b, k), overlap.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=overlap.device)
    if b * k == 0:
        return keep
    with torch.cuda.device(overlap.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_greedy_keep(
            overlap.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, stream)
    _raise_on(rc, "greedy_keep")
    greedy_keep.launches += 1
    return keep


greedy_keep.launches = 0


def reset_launch_counts() -> None:
    overlap_matrix.launches = 0
    greedy_keep.launches = 0
