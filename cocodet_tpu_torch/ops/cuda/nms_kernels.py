"""NMS kernels: bit-packed overlap matrix and exact greedy keep.

Both kernels are in ``cocodet_tpu_torch/csrc/nms_kernels.cu``, whose header
gives their design in full.

The overlap matrix travels bit-packed: ``mask`` is a contiguous (B, K, W)
int64 tensor, W = ceil(K / 64) rounded up to an even number
(``packed_width``), so each row is a multiple of 16 bytes. Bit j of
``mask[b, r, w]`` (bit 63 is the sign bit) is set iff, for c = 64 w + j,
``IoU(r, c) > thr and r < c and valid[r] and valid[c]``. Bits past K are 0,
and so are the words wholly below the diagonal.

- ``overlap_matrix`` ports the Pallas TPU kernel
  cocodet_tpu/ops/pallas/nms_kernels.py::overlap_matrix. On the H100 it is
  bound by operations (~20 f32 ops a pair above the diagonal: 2.5 us at
  B=16, K=1024). A block computes one 64 x 64 tile on or above the diagonal
  and no tile below it; a branch-free pass marks the pairs that can exceed
  the threshold, and the IEEE division decides only those.
- ``greedy_keep`` replaces the XLA loops of cocodet_tpu/ops/nms.py::
  _greedy_keep and _greedy_keep_tiled. Its byte bound (the upper words of
  the kept rows) is far below the chain of K dependent row decisions that
  it must make. One warp walks an image; the rows come into shared memory
  64 at a time by TMA bulk copies through a ring, ahead of the walk, and
  the removed bits stay in shared memory beside it.

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
WORD_BITS = 64
# greedy_keep holds the W removed words and two chunks of 64 rows x W words
# in a block's 227 KB of shared memory: W <= 224.
MAX_KEEP_K = 14336


def packed_width(k: int) -> int:
    """Words W of a packed overlap row for K boxes: ceil(K / 64), made even."""
    w = -(-k // WORD_BITS)
    return w + w % 2


def _pack_bits(flags: torch.Tensor, w: int) -> torch.Tensor:
    """(..., N) bool -> (..., w) int64, flag 64 i + j in bit j of word i."""
    padded = torch.zeros(flags.shape[:-1] + (w * WORD_BITS,), dtype=torch.bool,
                         device=flags.device)
    padded[..., :flags.shape[-1]] = flags
    bits = padded.view(flags.shape[:-1] + (w, WORD_BITS))
    words = torch.zeros(flags.shape[:-1] + (w,), dtype=torch.int64, device=flags.device)
    for j in range(WORD_BITS):
        words |= bits[..., j].to(torch.int64) << j
    return words


def unpack_overlap(mask: torch.Tensor) -> torch.Tensor:
    """(B, K, W) packed mask -> the (B, K, K) f32 0/1 overlap matrix."""
    b, k, w = mask.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=mask.device)
    bits = (mask[..., None] >> shifts) & 1
    return bits.reshape(b, k, w * WORD_BITS)[..., :k].to(torch.float32)


def overlap_matrix_plain(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """(B, K, W) int64 packed mask: IoU > thr and r < c and valid[r] and
    valid[c], with the arithmetic of ``pairwise_iou``."""
    k = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    thr = torch.full((), iou_threshold, dtype=torch.float32, device=boxes.device)
    order = torch.arange(k, device=boxes.device)
    hit = (iou > thr) & (order[:, None] < order[None, :])
    hit = hit & valid[..., :, None] & valid[..., None, :]
    return _pack_bits(hit, packed_width(k))


def greedy_keep_plain(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K) bool exact sequential greedy keep over a packed (B, K, W) mask:
    walk the rows in score order; a row that is valid and not yet removed is
    kept and removes every column its row marks. One step per row, batched
    over images, the removed flags kept packed; no host sync."""
    b, k, w = mask.shape
    removed = _pack_bits(~valid, w)
    keep = torch.empty((b, k), dtype=torch.bool, device=mask.device)
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    for r in range(k):
        take = ((removed[:, r // WORD_BITS] >> (r % WORD_BITS)) & 1) == 0
        keep[:, r] = take
        removed |= torch.where(take[:, None], mask[:, r], zero)
    return keep


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device,
                align: int = 1):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_overlap_mask.argtypes = [p, p, p, i, i, i, ctypes.c_float, p]
    lib.cocodet_overlap_mask.restype = i
    lib.cocodet_greedy_keep.argtypes = [p, p, p, i, i, i, p]
    lib.cocodet_greedy_keep.restype = i
    return lib


def overlap_matrix(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """(B, K, W) int64 packed overlap mask (layout in the module docstring)
    of score-sorted xyxy ``boxes`` (B, K, 4) f32 with ``valid`` (B, K) bool."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return overlap_matrix_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"overlap_matrix runs on cpu or cuda, not {boxes.device}")
    b, k, _ = boxes.shape
    w = packed_width(k)
    _check_cuda("boxes", boxes, torch.float32, (b, k, 4), boxes.device, align=16)
    _check_cuda("valid", valid, torch.bool, (b, k), boxes.device)
    out = torch.empty((b, k, w), dtype=torch.int64, device=boxes.device)
    if b * k == 0:
        return out
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_overlap_mask(
            boxes.data_ptr(), valid.data_ptr(), out.data_ptr(), b, k, w,
            float(iou_threshold), stream)
    _raise_on(rc, "overlap_matrix")
    overlap_matrix.launches += 1
    return out


overlap_matrix.launches = 0


def greedy_keep(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K) bool exact greedy keep mask from ``overlap_matrix``'s packed
    (B, K, W) int64 mask and ``valid`` (B, K) bool."""
    if mask.dim() != 3:
        raise ValueError(f"mask must be (B, K, W), got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return greedy_keep_plain(mask, valid)
    if mask.device.type != "cuda":
        raise ValueError(f"greedy_keep runs on cpu or cuda, not {mask.device}")
    b, k, w = mask.shape
    if k > MAX_KEEP_K:
        raise ValueError(f"greedy_keep takes K <= {MAX_KEEP_K}, got {k}")
    _check_cuda("mask", mask, torch.int64, (b, k, packed_width(k)), mask.device,
                align=16)  # read by TMA bulk copies
    _check_cuda("valid", valid, torch.bool, (b, k), mask.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=mask.device)
    if b * k == 0:
        return keep
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_greedy_keep(
            mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, w, stream)
    _raise_on(rc, "greedy_keep")
    greedy_keep.launches += 1
    return keep


greedy_keep.launches = 0


def reset_launch_counts() -> None:
    overlap_matrix.launches = 0
    greedy_keep.launches = 0
