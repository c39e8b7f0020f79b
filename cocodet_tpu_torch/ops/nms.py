"""Fixed-shape, batched, exact greedy NMS (cocodet_tpu/ops/nms.py).

The JAX package resolves the greedy keep mask with a lax.while_loop fixpoint
(K % 512 != 0) or a tile-sequential lax.scan (K % 512 == 0); both give the
exact sequential greedy result. The port takes one device path at every K:
the overlap-matrix kernel, which writes the overlap matrix bit-packed
((B, K, W) int64, W = ceil(K / 64) made even; no (B, K, K) tensor), then the
greedy-keep kernel on those words (``ops/cuda/nms_kernels.py``), then the
compaction (``compact``), with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.nms_kernels import greedy_keep, overlap_matrix


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (..., max_det, 4) xyxy
    scores: torch.Tensor   # (..., max_det)
    classes: torch.Tensor  # (..., max_det) int32
    obj: torch.Tensor      # (..., max_det) objectness of kept boxes
    valid: torch.Tensor    # (..., max_det) bool


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Per-class coordinate offset so cross-class IoU is exactly 0
    (nms.py:189-199), per image of (B, K, 4) f32 boxes. The span ignores
    invalid and non-finite boxes, so one bad box cannot poison every offset."""
    finite = torch.isfinite(boxes).all(dim=-1)
    masked = torch.where((valid & finite)[..., None], boxes.abs(),
                         torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    span = masked.amax(dim=(-2, -1)) + 1.0                      # (B,)
    offset = classes.to(boxes.dtype)[..., None] * span[:, None, None]
    return boxes + offset


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    obj: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.65,
    max_det: int = 300,
    class_agnostic: bool = False,
    soft: bool = False,
) -> NMSResult:
    """NMS for a batch of (B, K, ...) score-sorted candidates.

    Kept rows are compacted to the front in their original order, capped at
    ``max_det`` and padded with invalid rows (nms.py:217-238).
    """
    if soft:
        raise NotImplementedError("soft-NMS is not ported yet")
    if boxes.dim() != 3:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    valid = valid.contiguous()
    nms_boxes = boxes if class_agnostic else class_offset_boxes(boxes, classes, valid)
    keep = greedy_keep(overlap_matrix(nms_boxes.contiguous(), valid, iou_threshold), valid)
    return compact(keep, boxes, scores, classes, obj, max_det)


def compact(keep: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
            classes: torch.Tensor, obj: torch.Tensor, max_det: int) -> NMSResult:
    """The kept rows of (B, K, ...) candidates moved to the front in their
    original order, capped at ``max_det`` and padded with invalid rows."""
    b, k = keep.shape
    # A stable ascending sort of ~keep puts the kept rows first and the rest
    # after, each in index order: the order of the JAX top_k over rank_val.
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    m = min(max_det, k)
    take = order[:, :m]
    in_range = torch.arange(m, device=keep.device)[None, :] < keep.sum(dim=1, keepdim=True)
    pad = max_det - m

    def gather(t: torch.Tensor, fill) -> torch.Tensor:
        idx = take if t.dim() == 2 else take[..., None].expand(-1, -1, t.shape[-1])
        g = torch.gather(t, 1, idx)
        mask = in_range if t.dim() == 2 else in_range[..., None]
        g = torch.where(mask, g, torch.full((), fill, dtype=g.dtype, device=g.device))
        if pad:
            g = torch.cat([g, torch.full((b, pad) + g.shape[2:], fill,
                                         dtype=g.dtype, device=g.device)], dim=1)
        return g

    return NMSResult(
        boxes=gather(boxes, 0.0),
        scores=gather(scores, 0.0),
        classes=gather(classes.to(torch.int32), -1),
        obj=gather(obj, 0.0),
        valid=gather(keep, False),
    )


def nms_single(boxes, scores, classes, obj, valid, iou_threshold: float = 0.65,
               max_det: int = 300, class_agnostic: bool = False,
               soft: bool = False) -> NMSResult:
    """NMS for one image: (K, ...) inputs, (max_det, ...) outputs."""
    res = batched_nms(boxes[None], scores[None], classes[None], obj[None],
                      valid[None], iou_threshold, max_det, class_agnostic, soft)
    return NMSResult(*(t[0] for t in res))
