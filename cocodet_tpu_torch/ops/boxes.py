"""Box algebra (cocodet_tpu/ops/boxes.py:15-49), batched tensor functions."""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """COCO json format: top-left + size."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], -1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, xyxy: bool = True) -> torch.Tensor:
    """IoU of every box in ``a`` (..., N, 4) against every box in ``b``
    (..., M, 4); returns (..., N, M). The same operations in the same order
    as the JAX function, so f32 results agree bit for bit."""
    if not xyxy:
        a = cxcywh_to_xyxy(a)
        b = cxcywh_to_xyxy(b)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def iou_cxcywh(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12):
    """Elementwise IoU of aligned (..., 4) cxcywh boxes, with the union and
    enclosing areas for the GIoU loss (cocodet_tpu/ops/boxes.py:52-75), in
    the JAX function's order of operations. Returns (iou, union, enclose)."""
    p_tl = pred[..., :2] - pred[..., 2:] * 0.5
    p_br = pred[..., :2] + pred[..., 2:] * 0.5
    t_tl = target[..., :2] - target[..., 2:] * 0.5
    t_br = target[..., :2] + target[..., 2:] * 0.5

    wh = (torch.minimum(p_br, t_br) - torch.maximum(p_tl, t_tl)).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_p = pred[..., 2] * pred[..., 3]
    area_t = target[..., 2] * target[..., 3]
    union = area_p + area_t - inter
    iou = inter / (union + eps)

    c_wh = torch.maximum(p_br, t_br) - torch.minimum(p_tl, t_tl)
    enclose = c_wh[..., 0] * c_wh[..., 1]
    return iou, union, enclose
