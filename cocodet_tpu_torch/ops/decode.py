"""Grid decode of raw head outputs (cocodet_tpu/ops/decode.py:22-89)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch


def level_grid(h: int, w: int, dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(h*w, 2) xy grid coordinates, row-major with x fastest."""
    yv, xv = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xv, yv], dim=-1).reshape(-1, 2)


def flatten_level(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NHWC head maps {reg, obj, cls} -> (B, H*W, 5+C) in [reg, obj, cls]
    order."""
    b, h, w, _ = out["reg"].shape
    cat = torch.cat([out["reg"], out["obj"], out["cls"]], dim=-1)
    return cat.reshape(b, h * w, -1)


def attach_strides(outputs: Sequence[Dict[str, torch.Tensor]],
                   stride_list: Sequence[int]) -> List[dict]:
    return [dict(o, stride=s) for o, s in zip(outputs, stride_list)]


def concat_levels(outputs: Sequence[dict]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level head maps (each with its ``stride``) -> anchor-major
    (preds (B, A, 5+C), grids (A, 2) f32, strides (A,) f32)."""
    preds, grids, strides = [], [], []
    for out in outputs:
        _, h, w, _ = out["reg"].shape
        device = out["reg"].device
        preds.append(flatten_level(out))
        grids.append(level_grid(h, w, device=device))
        strides.append(torch.full((h * w,), float(out["stride"]), device=device))
    return torch.cat(preds, dim=1), torch.cat(grids), torch.cat(strides)


def decode_center_format(preds: torch.Tensor, grids: torch.Tensor,
                         strides: torch.Tensor) -> torch.Tensor:
    """Training-space decode to (cx, cy, w, h) in input pixels:
    xy = (p + grid) * stride, wh = exp(p) * stride; the other channels pass."""
    f32 = preds.float()
    s = strides[None, :, None]
    xy = (f32[..., :2] + grids[None]) * s
    wh = torch.exp(f32[..., 2:4]) * s
    return torch.cat([xy, wh, f32[..., 4:]], dim=-1)


def decode_corner_scores(preds: torch.Tensor, grids: torch.Tensor,
                         strides: torch.Tensor):
    """Inference decode (cocodet_tpu/ops/decode.py:72-89): corner boxes and
    sigmoid scores. Returns (boxes_xyxy (B, A, 4), obj (B, A, 1),
    cls (B, A, C) already multiplied by obj), f32. The wh logits are clamped
    to [-20, 20] before exp, so an untrained model's boxes stay finite."""
    f32 = preds.float()
    s = strides[None, :, None]
    xy = (f32[..., :2] + grids[None]) * s
    half_wh = torch.exp(f32[..., 2:4].clamp(-20.0, 20.0)) * (s * 0.5)
    boxes = torch.cat([xy - half_wh, xy + half_wh], dim=-1)
    one = torch.ones((), dtype=torch.float32, device=preds.device)
    obj = (one / (1.0 + torch.exp(-f32[..., 4:5]))).clamp(0.0, 1.0)
    cls = (one / (1.0 + torch.exp(-f32[..., 5:]))).clamp(0.0, 1.0) * obj
    return boxes, obj, cls
