"""Grid decode helpers (cocodet_tpu/ops/decode.py:22-26)."""

from __future__ import annotations

from typing import Union

import torch


def level_grid(h: int, w: int, dtype: torch.dtype = torch.float32,
               device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """(h*w, 2) xy grid coordinates, row-major with x fastest."""
    yv, xv = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xv, yv], dim=-1).reshape(-1, 2)
