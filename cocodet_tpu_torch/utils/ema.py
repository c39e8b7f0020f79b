"""Exponential moving average of a model's parameters and BN statistics
(cocodet_tpu/utils/ema.py:24-41): an f32 shadow with the ramp
``d(t) = decay * (1 - exp(-t / 2000))`` (ref yolox/utils/ema.py:48-58).

The shadow is a dict of f32 tensors on the model's device, keyed by the
model's state-dict names; an update is two fused multi-tensor ops and no
host sync (the ramp is computed on the host from the update count)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn


def ema_entries(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors the EMA follows: every parameter and the BN running
    statistics (flax's ``params`` and ``batch_stats``)."""
    out = dict(model.named_parameters())
    out.update({n: b for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


def ema_decay(decay: float, updates: int) -> float:
    """The ramp at update ``updates`` (1-based), in f32 as JAX computes it."""
    f32 = np.float32
    return float(f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(2000.0))))


class ModelEMA:
    """The f32 shadow of ``ema_entries(model)`` and its update count."""

    def __init__(self, model: nn.Module, decay: float = 0.9998):
        self.decay = decay
        self.updates = 0
        live = ema_entries(model)
        self.shadow = {n: t.detach().float().clone() for n, t in live.items()}
        self._live: List[torch.Tensor] = list(live.values())

    @torch.no_grad()
    def update(self) -> None:
        """shadow = shadow * d + live * (1 - d), with d the ramp at the new
        count."""
        self.updates += 1
        d = ema_decay(self.decay, self.updates)
        shadow = list(self.shadow.values())
        live = [t.float() for t in self._live]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, live, alpha=1.0 - d)
