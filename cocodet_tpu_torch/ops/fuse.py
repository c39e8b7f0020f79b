"""Conv-BN folding (cocodet_tpu/ops/fuse.py:28-83, conv+BN only).

W' = W * gamma/sqrt(var+eps) per output channel,
b' = beta - gamma*mean/sqrt(var+eps) (+ gamma/sqrt(var+eps) * conv bias).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.yolox import YOLOX

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def fuse_batchnorm(state_dict: Dict[str, torch.Tensor],
                   eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Map the state dict of an unfused model onto that of the same model
    built with ``fused=True``. Every ``<scope>.conv.weight`` with a
    ``<scope>.bn`` beside it is folded, in f32; other entries pass through."""
    fused: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if ".bn." in name:
            continue
        if not name.endswith(".conv.weight"):
            fused[name] = value
            continue
        scope = name[: -len(".conv.weight")]
        if f"{scope}.bn.weight" not in state_dict:
            fused[name] = value
            continue
        scale, beta, mean, var = (state_dict[f"{scope}.bn.{leaf}"].float()
                                  for leaf in _BN_LEAVES)
        inv_std = torch.rsqrt(var + eps)
        w = value.float() * (scale * inv_std)[:, None, None, None]
        b = beta - scale * mean * inv_std
        conv_bias = state_dict.get(f"{scope}.conv.bias")
        if conv_bias is not None:
            b = b + scale * inv_std * conv_bias.float()
        fused[name] = w.to(value.dtype)
        fused[f"{scope}.conv.bias"] = b.to(value.dtype)
    return fused


def fuse_model(model: YOLOX) -> YOLOX:
    """The ``fused=True`` twin of an unfused YOLOX, with BN folded in, on the
    model's device and in its parameter dtype, channels-last, in eval mode."""
    if model.fused:
        raise ValueError("model is already fused")
    ref = next(model.parameters())
    with torch.device("meta"):  # no init: every weight is loaded below
        fused = YOLOX(model.spec, num_classes=model.num_classes,
                      depth=model.depth, width=model.width, fused=True,
                      dtype=model.dtype, slim=model.slim)
    fused = fused.to_empty(device=ref.device).to(
        dtype=ref.dtype, memory_format=torch.channels_last)
    fused.load_state_dict(fuse_batchnorm(model.state_dict()))
    return fused.eval()
