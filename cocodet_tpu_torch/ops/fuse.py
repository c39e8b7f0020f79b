"""Conv-BN folding (cocodet_tpu/ops/fuse.py:28-83, conv+BN only) and the
cross-replica mean of the BN statistics (:151).

W' = W * gamma/sqrt(var+eps) per output channel,
b' = beta - gamma*mean/sqrt(var+eps) (+ gamma/sqrt(var+eps) * conv bias).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from ..models.yolox import YOLOX
from ..parallel.collectives import all_reduce_

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


@torch.no_grad()
def bn_stats_allreduce(model: torch.nn.Module, group: Any = None) -> None:
    """The cross-replica mean of every BN running statistic, in place
    (cocodet_tpu/ops/fuse.py:151): one all-reduce of the flattened
    statistics over ``group``, divided by its size."""
    stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    if not stats:
        return
    flat = all_reduce_(torch.cat([s.reshape(-1) for s in stats]), group)
    flat /= dist.get_world_size(group)
    for s, v in zip(stats, flat.split([s.numel() for s in stats])):
        s.copy_(v.view_as(s))
