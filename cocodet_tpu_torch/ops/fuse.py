"""Conv-BN folding (cocodet_tpu/ops/fuse.py:28-80), the Focus stem as one
6x6 conv (``fold_focus_stem``, :86-135, and its w8a8 scales,
``fold_focus_quant``, :138-148) and the cross-replica mean of the BN
statistics (:151).

W' = W * gamma/sqrt(var+eps) per output channel,
b' = beta - gamma*mean/sqrt(var+eps) (+ gamma/sqrt(var+eps) * conv bias);
then an elementwise ``conv_mask`` multiplies W', and a ChannelMask gate
(scale s, offset o) gives W' * s and b' * s + o * (1 - s).

``fuse_batchnorm`` folds a torch state dict; ``fuse_batchnorm_tree`` is the
same fold on a flax-layout variable tree (JAX's ``fuse_batchnorm``'s
signature), through the state dict.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..models.yolox import YOLOX
from ..parallel.collectives import all_reduce_
from ..utils.convert import convert_variables, export_tensors, flatten_tree, unflatten_tree

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_MASK_LEAVES = (".mask.scale", ".mask.offset", ".conv.conv_mask")


def fuse_batchnorm(state_dict: Dict[str, torch.Tensor],
                   eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Map the state dict of an unfused model onto that of the same model
    built with ``fused=True``. Every ``<scope>.conv.weight`` with a
    ``<scope>.bn`` beside it is folded, in f32, with its ``conv_mask`` and
    ChannelMask gate if there are; other entries pass through, the masks
    do not."""
    fused: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if ".bn." in name or name.endswith(_MASK_LEAVES):
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
        wmask = state_dict.get(f"{scope}.conv.conv_mask")
        if wmask is not None:
            w = w * wmask.float()
        s = state_dict.get(f"{scope}.mask.scale")
        if s is not None:
            s = s.float()
            w = w * s[:, None, None, None]
            b = b * s + state_dict[f"{scope}.mask.offset"].float() * (1.0 - s)
        fused[name] = w.to(value.dtype)
        fused[f"{scope}.conv.bias"] = b.to(value.dtype)
    return fused


def fuse_batchnorm_tree(variables: Dict[str, Any], eps: float = 1e-3) -> Dict[str, Any]:
    """JAX's ``fuse_batchnorm`` (cocodet_tpu/ops/fuse.py:28-80) on a
    flax-layout tree of numpy arrays ``{"params", "batch_stats"[, "masks"]}``:
    ``{"params": ...}`` of the same model built with ``fused=True``, the
    ``conv_mask`` and ChannelMask gates folded in (``fuse_batchnorm``)."""
    named = {n: torch.from_numpy(np.array(a))
             for n, a in convert_variables(variables).items()}
    return {"params": export_tensors(fuse_batchnorm(named, eps))["params"]}


def fold_focus_stem(params: Dict[str, Any], order: str = "pixel_unshuffle") -> Dict[str, Any]:
    """A fused flax-layout ``params`` tree with its Focus stem (the 3x3 conv
    on the space-to-depth images, ``backbone/backbone/stem/conv/conv``)
    rewritten as the one 6x6 stride-2 conv of a ``stem6`` model
    (``backbone/backbone/stem/conv``) (cocodet_tpu/ops/fuse.py:86-135).

    Space-to-depth puts pixel (2p + i, 2q + j) of channel c at half-res
    (p, q) in channel ch(i, j, c), so the 3x3 conv's tap (u, v) on it is
    the 6x6 kernel's tap (2u + i, 2v + j) on the image, with the Focus
    conv's half-res padding of 1 becoming a padding of 2. ``order`` is the
    stem's channel order (``models/darknet.py::_FOCUS_ORDER``):
    ``pixel_unshuffle`` ch = c*4 + i*2 + j, ``slice_cat`` ch = (j*2 + i)*C +
    c. A permutation of the kernel's entries: exact in every dtype."""
    flat = dict(flatten_tree(params))
    stem = ("backbone", "backbone", "stem")
    kpath = stem + ("conv", "conv", "kernel")
    if kpath not in flat:
        raise KeyError("params has no fused Focus stem (backbone/backbone/stem/conv/conv)")
    k3 = np.asarray(flat.pop(kpath))
    kh, kw, c4, w = k3.shape
    if (kh, kw) != (3, 3) or c4 % 4:
        raise ValueError(f"a Focus stem kernel is (3, 3, 4c, out), not {k3.shape}")
    c = c4 // 4
    if order == "pixel_unshuffle":  # (u, v, c, i, j, o) -> (u, i, v, j, c, o)
        k6 = k3.reshape(3, 3, c, 2, 2, w).transpose(0, 3, 1, 4, 2, 5)
    elif order == "slice_cat":      # (u, v, j, i, c, o) -> (u, i, v, j, c, o)
        k6 = k3.reshape(3, 3, 2, 2, c, w).transpose(0, 3, 1, 2, 4, 5)
    else:
        raise ValueError(order)
    flat[stem + ("conv", "kernel")] = k6.reshape(6, 6, c, w)
    bias = flat.pop(stem + ("conv", "conv", "bias"), None)
    if bias is not None:
        flat[stem + ("conv", "bias")] = bias
    return unflatten_tree(flat)


def fold_focus_quant(quant: Dict[str, Any]) -> Dict[str, Any]:
    """A w8a8 ``quant`` collection re-homed for a ``fold_focus_stem``'d
    tree (cocodet_tpu/ops/fuse.py:138-148): the stem's scales move from
    ``backbone/backbone/stem/conv/conv`` to ``backbone/backbone/stem/conv``,
    their values unchanged (the same input values, the same per-out-channel
    kernels). A per-channel stem ``act_scale`` (one scale per Focus channel,
    which no ``quantize_model`` writes) does not broadcast over the 6x6
    conv's 3 input channels: it raises here, where JAX's w8a8 conv raises at
    its first call."""
    out = {}
    for path, v in flatten_tree(quant).items():
        if path[:5] == ("backbone", "backbone", "stem", "conv", "conv"):
            if path[-1] == "act_scale" and np.ndim(v):
                raise ValueError(f"Incompatible shapes for broadcasting: a per-channel stem "
                                 f"act_scale of shape {np.shape(v)} against the 6x6 stem's 3 "
                                 f"input channels (the Focus stem's scale stays per-tensor)")
            path = path[:4] + path[5:]
        out[path] = v
    return unflatten_tree(out)


def fuse_model(model: YOLOX) -> YOLOX:
    """The ``fused=True`` twin of an unfused YOLOX, with BN (and a
    ``use_mask`` model's gates) folded in, on the model's device and in its
    parameter dtype, channels-last, in eval mode."""
    if model.fused:
        raise ValueError("model is already fused")
    ref = next(model.parameters())
    with torch.device("meta"):  # no init: every weight is loaded below
        fused = YOLOX(model.spec, num_classes=model.num_classes,
                      depth=model.depth, width=model.width, fused=True,
                      dtype=model.dtype, slim=model.slim, split_cat=model.split_cat)
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
