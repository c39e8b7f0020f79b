"""Carry weights across from the JAX package.

``load_variables`` takes the JAX model's ``variables`` as a nested dict of
numpy arrays (``{"params": ..., "batch_stats": ...}``, as
``jax.tree_util.tree_map(np.asarray, variables)`` gives them) and loads them
into a port model whose submodules are named after the flax scopes. One rule
per leaf:

    params/<scope>/kernel (HWIO)  -> <scope>.weight (OIHW)
    params/<scope>/bias           -> <scope>.bias
    params/<scope>/scale          -> <scope>.weight        (BatchNorm)
    batch_stats/<scope>/mean      -> <scope>.running_mean
    batch_stats/<scope>/var       -> <scope>.running_var
    quant/<scope>/w_scale         -> <scope>.w_scale       (w8a8 conv)
    quant/<scope>/act_scale       -> <scope>.act_scale     (w8a8 conv)
    masks/<scope>/mask/scale      -> <scope>.mask.scale    (ChannelMask)
    masks/<scope>/mask/offset     -> <scope>.mask.offset   (ChannelMask)
    masks/<scope>/conv/conv_mask  -> <scope>.conv.conv_mask (HWIO -> OIHW)

A quantized tree's int8 kernel goes into the w8a8 conv's int8 ``weight``
buffer, which is OIHW in channels-last memory (physically OHWI, the layout
of the int8 conv kernel). Its ``act_scale`` takes the shape of the
variables: a scalar (per-tensor) or a (cin,) vector (per-channel). The
``w_bits`` leaves of a bits=4 quant tree say how a checkpoint is packed,
which the runtime does not read; they are skipped. A ``"calib"`` conv's
``act_absmax`` buffer is state, not a variable: ``jax_layout`` lists it
under ``quant_stats``, as flax does, and ``load_variables`` leaves it alone.

The ``masks`` collection holds the ChannelMask gates of a ``use_mask``
model (``models/blocks.py::ChannelMask``, buffers) and the elementwise
``conv_mask`` kernel masks of the magnitude chain (``compress/
magnitude.py``). No port model reads a ``conv_mask`` (the weight-mask model
of SynFlow is not ported; flax's model without ``weight_mask`` ignores it
too): ``load_variables`` skips those leaves, and BN folding
(``ops/fuse.py``) multiplies them into the kernels.

``optimizer_state_dict``/``load_optimizer_state`` map the SGD's momentum
buffers to optax's trace and back, ``ema_variables``/``load_ema`` the EMA
shadow to flax ``{params, batch_stats}``, for checkpoints JAX reads.

Loading reference-layout (torch YOLOX) state dicts is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

_TO_TORCH = {("params", "kernel"): "weight", ("params", "bias"): "bias",
             ("params", "scale"): "weight",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var",
             ("quant", "w_scale"): "w_scale", ("quant", "act_scale"): "act_scale",
             ("masks", "scale"): "scale", ("masks", "offset"): "offset",
             ("masks", "conv_mask"): "conv_mask"}
_HWIO = ("kernel", "conv_mask")  # 4-D leaves that flax keeps HWIO
_SKIPPED = {("quant", "w_bits")}
_STATE = "act_absmax"  # quant_stats: filled by calibration, never loaded


def flatten_tree(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    flat: Dict[Path, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = value
    return flat


def unflatten_tree(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _torch_entries(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {name: t for name, t in model.state_dict(keep_vars=True).items()
            if not name.endswith("num_batches_tracked")}


def jax_path(name: str, value: torch.Tensor) -> Tuple[Path, Tuple[int, ...]]:
    """The flax ``(collection, *scope, leaf)`` path and shape of one entry of
    a port model's state dict."""
    *scope, leaf = name.split(".")
    shape = tuple(value.shape)
    if leaf in ("scale", "offset"):
        return ("masks", *scope, leaf), shape
    if leaf == "conv_mask":
        return ("masks", *scope, leaf), (shape[2], shape[3], shape[1], shape[0])
    if leaf == "weight" and value.dim() == 4:
        return ("params", *scope, "kernel"), (shape[2], shape[3], shape[1], shape[0])
    if leaf == "weight":
        return ("params", *scope, "scale"), shape
    if leaf == "bias":
        return ("params", *scope, "bias"), shape
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats", *scope, leaf[len("running_"):]), shape
    if leaf in ("w_scale", "act_scale"):
        return ("quant", *scope, leaf), shape
    if leaf == _STATE:
        return ("quant_stats", *scope, leaf), shape
    raise KeyError(f"no flax counterpart for {name}")


def jax_layout(model: nn.Module) -> Dict[Path, Tuple[int, ...]]:
    """``{(collection, *scope, leaf): shape}`` of the flax variables that the
    model's state dict corresponds to."""
    return dict(jax_path(n, t) for n, t in _torch_entries(model).items())


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax variables -> ``{torch state-dict name: numpy array}``."""
    out: Dict[str, np.ndarray] = {}
    for path, value in flatten_tree(variables).items():
        if (path[0], path[-1]) in _SKIPPED:
            continue
        rule = _TO_TORCH.get((path[0], path[-1]))
        if rule is None:
            raise KeyError(f"no port counterpart for flax variable {'/'.join(path)}")
        arr = np.asarray(value)
        if path[-1] in _HWIO:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join(path[1:-1] + (rule,))] = arr
    return out


def load_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place (dtype, device and
    memory format of the model's tensors are kept). Raises on any missing or
    unused entry and on any shape mismatch. An ``act_scale`` buffer takes
    the shape of its variable, a scalar or one scale per input channel.
    ``conv_mask`` leaves, which no port model reads, are skipped."""
    arrays = convert_variables(variables)
    targets = {n: t for n, t in _torch_entries(model).items()
               if not n.endswith(_STATE)}
    for name in [n for n in arrays if n.endswith(".conv_mask") and n not in targets]:
        del arrays[name]
    missing = sorted(set(targets) - set(arrays))
    unused = sorted(set(arrays) - set(targets))
    if missing or unused:
        raise KeyError(f"variables do not match the model: missing {missing[:8]}"
                       f" ({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for name, t in targets.items():
        shape = tuple(arrays[name].shape)
        if name.endswith("act_scale"):
            conv = model.get_submodule(name[: -len(".act_scale")])
            if shape in ((), (conv.weight.shape[1] * conv.groups,)):
                conv.act_scale = torch.empty(shape, dtype=t.dtype, device=t.device)
                targets[name] = conv.act_scale
                continue
        if shape != tuple(t.shape):
            raise ValueError(f"{name}: shape {shape} from the "
                             f"variables, {tuple(t.shape)} in the model")
        if (arrays[name].dtype == np.int8) != (t.dtype == torch.int8):
            raise TypeError(f"{name}: {arrays[name].dtype} from the variables, "
                            f"{t.dtype} in the model (an int8 kernel needs a "
                            f"model built with quant='w8a8', and only it)")
    with torch.no_grad():
        for name, t in targets.items():
            t.copy_(torch.tensor(arrays[name]))
    return model


def random_variables(model: nn.Module, seed: int,
                     prior_prob: Optional[float] = None) -> Dict[str, Any]:
    """Flax-layout variables for ``model`` drawn from a numpy seed: conv
    kernels U(+-sqrt(3/fan_in)) (unit gain, so the head maps of the full
    model stay of order 1-30 on 0-255 images), biases U(+-0.1), BN scale and
    var U(0.5, 1.5), BN bias and mean N(0, 0.1), all f32. Non-trivial BN
    statistics make BN folding do real work. A w8a8 conv gets int8 kernels
    U{-127..127} with ``w_scale`` sqrt(3/fan_in)/127 and a scalar
    ``act_scale`` U(0.1, 0.3) (an activation range of about 13-38).

    With ``prior_prob`` (training: 0.01) the head's cls and obj prediction
    biases are ``logit(prior_prob) = -log((1 - p) / p)``, the focal prior of
    cocodet_tpu/models/head.py:76-82 (blocks.py:97-103)."""
    rng = np.random.default_rng(seed)
    flat: Dict[Path, np.ndarray] = {}
    for name, t in _torch_entries(model).items():
        path, shape = jax_path(name, t)
        leaf = path[-1]
        if path[0] == "quant_stats":
            continue
        if path[0] == "masks":  # every gate open; no draw, so the rest equals
            flat[path] = np.full(shape, 1.0 if leaf == "scale" else 0.0, np.float32)
            continue
        if leaf == "kernel" and t.dtype == torch.int8:
            flat[path] = rng.integers(-127, 128, shape).astype(np.int8)
            continue
        if leaf == "kernel":
            bound = np.sqrt(3.0 / np.prod(shape[:3]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "w_scale":
            kernel = model.get_submodule(name[: -len(".w_scale")]).weight
            v = np.full(shape, np.sqrt(3.0 / np.prod(kernel.shape[1:])) / 127.0)
        elif leaf == "act_scale":
            v = rng.uniform(0.1, 0.3, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias" and path[-2] != "bn":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        if (prior_prob is not None and leaf == "bias"
                and path[-2].startswith(("cls_pred", "obj_pred"))):
            v = np.full(shape, -math.log((1.0 - prior_prob) / prior_prob))
        flat[path] = v.astype(np.float32)
    return unflatten_tree(flat)


def export_tensors(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{state-dict name: tensor}`` -> a flax-layout tree of numpy copies
    (kernels HWIO)."""
    flat: Dict[Path, np.ndarray] = {}
    for name, t in named.items():
        path, _ = jax_path(name, t)
        arr = t.detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        if path[-1] in _HWIO:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[path] = np.array(arr, order="C")  # a copy: the model trains on in place
    return unflatten_tree(flat)


def export_variables(model: nn.Module) -> Dict[str, Any]:
    """The inverse of ``load_variables``: the model's parameters and
    buffers as a flax-layout tree of numpy arrays (``{"params": ...,
    "batch_stats": ...}``, and ``"masks"`` for a ``use_mask`` model; kernels
    HWIO), so a port model's state compares leaf by leaf with a flax
    variable tree."""
    return export_tensors(_torch_entries(model))


def mask_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{state-dict name: buffer}`` of the model's ChannelMask gates."""
    return {n: t for n, t in _torch_entries(model).items()
            if n.endswith((".mask.scale", ".mask.offset"))}


def export_masks(model: nn.Module) -> Dict[str, Any]:
    """The model's ``masks`` collection as a flax-layout tree ({} for a
    model without ChannelMask gates)."""
    return export_tensors(mask_tensors(model)).get("masks", {})


def load_masks(model: nn.Module, masks: Mapping[str, Any]) -> None:
    """Copy a ``masks`` tree into the model's ChannelMask buffers (every
    gate of the model must be in it; ``conv_mask`` leaves are skipped)."""
    flat = {k: v for k, v in flatten_tree(masks).items() if k[-1] != "conv_mask"}
    load_tensors(mask_tensors(model), {"masks": unflatten_tree(flat)})


def load_tensors(named: Mapping[str, torch.Tensor], tree: Mapping[str, Any]) -> None:
    """The inverse of ``export_tensors``: copy a flax-layout tree into the
    named tensors in place (their dtype and device kept). Raises on a
    missing or unused leaf and on a shape mismatch."""
    arrays = convert_variables(tree)
    missing = sorted(set(named) - set(arrays))
    unused = sorted(set(arrays) - set(named))
    if missing or unused:
        raise KeyError(f"tree does not match: missing {missing[:8]} ({len(missing)}), "
                       f"unused {unused[:8]} ({len(unused)})")
    with torch.no_grad():
        for name, t in named.items():
            if tuple(arrays[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {arrays[name].shape} in the tree, "
                                 f"{tuple(t.shape)} here")
            t.copy_(torch.tensor(arrays[name]))


# --------------------------------------------------------------------------
# the optimizer and the EMA
# --------------------------------------------------------------------------


def optimizer_state_dict(optimizer, model: nn.Module) -> Dict[str, Any]:
    """The port's SGD (``core/train_state.py::SGD``) as the state dict of
    optax's ``chain(add_decayed_weights(wd, mask), sgd(schedule, momentum,
    nesterov=True))`` (flax ``to_state_dict``): ``{"0": {"inner_state": {}},
    "1": {"0": {"trace": params}, "1": {"count": int32}}}``. optax's trace
    and torch's ``momentum_buffer`` both hold ``g + momentum * buf``; a
    parameter that has taken no step has a zero trace."""
    buffers = {}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        buffers[name] = torch.zeros_like(p) if buf is None else buf
    trace = export_tensors(buffers)["params"]
    return {"0": {"inner_state": {}},
            "1": {"0": {"trace": trace}, "1": {"count": np.asarray(optimizer.count, np.int32)}}}


def load_optimizer_state(optimizer, model: nn.Module, state: Mapping[str, Any]) -> None:
    """Set the SGD's momentum buffers and step count from optax's state dict
    (``optimizer_state_dict``'s layout, as a JAX checkpoint holds it)."""
    named = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in model.named_parameters()}
    load_tensors(named, {"params": state["1"]["0"]["trace"]})
    for name, p in model.named_parameters():
        optimizer.state[p]["momentum_buffer"] = named[name].to(p.dtype)
    optimizer.count = int(np.asarray(state["1"]["1"]["count"]))


def ema_variables(ema) -> Dict[str, Any]:
    """The EMA shadow (``utils/ema.py::ModelEMA``) as flax ``{params,
    batch_stats}``, JAX's ``EMAState.shadow``."""
    return export_tensors(ema.shadow)


def load_ema(ema, variables: Mapping[str, Any]) -> None:
    """Set the EMA shadow from flax ``{params, batch_stats}``."""
    load_tensors(ema.shadow, variables)
