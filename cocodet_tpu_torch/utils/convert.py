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

Loading reference-layout (torch YOLOX) state dicts is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

_TO_TORCH = {("params", "kernel"): "weight", ("params", "bias"): "bias",
             ("params", "scale"): "weight",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    flat: Dict[Path, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = value
    return flat


def _unflatten(flat: Mapping[Path, Any]) -> Dict[str, Any]:
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
    if leaf == "weight" and value.dim() == 4:
        return ("params", *scope, "kernel"), (shape[2], shape[3], shape[1], shape[0])
    if leaf == "weight":
        return ("params", *scope, "scale"), shape
    if leaf == "bias":
        return ("params", *scope, "bias"), shape
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats", *scope, leaf[len("running_"):]), shape
    raise KeyError(f"no flax counterpart for {name}")


def jax_layout(model: nn.Module) -> Dict[Path, Tuple[int, ...]]:
    """``{(collection, *scope, leaf): shape}`` of the flax variables that the
    model's state dict corresponds to."""
    return dict(jax_path(n, t) for n, t in _torch_entries(model).items())


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax variables -> ``{torch state-dict name: numpy array}``."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(variables).items():
        rule = _TO_TORCH.get((path[0], path[-1]))
        if rule is None:
            raise KeyError(f"no port counterpart for flax variable {'/'.join(path)}")
        arr = np.asarray(value)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join(path[1:-1] + (rule,))] = arr
    return out


def load_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place (dtype, device and
    memory format of the model's tensors are kept). Raises on any missing or
    unused entry and on any shape mismatch."""
    arrays = convert_variables(variables)
    targets = _torch_entries(model)
    missing = sorted(set(targets) - set(arrays))
    unused = sorted(set(arrays) - set(targets))
    if missing or unused:
        raise KeyError(f"variables do not match the model: missing {missing[:8]}"
                       f" ({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for name, t in targets.items():
        if tuple(arrays[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(arrays[name].shape)} from the "
                             f"variables, {tuple(t.shape)} in the model")
    with torch.no_grad():
        for name, t in targets.items():
            t.copy_(torch.from_numpy(np.ascontiguousarray(arrays[name])))
    return model


def random_variables(model: nn.Module, seed: int) -> Dict[str, Any]:
    """Flax-layout variables for ``model`` drawn from a numpy seed: conv
    kernels U(+-sqrt(3/fan_in)) (unit gain, so the head maps of the full
    model stay of order 1-30 on 0-255 images), biases U(+-0.1), BN scale and
    var U(0.5, 1.5), BN bias and mean N(0, 0.1), all f32. Non-trivial BN
    statistics make BN folding do real work."""
    rng = np.random.default_rng(seed)
    flat: Dict[Path, np.ndarray] = {}
    for path, shape in jax_layout(model).items():
        leaf = path[-1]
        if leaf == "kernel":
            bound = np.sqrt(3.0 / np.prod(shape[:3]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias" and path[-2] != "bn":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        flat[path] = v.astype(np.float32)
    return _unflatten(flat)
