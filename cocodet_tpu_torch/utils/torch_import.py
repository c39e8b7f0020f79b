"""Reference (PyTorch YOLOX) checkpoints to flax-layout trees and back
(cocodet_tpu/utils/torch_import.py).

The reference writes its weights as torch state dicts: ``tools/train.py``
checkpoints (the ``model`` entry), the BN-folded zoos of ``merge_save*.py``
and the sparse-COO ``merged_49.pth`` of ``03_jh_merge.py:66-87``.
``convert_state_dict`` turns one into the JAX package's tree of numpy arrays
(``params`` and, where present, ``batch_stats``), which ``utils/convert.py``
loads into a port model as it loads any flax tree; ``export_state_dict``
writes a tree back in the reference's naming. The names and tensors follow
the JAX functions exactly:

  backbone.backbone.stem.conv            -> backbone/backbone/stem/conv
  backbone.backbone.darkN.0              -> backbone/backbone/darkN_down
  backbone.backbone.darkN.{1|2} (SPP/CSP)-> backbone/backbone/darkN_{spp|csp}
  CSP: conv1/conv2/conv3/m.i             -> conv1/conv2/conv3/m{i}
  PAFPN (L levels): lateral_conv0 -> lateral{L-1}, lateral_conv1 ->
    lateral{L-2}, reduce_conv1 -> lateral1, C3_p5/C3_p4/C3_p3 ->
    td_csp{3,2,1}, C3_n3/C3_n4/C3_n5 -> bu_csp{1,2,3},
    bu_conv2/bu_conv1/bu_conv0 -> bu_conv{1,2,3}
  head: stems.k -> stem{k}, cls_convs.k.j -> cls_conv{k}_{j}, reg_convs
    likewise, {cls,reg,obj}_preds.k -> {cls,reg,obj}_pred{k}

``module.``/``model.`` prefixes are stripped, ``num_batches_tracked`` is
skipped, sparse COO tensors are densified, conv kernels go OIHW -> HWIO, BN
weight/bias/running_mean/running_var -> scale/bias/mean/var.

``num_levels`` defaults to 4, as in JAX. The JAX harness and eval CLI call
``load_torch_checkpoint`` without it, so on a 3-level model JAX maps
``lateral_conv0`` to ``lateral3``, a leaf the model does not have (ROADMAP
Queue 3); the port's callers pass the level count of the model they load
into.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .convert import flatten_tree, unflatten_tree
from .logger import logger


def _map_pafpn_name(part: str, num_levels: int) -> str:
    l = num_levels
    table = {
        "lateral_conv0": f"lateral{l - 1}",
        "lateral_conv1": f"lateral{l - 2}",
        "reduce_conv1": "lateral1",
        "C3_p5": "td_csp3",
        "C3_p4": "td_csp2",
        "C3_p3": "td_csp1",
        "C3_n3": "bu_csp1",
        "C3_n4": "bu_csp2",
        "C3_n5": "bu_csp3",
        "bu_conv2": "bu_conv1",
        "bu_conv1": "bu_conv2",
        "bu_conv0": "bu_conv3",
    }
    return table.get(part, part)


def _map_backbone_stage(stage: str, idx: str, has_spp: bool) -> str:
    """darkN.{0,1,2} -> darkN_{down,spp?,csp}."""
    i = int(idx)
    if i == 0:
        return f"{stage}_down"
    if has_spp:
        return f"{stage}_spp" if i == 1 else f"{stage}_csp"
    return f"{stage}_csp"


# the stage that holds the SPP block, per variant (models/darknet.py)
_SPP_STAGES = {
    "standard": {"dark5"},
    "custom": {"dark5"},
    "p6": {"dark6"},
    "p6v2": {"dark6"},
}


def map_torch_key(key: str, variant: str = "p6",
                  num_levels: int = 4) -> Tuple[Tuple[str, ...], str]:
    """One torch state-dict key -> (flax path, collection); the collection is
    "params", "batch_stats" or "skip" (num_batches_tracked)."""
    if key.endswith("num_batches_tracked"):
        return (), "skip"
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "backbone" and i <= 1:
            out.append("backbone")
            i += 1
            continue
        if re.fullmatch(r"dark\d", p) and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(_map_backbone_stage(p, parts[i + 1], p in _SPP_STAGES[variant]))
            i += 2
            continue
        if p == "stem" and parts[i + 1] == "conv":
            out.append("stem")
            i += 1
            continue
        if p == "m" and parts[i + 1].isdigit():
            out.append(f"m{parts[i + 1]}")
            i += 2
            continue
        if p in ("stems", "cls_convs", "reg_convs", "cls_preds", "reg_preds", "obj_preds"):
            k = parts[i + 1]
            if p == "stems":
                out.append(f"stem{k}")
                i += 2
            elif p in ("cls_convs", "reg_convs"):
                out.append(f"{p[:-1]}{k}_{parts[i + 2]}")
                i += 3
            else:
                out.append(f"{p[:-1]}{k}")
                i += 2
            continue
        out.append(_map_pafpn_name(p, num_levels))
        i += 1

    leaf = out[-1]
    if len(out) >= 2 and out[-2] == "bn":
        rename = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                  "running_var": "var"}
        out[-1] = rename[leaf]
        return tuple(out), "batch_stats" if leaf.startswith("running") else "params"
    if leaf == "weight":
        out[-1] = "kernel"
    return tuple(out), "params"


def convert_state_dict(state_dict: Dict[str, Any], variant: str = "p6",
                       num_levels: int = 4) -> Dict[str, Any]:
    """A torch state dict (``model.``/``module.`` prefixes, sparse COO
    tensors allowed) -> ``{"params": ..., "batch_stats": ...}`` of numpy
    arrays (``batch_stats`` only where the dict has BN statistics)."""
    flat: Dict[str, Dict[Tuple[str, ...], np.ndarray]] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        for pre in ("module.", "model."):
            if key.startswith(pre):
                key = key[len(pre):]
        if isinstance(value, torch.Tensor):
            if value.is_sparse:
                value = value.to_dense()
            value = value.detach().cpu().numpy()
        path, coll = map_torch_key(key, variant, num_levels)
        if coll == "skip":
            continue
        if path[-1] == "kernel" and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat[coll][path] = value
    out = {"params": unflatten_tree(flat["params"])}
    if flat["batch_stats"]:
        out["batch_stats"] = unflatten_tree(flat["batch_stats"])
    return out


def load_torch_checkpoint(path: str, variant: str = "p6",
                          num_levels: int = 4) -> Dict[str, Any]:
    """``convert_state_dict`` of a ``.pth`` file: a reference training
    checkpoint's ``model`` entry, or the file's own state dict. The file is
    read with ``weights_only=True``: tensors (dense or sparse), numbers,
    strings and containers, no arbitrary pickled objects."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if "weights_only" not in str(e).lower().replace(" ", "_"):
            raise
        raise ValueError(f"{path}: the file holds objects other than tensors, numbers and "
                         f"containers; the port reads .pth files with weights_only=True "
                         f"and loads no arbitrary pickles") from e
    state = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    logger.info("importing %d torch tensors from %s", len(state), path)
    return convert_state_dict(state, variant, num_levels)


# --------------------------------------------------------------------------
# flax-layout tree -> reference torch state dict
# --------------------------------------------------------------------------


def _inv_pafpn_name(part: str, num_levels: int) -> str:
    l = num_levels
    table = {
        f"lateral{l - 1}": "lateral_conv0",
        f"lateral{l - 2}": "lateral_conv1",
        "lateral1": "reduce_conv1",
        "td_csp3": "C3_p5",
        "td_csp2": "C3_p4",
        "td_csp1": "C3_p3",
        "bu_csp1": "C3_n3",
        "bu_csp2": "C3_n4",
        "bu_csp3": "C3_n5",
        "bu_conv1": "bu_conv2",
        "bu_conv2": "bu_conv1",
        "bu_conv3": "bu_conv0",
    }
    return table.get(part, part)


def map_flax_path(path: Tuple[str, ...], collection: str, variant: str = "p6",
                  num_levels: int = 4) -> str:
    """The inverse of ``map_torch_key``: flax (path, collection) -> torch key."""
    parts = []
    for comp in path[:-1]:
        m = re.fullmatch(r"(dark\d)_(down|spp|csp)", comp)
        if m:
            stage, kind = m.groups()
            idx = {"down": 0, "spp": 1, "csp": 2 if stage in _SPP_STAGES[variant] else 1}[kind]
            parts.append(f"{stage}.{idx}")
            continue
        m = re.fullmatch(r"m(\d+)", comp)
        if m:
            parts.append(f"m.{m.group(1)}")
            continue
        m = re.fullmatch(r"(cls|reg)_conv(\d+)_(\d+)", comp)
        if m:
            t, k, j = m.groups()
            parts.append(f"{t}_convs.{k}.{j}")
            continue
        m = re.fullmatch(r"(cls|reg|obj)_pred(\d+)", comp)
        if m:
            parts.append(f"{m.group(1)}_preds.{m.group(2)}")
            continue
        m = re.fullmatch(r"stem(\d+)", comp)
        if m:
            parts.append(f"stems.{m.group(1)}")
            continue
        parts.append(_inv_pafpn_name(comp, num_levels))

    leaf = path[-1]
    if collection == "batch_stats":
        parts.append({"mean": "running_mean", "var": "running_var"}[leaf])
    elif len(path) >= 2 and path[-2] == "bn":
        parts.append({"scale": "weight", "bias": "bias"}[leaf])
    else:
        parts.append({"kernel": "weight", "bias": "bias"}.get(leaf, leaf))
    return ".".join(parts)


def export_state_dict(variables: Dict[str, Any], variant: str = "p6",
                      num_levels: int = 4) -> Dict[str, torch.Tensor]:
    """A flax-layout tree -> a torch state dict in the reference's naming
    (f32 tensors, conv kernels OIHW), loadable by the reference's YOLOX
    models with ``strict=False`` for their ``num_batches_tracked``."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, v in flatten_tree(variables.get(coll, {})).items():
            key = map_flax_path(path, coll, variant, num_levels)
            arr = np.asarray(v, np.float32)
            if path[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
