"""Checkpoints in the JAX package's format (cocodet_tpu/utils/checkpoint.py):
one msgpack file a tree, ``<name>_ckpt.msgpack`` (and a ``best_ckpt.msgpack``
copy), byte-compatible with ``flax.serialization`` through the port's own
codec (``utils/msgpack.py``).

A trainer checkpoint is ``{start_epoch, model, raw_model, opt_state,
best_ap}``: ``model`` the EMA shadow and ``raw_model`` the live weights, both
flax ``{params, batch_stats}`` trees (``utils/convert.py``), ``opt_state``
optax's state dict of ``chain(add_decayed_weights, sgd(nesterov))``. Every
leaf is written as ``np.asarray`` of it, as JAX's ``save_checkpoint`` does,
so a file the port writes is one JAX's ``load_checkpoint`` reads, and the
other way round. Nibble-packed int4 trees raise (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Mapping

import numpy as np

from .convert import flatten_tree, unflatten_tree
from .msgpack import dumps_tree, loads_tree

logger = logging.getLogger("cocodet_tpu_torch")
INT4_MARK = "__int4_packed__"  # cocodet_tpu/compress/quantize.py:228


def _as_arrays(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _as_arrays(v) for k, v in tree.items()}
    return tree if tree is None else np.asarray(tree)


def save_checkpoint(state: Mapping[str, Any], is_best: bool, save_dir: str,
                    model_name: str = "latest") -> str:
    """Write ``<model_name>_ckpt.msgpack`` (and the best copy) under
    ``save_dir``; returns its path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{model_name}_ckpt.msgpack")
    data = dumps_tree(_as_arrays(state))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, "best_ckpt.msgpack"))
    return path


def tree_has_int4(tree: Mapping[str, Any]) -> bool:
    return any(path[-1] == INT4_MARK for path in flatten_tree(tree))


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        tree = loads_tree(f.read())
    if isinstance(tree, dict) and tree_has_int4(tree):
        raise NotImplementedError(f"{path}: nibble-packed int4 checkpoints are not ported "
                                  "(ROADMAP Queue 1 item 6)")
    return tree


def load_matched(target: Mapping[str, Any], ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """Shape-checked partial load (checkpoint.py:56-77): leaves present in
    both trees with equal shapes come from ``ckpt`` (int8 kept as int8, else
    cast to the target's dtype); the rest keep ``target``'s, with a
    warning."""
    c_flat = flatten_tree(ckpt)
    out = {}
    for k, v in flatten_tree(target).items():
        c = c_flat.get(k)
        name = "/".join(map(str, k))
        if c is None:
            logger.warning("ckpt missing %s; keeping init", name)
            out[k] = v
        elif tuple(np.shape(c)) != tuple(np.shape(v)):
            logger.warning("shape mismatch for %s: ckpt %s vs model %s; keeping init", name,
                           np.shape(c), np.shape(v))
            out[k] = v
        elif np.asarray(c).dtype == np.int8:
            out[k] = np.asarray(c)
        else:
            out[k] = np.asarray(c, dtype=np.asarray(v).dtype) if hasattr(v, "dtype") else c
    return unflatten_tree(out)
