"""The offline magnitude chain, steps 01 and 02 of the reference
(cocodet_tpu/compress/magnitude.py): a global magnitude threshold over the
conv kernels outside the head, and the masks it gives injected into a
checkpoint's ``masks`` collection as ``conv_mask`` leaves.

numpy on the host, on flax-layout trees, as in JAX: the same arrays give the
same threshold and the same masks.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..utils.convert import flatten_tree, unflatten_tree

logger = logging.getLogger("cocodet_tpu_torch")


def _eligible(params, exclude_scopes):
    return {path: np.asarray(w) for path, w in flatten_tree(params).items()
            if path[-1] == "kernel" and np.ndim(w) == 4
            and not any(s in path for s in exclude_scopes)}


def _threshold(eligible, prune_ratio: float) -> float:
    all_w = np.concatenate([np.abs(w).ravel() for w in eligible.values()])
    k = int(round(all_w.size * prune_ratio))
    return np.partition(all_w, k)[k] if 0 < k < all_w.size else -np.inf


def magnitude_threshold(params: Mapping[str, Any], prune_ratio: float = 0.49,
                        exclude_scopes: Tuple[str, ...] = ("head",)) -> float:
    """The global threshold of ``generate_magnitude_masks``: a weight is
    kept where its |w| is above it."""
    return _threshold(_eligible(params, exclude_scopes), prune_ratio)


def generate_magnitude_masks(params: Mapping[str, Any], prune_ratio: float = 0.49,
                             exclude_scopes: Tuple[str, ...] = ("head",),
                             verbose: bool = True) -> Dict[str, Any]:
    """Global magnitude masks over the 4-D conv kernels outside
    ``exclude_scopes`` (magnitude.py:27-62): the threshold is the
    ``round(n * prune_ratio)``-th smallest |w| (``np.partition``), and a
    weight is kept (1.0) where |w| is above it. Returns a ``masks`` tree of
    ``conv_mask`` leaves beside each kernel."""
    eligible = _eligible(params, exclude_scopes)
    thresh = _threshold(eligible, prune_ratio)
    masks = {}
    total_kept = total = 0
    for path, w in eligible.items():
        m = (np.abs(w) > thresh).astype(np.float32)
        masks[path[:-1] + ("conv_mask",)] = m
        nnz, n = int(m.sum()), m.size
        total_kept += nnz
        total += n
        if verbose:
            # the sparse-COO break-even check of ref 01_mask_generator.py:40-44
            useful = "useful" if nnz * 5 < n else "NOT worth sparse storage"
            logger.info("%-60s nnz %d/%d (%.1f%%) [%s]", "/".join(path[:-1]), nnz, n,
                        100 * nnz / n, useful)
    logger.info("global: kept %d/%d (%.2f%%) at threshold %.3e", total_kept, total,
                100 * total_kept / max(total, 1), thresh)
    return unflatten_tree(masks)


def inject_masks(variables: Mapping[str, Any], masks: Mapping[str, Any]) -> Dict[str, Any]:
    """Step 02: the variables with ``masks`` merged into their ``masks``
    collection (magnitude.py:65-71)."""
    out = dict(variables)
    existing = flatten_tree(out.get("masks", {}))
    existing.update(flatten_tree(masks))
    out["masks"] = unflatten_tree(existing)
    return out


def sparsity_report(variables: Mapping[str, Any]) -> Dict[str, Tuple[int, int]]:
    """``{"a/b/kernel": (effective nonzero, total)}`` for every parameter: a
    kernel with a ``conv_mask`` counts the mask's ones (magnitude.py:74-85)."""
    masks = flatten_tree(variables.get("masks", {}))
    report = {}
    for path, w in flatten_tree(variables["params"]).items():
        m = masks.get(path[:-1] + ("conv_mask",))
        n = int(np.prod(np.shape(w)))
        report["/".join(path)] = (int(np.asarray(m).sum()) if m is not None else n, n)
    return report
