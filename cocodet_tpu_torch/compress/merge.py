"""Channel-slim specs (cocodet_tpu/compress/merge.py:445-480).

``merge_for_deployment`` and ``slim_channels``, which derive a spec from
the Pruner's masks, are not ported yet: the port builds a slim model from a
committed spec (``artifacts/mp6_chain_slim_spec.json``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ..utils.convert import flatten_tree


def load_slim_spec(path: str) -> Dict[str, Any]:
    """Read a slim-spec json (int keys restored) for build_model(slim=...)."""
    with open(path) as f:
        raw = json.load(f)

    def _conv(k, d):
        if isinstance(d, int):  # stem/down/lateral/bu_conv width
            return d
        if k == "head":         # head: {conv_name: width}
            return dict(d)
        # csp table: int bottleneck keys -> (hid, out); "c2" -> bypass width
        return {(int(i) if str(i).lstrip("-").isdigit() else i):
                (tuple(v) if isinstance(v, (list, tuple)) else v)
                for i, v in d.items()}

    return {k: _conv(k, d) for k, d in raw.items()}


def count_effective_params(variables: Mapping[str, Any],
                           masks: Optional[Mapping[str, Any]] = None
                           ) -> Tuple[int, int]:
    """(effective nonzero, total) across the tree's params; a conv with a
    ``conv_mask`` counts the mask's ones."""
    mflat = flatten_tree(masks) if masks else {}
    total = eff = 0
    for path, w in flatten_tree(variables["params"]).items():
        total += int(np.prod(np.shape(w)))
        m = mflat.get(path[:-1] + ("conv_mask",))
        if m is not None:
            eff += int(np.asarray(m).sum())
        else:
            eff += int(np.count_nonzero(np.asarray(w)))
    return eff, total
