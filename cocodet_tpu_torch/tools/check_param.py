"""A checkpoint's conv-kernel magnitudes (tools/check_param.py): the |w|
CDF at ``--bins`` quantiles and the share a hard cut at ``--threshold``
would remove. Prints the JAX tool's lines:

    python -m cocodet_tpu_torch.tools.check_param -c outputs/exp/best_ckpt.msgpack

Reads the msgpack through ``utils/checkpoint.py::load_checkpoint`` (its
``model`` tree, or the file's), on the host; no card is needed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np


def make_parser():
    ap = argparse.ArgumentParser("check_param")
    ap.add_argument("-c", "--ckpt", required=True)
    ap.add_argument("--threshold", type=float, default=0.001)
    ap.add_argument("--bins", type=int, default=20)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Prints and returns the lines."""
    args = make_parser().parse_args(argv)

    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint
    from cocodet_tpu_torch.utils.convert import flatten_tree

    ckpt = load_checkpoint(args.ckpt)
    tree = ckpt.get("model", ckpt)
    params = tree.get("params", tree)
    kernels = [np.abs(np.asarray(v)).ravel() for k, v in flatten_tree(params).items()
               if k[-1] == "kernel" and np.ndim(v) == 4]
    allw = np.concatenate(kernels)

    lines = [f"{allw.size:,} conv weights | mean |w| {allw.mean():.4e} | max {allw.max():.4e}"]
    qs = np.percentile(allw, np.linspace(0, 100, args.bins + 1))
    counts, _ = np.histogram(allw, bins=qs)
    cum = 0
    for i in range(args.bins):
        cum += counts[i]
        lines.append(f"  |w| < {qs[i + 1]:.4e}: {100 * cum / allw.size:5.1f}% cum")
    below = int((allw < args.threshold).sum())
    lines.append(f"hard cut |w| < {args.threshold}: removes {below:,} "
                 f"({100 * below / allw.size:.1f}%)")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
