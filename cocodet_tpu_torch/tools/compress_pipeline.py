"""The offline compression pipeline (tools/compress_pipeline.py) on the
port: steps 01 -> 02 -> 03 of the reference in one tool, on the host.

    python -m cocodet_tpu_torch.tools.compress_pipeline -c best_ckpt.msgpack \
        -o weights/ --ratio 0.49 [--slim]

- 01, the masks: a global magnitude threshold at ``--ratio`` over the conv
  kernels outside the head -> ``mask_<r>_ckpt.msgpack``;
- 02, inject: the checkpoint's variables with them ->
  ``direct_mask_<r>_ckpt.msgpack``;
- 03, merge: BN folded, the masks folded -> ``merged_<r>_ckpt.msgpack`` (a
  dense fused tree; ``fused_dense`` with ``--ratio 0``); with ``--slim`` and
  ChannelMask gates in the checkpoint (a Pruner's or Tuner's), their dead
  channels removed -> ``merged_<r>_slim_ckpt.msgpack`` and
  ``merged_<r>_slim_spec.json``, which ``entry.build_headline(spec_path=...)``
  serves.

Checkpoints are msgpack trees (utils/checkpoint.py) or a reference ``.pth``
state dict (``utils/torch_import.py``, ``--variant``'s names; the P6
variants have 4 levels, the others 3). ``main`` returns what it wrote and
the parameter counts.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger("cocodet_tpu_torch")


def make_parser():
    ap = argparse.ArgumentParser("compress_pipeline")
    ap.add_argument("-c", "--ckpt", required=True,
                    help="training checkpoint (.msgpack or a reference .pth)")
    ap.add_argument("-o", "--out-dir", default="weights")
    ap.add_argument("--ratio", type=float, default=0.49,
                    help="global magnitude prune ratio (0 disables masking)")
    ap.add_argument("--eps", type=float, default=1e-3, help="BN eps for fold")
    ap.add_argument("--slim", action="store_true",
                    help="physically remove ChannelMask-dead channels")
    ap.add_argument("--variant", default="p6")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = make_parser().parse_args(argv)

    from cocodet_tpu_torch.compress import (count_effective_params, generate_magnitude_masks,
                                            inject_masks, merge_for_deployment, slim_channels)
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    if args.ckpt.endswith(".pth"):
        from cocodet_tpu_torch.utils.torch_import import load_torch_checkpoint

        variables = load_torch_checkpoint(args.ckpt, variant=args.variant,
                                          num_levels=4 if args.variant.startswith("p6") else 3)
    else:
        ckpt = load_checkpoint(args.ckpt)
        variables = ckpt.get("model", ckpt)
    os.makedirs(args.out_dir, exist_ok=True)
    out: Dict[str, Any] = {"files": {}, "seconds": {}}
    tag = int(args.ratio * 100)

    if args.ratio > 0:  # steps 01 and 02
        t0 = time.perf_counter()
        masks = generate_magnitude_masks(variables["params"], prune_ratio=args.ratio)
        out["seconds"]["masks"] = time.perf_counter() - t0
        out["files"]["mask"] = save_checkpoint({"masks": masks}, False, args.out_dir,
                                               f"mask_{tag}")
        variables = inject_masks(variables, masks)
        out["files"]["direct_mask"] = save_checkpoint({"model": variables}, False,
                                                      args.out_dir, f"direct_mask_{tag}")
    out["before_merge"] = count_effective_params(variables, variables.get("masks"))
    logger.info("effective params before merge: %s / %s", *out["before_merge"])

    t0 = time.perf_counter()  # step 03
    merged = merge_for_deployment(variables, eps=args.eps)
    out["seconds"]["merge"] = time.perf_counter() - t0
    name = f"merged_{tag}" if args.ratio > 0 else "fused_dense"
    out["files"]["merged"] = save_checkpoint({"model": merged}, False, args.out_dir, name)
    out["merged"] = count_effective_params(merged)
    logger.info("deployment tree: %s nonzero / %s total", *out["merged"])

    if args.slim and "masks" in variables:
        t0 = time.perf_counter()
        slimmed, spec = slim_channels(merged, variables["masks"])
        out["seconds"]["slim"] = time.perf_counter() - t0
        out["files"]["slim"] = save_checkpoint({"model": slimmed}, False, args.out_dir,
                                               name + "_slim")
        spec_path = os.path.join(args.out_dir, name + "_slim_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        out["files"]["slim_spec"] = spec_path
        out["slim"] = count_effective_params(slimmed)
        logger.info("wrote the channel-slimmed tree and %s (%d entries)", spec_path, len(spec))
    return out


if __name__ == "__main__":
    main()
