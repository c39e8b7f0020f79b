"""A checkpoint as a reference-layout torch ``.pth`` (tools/export_torch.py):

    python -m cocodet_tpu_torch.tools.export_torch -c outputs/exp/best_ckpt.msgpack \
        -o weights/export.pth [--variant p6] [--num-levels 4] [--raw]

The msgpack's EMA ``model`` tree (``--raw``: ``raw_model``; a bare tree as
it is) written by ``utils/torch_import.py::export_state_dict`` as
``{"model": state dict}``, f32 tensors in the reference's naming, which
``load_torch_checkpoint`` reads back to the same tree. A ``yolov3`` tree
keeps its Darknet and YOLOFPN scope names (give ``--variant standard
--num-levels 3``). On the host; no card is needed.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence


def make_parser():
    ap = argparse.ArgumentParser("export_torch")
    ap.add_argument("-c", "--ckpt", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--variant", default="p6", choices=["standard", "custom", "p6", "p6v2"])
    ap.add_argument("--num-levels", type=int, default=4)
    ap.add_argument("--raw", action="store_true", help="export the raw (non-EMA) weights")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, "object"]:
    """Writes the file and returns its state dict."""
    args = make_parser().parse_args(argv)

    import torch

    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint
    from cocodet_tpu_torch.utils.torch_import import export_state_dict

    ckpt = load_checkpoint(args.ckpt)
    variables = ckpt.get("raw_model" if args.raw else "model", ckpt)
    if "params" not in variables:
        variables = {"params": variables}
    sd = export_state_dict(variables, variant=args.variant, num_levels=args.num_levels)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"model": sd}, args.out)
    print(f"exported {len(sd)} tensors -> {args.out}")
    return sd


if __name__ == "__main__":
    main()
