"""One deployment checkpoint scored on the six synthetic robustness variants
(tools/eval_robustness.py):

    python -m cocodet_tpu_torch.tools.eval_robustness -c pipe_slim_ckpt.msgpack \
        --slim-spec pipe_slim_spec.json --img-size 320

Each variant's val set is generated once by the port's
``data/synthetic.py`` (val images seeded from ``seed + 77777``) under the
temporary directory, served by the port's ``harness.run`` with the JAX
tool's config (a yolox-p6 at ``--depth``/``--width``, bf16, no contrast
TTA) and scored by ``evaluators/coco_metric.py``. Prints a line per variant
and the table as JSON, and writes the table beside the checkpoint (or to
``-o``). Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

VARIANTS = ("default", "occlusion", "crowding", "texture", "smallobj", "lowlight")


def variant_root(variant: str, n_val: int, size: int, seed: int) -> str:
    """The variant's COCO-layout set, generated unless it is there (only
    val2017 is scored; the train split is kept minimal)."""
    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    root = os.path.join(tempfile.gettempdir(),
                        f"cocodet_torch_robust_s{seed}_v{n_val}_{size}", variant)
    if not os.path.exists(os.path.join(root, "annotations", "instances_val2017.json")):
        make_synthetic_coco(root, n_train=4, n_val=n_val, size_range=(size, size * 2),
                            seed=seed, variant=variant)
    return root


def make_parser():
    ap = argparse.ArgumentParser("eval_robustness")
    ap.add_argument("-c", "--ckpt", required=True)
    ap.add_argument("--slim-spec", default=None)
    ap.add_argument("--quant", default=None, choices=[None, "w8a8"])
    ap.add_argument("--depth", type=float, default=0.33)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("--n-val", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--nms", type=float, default=0.65)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--exposure-norm", action="store_true",
                    help="adaptive per-image exposure normalization in the harness preproc "
                         "(data/folder.py)")
    ap.add_argument("-o", "--out", default=None,
                    help="results json (default: <ckpt>_robustness.json)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Returns the table {variant: {"AP50", "AP"}}."""
    args = make_parser().parse_args(argv)

    from cocodet_tpu_torch import harness
    from cocodet_tpu_torch.evaluators.coco_metric import score_detections_json

    table = {}
    for variant in VARIANTS:
        root = variant_root(variant, args.n_val, args.img_size, args.seed)
        cfg = {
            "model": {"type": "yolox-p6", "depth": args.depth, "width": args.width},
            "ckpt": args.ckpt,
            "slim_spec": args.slim_spec,
            "quant": args.quant,
            "img_size": args.img_size,
            "half": True,
            "data_dir": os.path.join(root, "val2017"),
            "dataloader": {"batch_size": args.batch_size},
            "postprocess": {"conf_threshold": args.conf, "nms_threshold": args.nms},
            "input_aug": False,
            "exposure_norm": args.exposure_norm,
        }
        det_json = os.path.join(root, "detections.json")
        harness.run(cfg, det_json, device="cpu" if args.cpu else "cuda")
        stats = score_detections_json(
            os.path.join(root, "annotations", "instances_val2017.json"), det_json)
        table[variant] = {"AP50": stats["AP50"], "AP": stats["AP"]}
        print(f"{variant:>10}: AP50={stats['AP50']:.4f} AP={stats['AP']:.4f}", flush=True)

    out = args.out or os.path.splitext(args.ckpt)[0] + "_robustness.json"
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table))
    return table


if __name__ == "__main__":
    main()
