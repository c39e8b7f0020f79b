"""Score a deployment checkpoint (bf16, slim or int8) on a COCO-layout val
folder through the port's submission harness (tools/eval_harness_ckpt.py):

    python -m cocodet_tpu_torch.tools.eval_harness_ckpt -c pipe_int8_ckpt.msgpack \
        --slim-spec pipe_slim_spec.json --quant w8a8 --data-dir <COCO root> --img-size 320

The harness config of the JAX tool (a yolox-p6 at ``--depth``/``--width``,
no contrast TTA, the given conf and NMS IoU) served from
``<root>/val2017`` by ``harness.run``, the detections written beside the
checkpoint (or to ``-o``) and scored against
``<root>/annotations/instances_val2017.json``; prints one JSON line with
the mAP and AP50. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def make_parser():
    ap = argparse.ArgumentParser("eval_harness_ckpt")
    ap.add_argument("-c", "--ckpt", required=True)
    ap.add_argument("--data-dir", required=True,
                    help="COCO-layout root (val2017/ + annotations/)")
    ap.add_argument("--slim-spec", default=None)
    ap.add_argument("--quant", default=None, choices=[None, "w8a8"])
    ap.add_argument("--depth", type=float, default=0.33)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--img-size", type=int, default=320)
    ap.add_argument("-b", "--batch-size", type=int, default=8)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--nms", type=float, default=0.65)
    ap.add_argument("--half", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 model compute (--no-half for float32)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-o", "--out", default=None,
                    help="detections json path (default: alongside ckpt)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = make_parser().parse_args(argv)

    from cocodet_tpu_torch import harness
    from cocodet_tpu_torch.evaluators.coco_metric import score_detections_json

    cfg = {
        "model": {"type": "yolox-p6", "depth": args.depth, "width": args.width},
        "ckpt": args.ckpt,
        "slim_spec": args.slim_spec,
        "quant": args.quant,
        "img_size": args.img_size,
        "half": args.half,
        "data_dir": os.path.join(args.data_dir, "val2017"),
        "dataloader": {"batch_size": args.batch_size},
        "postprocess": {"conf_threshold": args.conf, "nms_threshold": args.nms},
        "input_aug": False,
    }
    out_json = args.out or (os.path.splitext(args.ckpt)[0] + "_detections.json")
    harness.run(cfg, out_json, device=args.device)
    stats = score_detections_json(
        os.path.join(args.data_dir, "annotations", "instances_val2017.json"), out_json)
    result = {"ckpt": args.ckpt, "quant": args.quant, "mAP": stats["AP"],
              "AP50": stats["AP50"]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
