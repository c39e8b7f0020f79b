"""The YOLOv4-P6 smoke forward (harness/predict_yolov4.py) on the port.

    python -m cocodet_tpu_torch.predict_yolov4 [--img-size 256] [--device cuda|cpu]

Builds the fused YOLOv4-P6 graph (``models/anchor_zoo.py``) in bf16, runs
one forward on a zero image of ``--img-size`` (JAX's smoke size 256 by
default; 1280 in production), decodes it and prints the parameter count,
the level shapes (NHWC) and the decoded boxes' shape. Weights: numpy seed 0
(JAX's draws its own random init). Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse

import torch

from .models.anchor_zoo import decode_anchor_outputs
from .predict_yolov5 import count_params, load_anchor_model


def run(img_size: int = 256, device: str = "cuda", dtype: torch.dtype = torch.bfloat16):
    """(level maps, decoded boxes) of the forward; prints as JAX's does."""
    model, anchors, strides = load_anchor_model("yolov4-p6", torch.device(device), dtype)
    x = torch.zeros((1, img_size, img_size, 3), dtype=torch.float32, device=device)
    with torch.inference_mode():
        outs = model(x)
        boxes, _, _ = decode_anchor_outputs(outs, anchors, strides, 80)
    print(f"yolov4-p6: {count_params(model):,} params; levels "
          f"{[tuple(o.shape) for o in outs]}; decoded {tuple(boxes.shape)}")
    return outs, boxes


def main(argv=None):
    ap = argparse.ArgumentParser("predict_yolov4")
    ap.add_argument("--img-size", type=int, default=256, help="256 (JAX's smoke size); 1280 "
                    "in production")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA card is visible")
    run(args.img_size, args.device)


if __name__ == "__main__":
    main()
