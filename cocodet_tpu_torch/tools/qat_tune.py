"""Quantization-aware fine-tune (tools/qat_tune.py) of a fused or slim
deployment checkpoint, on the port:

    python -m cocodet_tpu_torch.tools.qat_tune -c pipe_merged_ckpt.msgpack \
        [--slim-spec pipe_slim_spec.json] --data-dir <COCO dir> --img-size 640 \
        -b 16 --steps 300 --lr 1e-5 -o pipe_qat_ckpt.msgpack

Calibrates the activation scales on ``--calib-batches`` batches (per
channel by default, ``--act-scales tensor`` per tensor), fine-tunes the
float parameters through the ``quant="qat"`` fused model on no-aug batches
(the letterbox alone: no mosaic, no mixup, one size), with an EMA shadow
(``--ema-decay``, 0 disables) that is what gets deployed, then requantizes
to int8 and writes the w8a8 msgpack ``{"params", "quant"}`` that
``tools/quantize_model.py`` writes and JAX's ``load_checkpoint`` reads. The
flags are JAX's; it runs on the card, ``--device cpu`` (or ``--cpu``) asks
for the CPU. ``main`` returns the tree it wrote, the step metrics and the
report.
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
    p = argparse.ArgumentParser("cocodet_tpu_torch int8 QAT fine-tune")
    p.add_argument("-c", "--ckpt", required=True,
                   help="fused deployment .msgpack (float, pre-quantization)")
    p.add_argument("-o", "--out", required=True, help="output w8a8 .msgpack")
    p.add_argument("-n", "--name", default="yolox-p6")
    p.add_argument("--depth", type=float, default=0.67)
    p.add_argument("--width", type=float, default=0.75)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--slim-spec", default=None)
    p.add_argument("--data-dir", required=True,
                   help="COCO-layout root (train2017/ + annotations/)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--act-scales", choices=["tensor", "channel"], default="channel",
                   help="activation-scale granularity; 'channel' trains against the "
                        "deployed per-channel fold grid")
    p.add_argument("--ema-decay", type=float, default=0.999,
                   help="deploy an EMA shadow of the params instead of the raw SGD "
                        "iterate (0 disables)")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--iou-type", default="giou")
    p.add_argument("--print-interval", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def data_loader(args):
    """No-aug labeled batches (qat_tune.py:78-94): the yolox-m-p6 exp with
    mosaic 0, no mixup, one size."""
    from cocodet_tpu_torch.exp import get_exp

    exp = get_exp(exp_name="yolox-m-p6")
    exp.depth, exp.width = args.depth, args.width
    exp.num_classes = args.num_classes
    exp.data_dir = args.data_dir
    exp.input_size = exp.test_size = (args.img_size, args.img_size)
    exp.multiscale_range = 0
    exp.data_num_workers = args.workers
    exp.mosaic_prob = 0.0
    exp.enable_mixup = False
    exp.seed = 0
    return exp.get_data_loader(args.batch_size, no_aug=True, seed=0)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    import numpy as np
    import torch

    from cocodet_tpu_torch.compress import (build_quant_tree, calibrate, load_slim_spec,
                                            make_qat_step, qat_ema, qat_optimizer,
                                            quantization_report, requantize)
    from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, load_matched
    from cocodet_tpu_torch.utils.convert import (ema_variables, export_variables, flatten_tree,
                                                 random_variables, unflatten_tree)
    from cocodet_tpu_torch.utils.msgpack import dumps_tree

    args = make_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: qat_tune runs on the card unless it is asked for "
                           "the CPU (--device cpu)")
    slim = load_slim_spec(args.slim_spec) if args.slim_spec else None
    # f32 compute: the QAT forward simulates the deployed s8 x s8 -> s32 path
    kw = dict(num_classes=args.num_classes, depth=args.depth, width=args.width, fused=True,
              slim=slim, dtype=torch.float32, device=device)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS[args.name], num_classes=args.num_classes, depth=args.depth,
                       width=args.width, fused=True, slim=slim)
    loaded = load_checkpoint(args.ckpt)
    tree = loaded.get("model", loaded)
    params = load_matched(random_variables(shapes, 0)["params"], tree.get("params", tree))
    calib_model = build_model(args.name, quant="calib", variables={"params": params}, **kw)
    strides = MODEL_SPECS[args.name].strides

    data_iter = iter(data_loader(args))

    def next_batch():
        imgs, labels, _, _ = next(data_iter)
        return (torch.from_numpy(np.asarray(imgs, np.float32)).to(device),
                torch.from_numpy(np.asarray(labels, np.float32)).to(device))

    calib_imgs = [next_batch()[0] for _ in range(args.calib_batches)]
    logger.info("calibrating on %d batches of %s", len(calib_imgs), tuple(calib_imgs[0].shape))
    quant = build_quant_tree(calibrate(calib_model, {"params": params}, calib_imgs),
                             per_channel_act=args.act_scales == "channel")
    del calib_model, calib_imgs

    model = build_model(args.name, quant="qat", variables={"params": params, "quant": quant},
                        **kw)
    opt = qat_optimizer(model, args.lr)
    ema = qat_ema(model, args.ema_decay) if args.ema_decay > 0.0 else None
    step = make_qat_step(model, opt, strides, num_classes=args.num_classes,
                         iou_type=args.iou_type, ema=ema)
    history = []
    t0 = time.perf_counter()
    for it in range(args.steps):
        imgs, labels = next_batch()
        metrics = step(imgs, labels)
        if (it + 1) % args.print_interval == 0 or it == 0:
            m = {k: float(v) for k, v in metrics.items()}  # the sync point
            history.append({"step": it + 1, **m})
            logger.info("qat step %d/%d loss %.4f (iou %.3f obj %.3f cls %.3f l1 %.3f) "
                        "%.1f img/s", it + 1, args.steps, m["loss"], m["iou_loss"],
                        m["obj_loss"], m["cls_loss"], m["l1_loss"],
                        args.batch_size * (it + 1) / (time.perf_counter() - t0))

    deploy = ema_variables(ema)["params"] if ema is not None else \
        export_variables(model)["params"]
    int8_params, quant_full = requantize(deploy, quant)
    rep = quantization_report({"params": int8_params})
    logger.info("requantized: %s", json.dumps(rep))
    out = {"params": int8_params, "quant": quant_full}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(dumps_tree(unflatten_tree({k: np.asarray(v)
                                           for k, v in flatten_tree(out).items()})))
    logger.info("wrote %s (%.1f MB)", args.out, os.path.getsize(args.out) / 2**20)
    return {"tree": out, "history": history, "report": rep, "model": model, "ema": ema,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
