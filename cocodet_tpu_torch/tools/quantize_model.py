"""Offline int8 PTQ over a fused (or slim) deployment checkpoint
(tools/quantize_model.py) on the port:

    python -m cocodet_tpu_torch.tools.quantize_model -c merged_49_slim_ckpt.msgpack \
        --slim-spec merged_49_slim_spec.json [--data-dir <images> | --synth] \
        [--img-size 640] [--calib-batches 4] [-b 8] -o merged_49_int8_ckpt.msgpack

The last stage of the compression chain: the checkpoint's params laid over
the fused model's init (``load_matched``), each conv's input absmax taken
on a few calibration batches by a ``quant="calib"`` model computing in bf16
(``compress.calibrate``), every ConvBnAct kernel quantized to per-out-
channel int8 with per-input-channel activation scales folded in
(``compress.quantize_model``; ``--act-scales tensor`` for one scale a conv),
and a deployment msgpack written with the int8 ``params`` and the ``quant``
collection, which the harness of either package serves with ``"quant":
"w8a8"``. Calibration images: a folder letterboxed as the harness does
(``data/folder.py``), or, with ``--synth`` or no folder, a synthetic COCO
set drawn from seed 7 into a temporary directory. ``--bits 4`` writes a
w4a8 checkpoint (:63-175): the kernels on the [-7, 7] grid with MSE-clip
scales (``--clip-search``'s default for 4 bits), those that ``--w4-keep``
names or ``--w4-keep-frac`` ranks worst kept on the int8 grid, each conv's
width in a ``w_bits`` leaf, and the int4 kernels nibble-packed
(``compress.pack_int4_tree``); loaded, it serves through the same int8
conv. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Iterator, Optional, Sequence

import numpy as np

logger = logging.getLogger("cocodet_tpu_torch")


def make_parser():
    p = argparse.ArgumentParser("cocodet_tpu_torch int8 PTQ")
    p.add_argument("-c", "--ckpt", required=True,
                   help="fused deployment .msgpack (compress_pipeline output)")
    p.add_argument("-o", "--out", required=True, help="output .msgpack")
    p.add_argument("-n", "--name", default="yolox-p6")
    p.add_argument("--depth", type=float, default=0.67)
    p.add_argument("--width", type=float, default=0.75)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--slim-spec", default=None,
                   help="channel-slim spec json (if the ckpt is slimmed)")
    p.add_argument("--data-dir", default=None,
                   help="folder of calibration images (letterboxed like the harness); "
                        "without one, --synth")
    p.add_argument("--synth", action="store_true",
                   help="calibrate on synthetic scenes (data/synthetic.py)")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--act-scales", choices=["tensor", "channel"], default="channel",
                   help="activation-scale granularity (per input channel, folded into "
                        "the kernel, is the production recipe)")
    p.add_argument("--bits", type=int, choices=[8, 4], default=8,
                   help="weight storage width: 8 (w8a8) or 4 (w4a8, nibble-packed; the "
                        "same int8 conv serves it)")
    p.add_argument("--w4-keep", default=None,
                   help="with --bits 4: comma-separated path substrings kept on the int8 grid")
    p.add_argument("--w4-keep-frac", type=float, default=0.0,
                   help="with --bits 4: keep this fraction of convs, those with the worst "
                        "relative int4 error, on the int8 grid")
    p.add_argument("--clip-search", type=int, choices=[0, 1], default=None,
                   help="per-channel MSE-optimal clip scales instead of absmax (default: on "
                        "for --bits 4, off for 8)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def calib_batches(args, tmp_dir: str) -> Iterator[np.ndarray]:
    """Float32 NHWC [0, 255] batches letterboxed to ``img_size``, from
    ``--data-dir`` or a synthetic set written under ``tmp_dir``."""
    from cocodet_tpu_torch.data.folder import FolderLoader, ImageFolderDataset

    data_dir = args.data_dir
    if args.synth or not (data_dir and os.path.isdir(data_dir)):
        from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

        make_synthetic_coco(tmp_dir, n_train=args.batch_size * args.calib_batches, n_val=1,
                            seed=7)
        data_dir = os.path.join(tmp_dir, "train2017")
    loader = FolderLoader(ImageFolderDataset(data_dir, args.img_size), args.batch_size,
                          pad_multiple=64)
    for n, (imgs, _infos) in enumerate(loader):
        if n >= args.calib_batches:
            return
        yield np.asarray(imgs, np.float32)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the quantization report, with the output's path."""
    args = make_parser().parse_args(argv)

    import torch

    from cocodet_tpu_torch.compress import (int4_kernel_paths, load_slim_spec, pack_int4_tree,
                                            quantization_report, quantize_model)
    from cocodet_tpu_torch.models.yolox import MODEL_SPECS, YOLOX, build_model
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, load_matched, save_tree
    from cocodet_tpu_torch.utils.convert import random_variables

    slim = load_slim_spec(args.slim_spec) if args.slim_spec else None
    kw = dict(num_classes=args.num_classes, depth=args.depth, width=args.width, fused=True,
              slim=slim)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS[args.name], **kw)
    loaded = load_checkpoint(args.ckpt)
    tree = loaded.get("model", loaded)
    variables = {"params": load_matched(random_variables(shapes, 0)["params"],
                                        tree.get("params", tree))}
    calib_model = build_model(args.name, quant="calib", dtype=torch.bfloat16,
                              device=args.device, variables=variables, **kw)

    with tempfile.TemporaryDirectory(prefix="cocodet_calib_") as tmp:
        batches = list(calib_batches(args, tmp))
    logger.info("calibrating on %d batches of %s", len(batches), tuple(batches[0].shape))
    qvars = quantize_model(calib_model, variables, batches,
                           per_channel_act=args.act_scales == "channel", bits=args.bits,
                           clip_search=None if args.clip_search is None
                           else bool(args.clip_search),
                           w8_keep_patterns=tuple(s for s in (args.w4_keep or "").split(",")
                                                  if s),
                           w8_keep_frac=args.w4_keep_frac)
    report = quantization_report(qvars, bits=args.bits)
    logger.info("quantized: %s", json.dumps(report))
    params = qvars["params"]
    if args.bits == 4:
        # the packed set follows --bits and --w4-keep, not the values' range
        params = pack_int4_tree(params, kernel_paths=int4_kernel_paths(qvars["quant"]))
    save_tree({"params": params, "quant": qvars["quant"]}, args.out)
    logger.info("wrote %s (%.1f MB)", args.out, os.path.getsize(args.out) / 2 ** 20)
    return dict(report, out=args.out)


if __name__ == "__main__":
    main()
