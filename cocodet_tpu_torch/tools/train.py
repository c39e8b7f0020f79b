"""The training CLI (tools/train.py) on the port:

    python -m cocodet_tpu_torch.tools.train -f cocodet_tpu_torch/exps/p6/yolox_m_p6.py \
        -b 16 data_dir <COCO dir> multiscale_step 64 multiscale_range "(-2, 1)"

trains the phase-1 exp on its own input path, the host mosaic on COCO's
JPEGs (``device_mosaic True`` moves the mosaic, warp and mixup onto the
card). The two overrides keep the exp's 640-832 multiscale span at stride
64: its stride of 32 draws 672, 736 and 800, which the 4-level model cannot
take (the trainer raises on them, as JAX's model fails on them).

The flags of the JAX CLI (experiment by file or registry name, batch size,
resume, checkpoint, start epoch, cache, fp32, no-aug, seed) and its trailing
``key value`` overrides of the exp's attributes (``exp.merge``). ``--fp32``
sets ``compute_dtype`` to float32 (bf16 is the default). It trains on the
card; ``--device cpu`` asks for the CPU. Multi-host training
(``--num-hosts > 1``) raises.
"""

from __future__ import annotations

import argparse
import warnings
from typing import Optional, Sequence


def make_parser():
    p = argparse.ArgumentParser("cocodet_tpu_torch train")
    p.add_argument("-expn", "--experiment-name", default=None)
    p.add_argument("-n", "--name", default=None, help="registry exp name")
    p.add_argument("-f", "--exp_file", default=None, help="exp file path")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--resume", action="store_true")
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("-e", "--start_epoch", type=int, default=None)
    p.add_argument("--cache", action="store_true", help="cache decoded images in RAM")
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute (bf16 is the default)")
    p.add_argument("--no-aug", dest="no_aug", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port (not ported)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="trailing key value pairs override exp attrs")
    return p


def build(argv: Optional[Sequence[str]] = None):
    """(exp, args) of a command line: the exp by file or name, its trailing
    overrides, the experiment name, seed and compute dtype set."""
    args = make_parser().parse_args(argv)
    if args.num_hosts > 1:
        raise NotImplementedError("multi-host training is not ported (ROADMAP Queue 1 item 4)")

    from cocodet_tpu_torch.exp import get_exp

    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.experiment_name:
        exp.exp_name = args.experiment_name
    if args.seed is not None:
        # the loader, the multiscale stream and the weights draw from
        # generators seeded by exp.seed; the global RNGs are left alone
        exp.seed = args.seed
        warnings.warn("fixed seed set: throughput may vary run to run only through host-side "
                      "data order")
    if args.fp32:
        exp.compute_dtype = "float32"
    return exp, args


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default: the command line), build the exp and train;
    returns the Trainer."""
    from cocodet_tpu_torch.core.trainer import Trainer

    exp, args = build(argv)
    trainer = Trainer(exp, args, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
