"""The training CLI (tools/train.py) on the port:

    python -m cocodet_tpu_torch.tools.train -f cocodet_tpu_torch/exps/p6/yolox_m_p6.py \
        -b 16 data_dir <COCO dir> multiscale_step 64 multiscale_range "(-2, 1)"

trains the phase-1 exp on its own input path, the host mosaic on COCO's
JPEGs (``device_mosaic True`` moves the mosaic, warp and mixup onto the
card). The two overrides keep the exp's 640-832 multiscale span at stride
64: its stride of 32 draws 672, 736 and 800, which the 4-level model cannot
take (the trainer raises on them, as JAX's model fails on them).

The flags of the JAX CLI (experiment by file or registry name, batch size,
resume, checkpoint, start epoch, cache, fp32, no-aug, seed, and
``--coordinator/--num-hosts/--host-id`` for several hosts) and its trailing
``key value`` overrides of the exp's attributes (``exp.merge``). ``--fp32``
sets ``compute_dtype`` to float32 (bf16 is the default). It trains on the
card; ``--device cpu`` asks for the CPU.

Ranks. A port rank is one process with one device (JAX runs one process a
host over all of its devices). ``-d/--devices N`` (the reference YOLOX's
flag) starts N ranks on this host, by default one a visible card (one with
``--device cpu``, and one for a trainer whose steps do not run on several
ranks: the Pruner, the distilling Tuner, SynFlow); rank ``host_id * N + i`` runs on card ``i % cards``, so
ranks share a card when there are more ranks than cards. They join one
process group of ``num_hosts * N`` ranks: through a ``file://`` rendezvous
on one host, through ``tcp://<coordinator>`` across hosts, each host
running this command with its own ``--host-id``. The backend is NCCL where
every rank owns a card, gloo otherwise (``parallel/mesh.py::backend_for``).
The global batch is ``-b`` whatever the number of ranks:

    python -m cocodet_tpu_torch.tools.train -f <exp> -d 8 -b 128 ...      # one host
    python -m cocodet_tpu_torch.tools.train -f <exp> -d 8 -b 256 \\
        --coordinator host0:29500 --num-hosts 2 --host-id 0 ...           # on host0
    (the same with --host-id 1 on the second host)
"""

from __future__ import annotations

import argparse
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence


def make_parser():
    p = argparse.ArgumentParser("cocodet_tpu_torch train")
    p.add_argument("-expn", "--experiment-name", default=None)
    p.add_argument("-n", "--name", default=None, help="registry exp name")
    p.add_argument("-f", "--exp_file", default=None, help="exp file path")
    p.add_argument("-b", "--batch-size", type=int, default=64, help="the global batch")
    p.add_argument("-d", "--devices", type=int, default=None,
                   help="ranks on this host (default: one a visible card; 1 on the CPU)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("-c", "--ckpt", default=None)
    p.add_argument("-e", "--start_epoch", type=int, default=None)
    p.add_argument("--cache", action="store_true", help="cache decoded images in RAM")
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute (bf16 is the default)")
    p.add_argument("--no-aug", dest="no_aug", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="the rendezvous host:port of a run over several hosts")
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


def local_ranks(args, trainer_cls=None, exp=None) -> int:
    """The ranks this host starts: ``--devices``, by default one a visible
    card (one on the CPU, and one where ``trainer_cls.trains_on_ranks(exp)``
    says that its steps do not run on several ranks)."""
    if args.devices is not None:
        if args.devices < 1:
            raise ValueError(f"--devices must be at least 1, not {args.devices}")
        return args.devices
    if args.device == "cpu" or (trainer_cls is not None
                                and not trainer_cls.trains_on_ranks(exp)):
        return 1
    import torch

    return max(torch.cuda.device_count(), 1)


class TrainRun:
    """What a run of several ranks hands back: rank 0's bookkeeping as
    attributes (``epoch_stats``, ``ckpt_stats``, ``eval_stats``,
    ``best_ap``, ``file_name``, ``digest``, ``hook``) and every local rank's
    in ``ranks``."""

    def __init__(self, ranks: List[Dict[str, Any]]):
        self.ranks = ranks
        self.__dict__.update(ranks[0])


def rank_summary(trainer) -> Dict[str, Any]:
    """A rank's bookkeeping, and the digest of its state
    (``Trainer.state_digest``)."""
    return {"rank": trainer.rank, "epoch_stats": trainer.epoch_stats,
            "ckpt_stats": trainer.ckpt_stats, "eval_stats": trainer.eval_stats,
            "best_ap": trainer.best_ap, "file_name": trainer.file_name,
            "digest": trainer.state_digest()}


def _train(trainer_cls, exp, args, device, rank_hook: Optional[Callable]):
    trainer = trainer_cls(exp, args, device=device)
    if rank_hook is not None:
        rank_hook(trainer, "start")
    trainer.train()
    return trainer


def _run_rank(rank: int, device, trainer_cls, argv: Sequence[str],
              rank_hook: Optional[Callable]) -> Dict[str, Any]:
    exp, args = build(argv)
    trainer = _train(trainer_cls, exp, args, device, rank_hook)
    out = rank_summary(trainer)
    out["hook"] = None if rank_hook is None else rank_hook(trainer, "end")
    return out


def launch(trainer_cls, argv: Optional[Sequence[str]] = None,
           rank_hook: Optional[Callable] = None):
    """Build the exp of ``argv`` and train it with ``trainer_cls`` (the
    Trainer, the Tuner, ...). One rank trains in this process and the
    trainer is returned. Several ranks, each a process of its own
    (``parallel/launch.py::run_ranks``), return a ``TrainRun``;
    ``rank_hook(trainer, "start")`` runs in each before it trains and
    ``rank_hook(trainer, "end")`` after, its value in the rank's entry (a
    function that pickles by its import path)."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    exp, args = build(argv)
    n_local = local_ranks(args, trainer_cls, exp)
    if args.num_hosts < 1 or not 0 <= args.host_id < args.num_hosts:
        raise ValueError(f"--host-id {args.host_id} is not one of --num-hosts "
                         f"{args.num_hosts}")
    world = args.num_hosts * n_local
    if world == 1:
        return _train(trainer_cls, exp, args, args.device, rank_hook)
    init = None
    if args.num_hosts > 1:
        if not args.coordinator:
            raise ValueError("--num-hosts > 1 needs --coordinator host:port")
        init = f"tcp://{args.coordinator}"
    from cocodet_tpu_torch.parallel.launch import run_ranks

    return TrainRun(run_ranks(_run_rank, n_local, trainer_cls, argv, rank_hook,
                              device=args.device, timeout=None, init_method=init,
                              world_size=world, rank_offset=args.host_id * n_local))


def main(argv: Optional[Sequence[str]] = None, rank_hook: Optional[Callable] = None):
    """Parse ``argv`` (default: the command line), build the exp and train;
    returns the Trainer (one rank) or the ``TrainRun`` of several."""
    from cocodet_tpu_torch.core.trainer import Trainer

    return launch(Trainer, argv, rank_hook)


if __name__ == "__main__":
    main()
