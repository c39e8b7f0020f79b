"""The evaluation CLI (tools/eval.py) on the port:

    python -m cocodet_tpu_torch.tools.eval -f cocodet_tpu_torch/exps/p6/yolox_m_p6.py \
        -c weights/merged_49.pth -b 16 --fuse data_dir <COCO dir>

An exp by file or registry name, its trailing ``key value`` overrides, and
JAX's flags: ``-c`` a ``.msgpack`` checkpoint (its ``model`` tree or the
file's) or a reference ``.pth`` state dict (``utils/torch_import.py``,
variant from ``exp.model_name``, the model's level count); without one, the
exp's seeded random weights, with a warning. ``--conf``, ``--nms`` and
``--tsize`` override the exp's test point; ``--slim-spec`` evaluates the
fused model slimmed to a channel plan (``compress_pipeline --slim``);
``--fuse`` folds BN into the convs (``ops/fuse.py``); ``--test`` takes
test-dev. ``--speed`` times 50 batches of a seeded random input after a
warm-up, each ending in ``torch.cuda.synchronize()``, and prints img/s and
ms a batch with the card's name; otherwise the exp's COCO evaluator runs and
the CLI prints ``AP50:95 = ... AP50 = ...`` as JAX's does.

Several processes (JAX's ``--dist-coordinator/--num-processes/
--process-id``): each process is one rank of a ``tcp://<coordinator>``
rendezvous, on card ``process-id % cards``; each evaluates its share of the
val set and the records are gathered to rank 0
(``evaluators/coco_evaluator.py``). It runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

logger = logging.getLogger("cocodet_tpu_torch")


def make_parser():
    p = argparse.ArgumentParser("cocodet_tpu_torch eval")
    p.add_argument("-n", "--name", default=None)
    p.add_argument("-f", "--exp_file", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("-c", "--ckpt", default=None, help="checkpoint (.msgpack or reference .pth)")
    p.add_argument("--conf", type=float, default=None)
    p.add_argument("--nms", type=float, default=None)
    p.add_argument("--tsize", type=int, default=None)
    p.add_argument("--slim-spec", default=None,
                   help="channel-slim spec json (compress_pipeline --slim output)")
    p.add_argument("--fuse", action="store_true", help="fold BN into conv weights before eval")
    p.add_argument("--speed", action="store_true", help="latency benchmark only (no mAP)")
    p.add_argument("--test", action="store_true", help="test-dev set")
    p.add_argument("--dist-coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def load_variables(path: Optional[str], model_name: str):
    """A checkpoint's flax-layout tree: a reference ``.pth`` or a msgpack's
    ``model`` entry (or the file's tree); None without a path."""
    if not path:
        return None
    if path.endswith(".pth"):
        from cocodet_tpu_torch.models.yolox import MODEL_SPECS
        from cocodet_tpu_torch.utils.torch_import import load_torch_checkpoint

        return load_torch_checkpoint(path, variant=model_name.replace("yolox-", ""),
                                     num_levels=len(MODEL_SPECS[model_name].strides))
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(path)
    return ckpt.get("model", ckpt)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns what it printed: ``{"ap", "ap50", "summary"}`` and the
    evaluated ``records``, or with ``--speed`` ``{"img_s", "ms_batch",
    "device"}``."""
    args = make_parser().parse_args(argv)

    from cocodet_tpu_torch.entry import Predictor
    from cocodet_tpu_torch.exp import get_exp
    from cocodet_tpu_torch.parallel.launch import rank_device

    world = args.num_processes or 1
    rank = args.process_id or 0
    device = rank_device(args.device, rank)
    if world > 1:
        from cocodet_tpu_torch.parallel.mesh import initialize_distributed

        if not args.dist_coordinator:
            raise ValueError("--num-processes > 1 needs --dist-coordinator host:port")
        initialize_distributed(f"tcp://{args.dist_coordinator}", world, rank, device)

    exp = get_exp(args.exp_file, args.name)
    exp.merge(args.opts)
    if args.conf is not None:
        exp.test_conf = args.conf
    if args.nms is not None:
        exp.nms_threshold = args.nms
    if args.tsize is not None:
        exp.test_size = (args.tsize, args.tsize)

    variables = load_variables(args.ckpt, exp.model_name)
    if variables is None:
        logger.warning("no checkpoint: evaluating random weights")
    if args.fuse and variables is not None and "batch_stats" in variables:
        from cocodet_tpu_torch.ops.fuse import fuse_batchnorm_tree

        variables = fuse_batchnorm_tree(variables, eps=exp.bn_eps)
        logger.info("BN folded into conv weights")

    if args.slim_spec:
        from cocodet_tpu_torch.compress import load_slim_spec
        from cocodet_tpu_torch.models.yolox import build_model

        spec = load_slim_spec(args.slim_spec)
        model = build_model(exp.model_name, num_classes=exp.num_classes, depth=exp.depth,
                            width=exp.width, fused=True, slim=spec, device=device,
                            variables=variables)
        logger.info("channel-slim spec: %d entries", len(spec))
    else:
        model = exp.get_model(device=device, fused=args.fuse, variables=variables)
    predictor = Predictor(model)

    try:
        if args.speed:
            return _speed(args, exp, predictor, device)
        evaluator = exp.get_evaluator(batch_size=args.batch_size, testdev=args.test)
        if world > 1:
            evaluator.shard = (rank, world)
        ap, ap50, summary = evaluator.evaluate(predictor)
        logger.info(summary)
        print(f"AP50:95 = {ap:.4f}  AP50 = {ap50:.4f}")
        return {"ap": ap, "ap50": ap50, "summary": summary, "records": evaluator.records}
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _speed(args, exp, predictor, device) -> dict:
    """50 timed batches of one seeded random input after a warm-up."""
    import numpy as np
    import torch

    from cocodet_tpu_torch.entry import Predictor
    from cocodet_tpu_torch.ops.postprocess import PostprocessConfig

    serve = Predictor(predictor.model, PostprocessConfig(conf_threshold=exp.test_conf,
                                                         nms_threshold=exp.nms_threshold))
    imgs = torch.from_numpy((np.random.RandomState(0).rand(
        args.batch_size, *exp.test_size, 3) * 255).astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    serve(imgs)
    sync()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        serve(imgs)
        sync()
    dt = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {"img_s": args.batch_size * n / dt, "ms_batch": 1000 * dt / n, "device": name}
    print(f"speed: {out['img_s']:.2f} img/s, {out['ms_batch']:.2f} ms/batch on {name}")
    return out


if __name__ == "__main__":
    main()
