"""The rank hook and the host body of tests/test_torch_trainer_ranks.py and
tests/test_torch_trainer_hosts.py. The ranks import this module, so it
imports numpy, torch and the port only (no JAX).

``f64_hook`` is a ``tools/train.py`` rank hook: before the trainer builds
anything it makes the trained model f64 (the model the evaluator builds
from the EMA stays in the exp's f32), turns TensorBoard off and pins one
torch thread; it records what each step was fed and what the trainer
logged, and at the end hands back the log, the checkpoint files it sees,
the state as numpy arrays and the last evaluation's (gathered) records."""

import os
import sys

import numpy as np
import torch

from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree

# the tiny phase-1 exp of tests/test_torch_trainer.py on 256 and 384 px
# buckets (the least a 2-row space axis admits: H % 128 == 0, H >= 256),
# one mosaic epoch then one no-aug epoch of 2 iterations each
OPTS = ["device_mosaic", "True", "depth", "0.33", "width", "0.125", "input_size", "(256, 256)",
        "test_size", "(256, 256)", "multiscale_range", "(0, 1)", "multiscale_step", "128",
        "max_epoch", "2", "warmup_epochs", "1", "no_aug_epochs", "0", "print_interval", "1",
        "eval_interval", "1", "compute_dtype", "float32", "data_num_workers", "1"]
LOSSES = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss")


def argv(root, out, *extra):
    return ["-f", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py"),
            "-b", "2", "--device", "cpu", *extra, *OPTS, "data_dir", root, "output_dir", out]


def f64_hook(trainer, stage):
    if stage == "end":
        return {"log": trainer._test_log, "steps": trainer._test_steps,
                "files": sorted(os.listdir(trainer.file_name)),
                "variables": flatten_tree(export_variables(trainer.model)),
                "ema": {k: v.numpy().copy() for k, v in trainer.state.ema.shadow.items()},
                "count": trainer.optimizer.count,
                "records": list(trainer.evaluator.records)}
    torch.set_num_threads(1)
    if trainer.world > 1:
        sys.modules["torch.utils.tensorboard"] = None  # its import takes seconds here
    exp = trainer.exp
    get_model = exp.get_model

    def get_model_f64(*a, **kw):
        model = get_model(*a, **kw)
        if kw.get("variables") is None:  # the trained model
            model.to(torch.float64)
            model.dtype = torch.float64
        return model
    exp.get_model = get_model_f64
    trainer._test_log, trainer._test_steps = [], []
    before_train = trainer.before_train

    def hooked_before_train():
        before_train()
        step = trainer.train_step

        def logged_step(images, labels, **kw):
            trainer._test_steps.append((images.numpy().copy(), labels.numpy().copy()))
            return step(images, labels, **kw)
        trainer.train_step = logged_step

    def progress(it, cur_size):
        m = trainer.meter
        trainer._test_log.append({"epoch": trainer.epoch, "it": it, "size": tuple(cur_size),
                                  "use_l1": trainer.use_l1, "lr": m["lr"].latest,
                                  **{k: m[k].latest for k in LOSSES}})
    trainer.before_train = hooked_before_train
    trainer._log_progress = progress
    return None


def same_arrays(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def record_rows(records):
    """An evaluation's records as sorted rows (image_id, category_id,
    score, x, y, w, h)."""
    return sorted((r["image_id"], r["category_id"], r["score"], *r["bbox"]) for r in records)


def host_main(args):
    """One host of a run over several hosts: ``tools.train.main`` on
    ``args`` with ``f64_hook``; writes rank 0's entry (and this host's) to
    ``<output_dir>/host<id>.pt``."""
    from cocodet_tpu_torch.tools import train

    run = train.main(args, rank_hook=f64_hook)
    out = args[args.index("output_dir") + 1]
    host = args[args.index("--host-id") + 1]
    torch.save(run.ranks, os.path.join(out, f"host{host}.pt"))


if __name__ == "__main__":
    host_main(sys.argv[1:])
