"""The compression trainers on several ranks, through their CLIs
(``cocodet_tpu_torch/tools/{prune,tune,train_synflow}.py -d 2``): 2 gloo
ranks on the CPU on a data mesh, each run against the single-rank run of
the same command (cocodet_tpu/core/pruner.py:333-421, tuner.py:24-88,
trainer_synflow.py:81-136 on JAX's data mesh).

The runs: depth 0.33, width 0.125, 64 px, B=2 (one image a rank), 4
synthetic train and 2 val JPEGs, one epoch of 2 iterations, f64 trained
models (``tests/torch_trainer_ranks.py::compress_hook``; the teacher and
the evaluated model stay f32), the per-epoch evaluation on, sharded.

- the Pruner: a prune event of 24 channels after each iteration, on one
  score batch (each rank scoring its rows);
- the distilling Tuner: from the single-rank Pruner's checkpoint (a masked
  student), distillation on, its teacher the checkpoint's model with its
  masks;
- SynFlow: 3 rounds at epoch 0 (``prune_iters 3 prune_epoch 0``), the
  kernels scaled by 0.3 at the start (the all-ones pass overflows f32 on
  random weights: tests/test_torch_synflow.py).

Held: both ranks' state digests equal (parameters, buffers with the gates
and conv masks, optimizer state); the channels each prune event closes,
the Tuner's gates and SynFlow's conv masks equal bit for bit on both ranks
and to the single rank's; the logged losses, and a closed gate's offset (the BN bias it
copies at the event), within 1e-3 relative of the single rank's. The losses are f32 in both (the maps are
cast), so the ranks' gradients, summed in another order, differ from the
single rank's by f32 rounding, which BN over the 1x1 and 2x2 maps of 2
images magnifies (tests/test_torch_trainer_ranks.py): measured here, the
second step's loss terms up to 2.9e-4 relative apart, the offsets 1.2e-4.
"""

import os

import numpy as np
import pytest
import torch

import torch_trainer_ranks as tr
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.tools import prune as tprune
from cocodet_tpu_torch.tools import train_synflow as tsyn
from cocodet_tpu_torch.tools import tune as ttune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPS = os.path.join(REPO, "cocodet_tpu_torch", "exps")
SMALL = ["-b", "2", "--device", "cpu", "depth", "0.33", "width", "0.125", "input_size",
         "(64, 64)", "test_size", "(64, 64)", "compute_dtype", "float32",
         "data_num_workers", "1", "max_epoch", "1", "warmup_epochs", "0", "print_interval", "1"]
KINDS = ("prune", "tune", "synflow")


def scaled_synflow_hook(trainer, stage):
    """compress_hook, with the model's kernels scaled by 0.3 before SynFlow
    scores them (a module-level function: the spawned ranks import it)."""
    out = tr.compress_hook(trainer, stage)
    if stage == "start":
        before_train = trainer.before_train

        def scaled():
            before_train()
            with torch.no_grad():
                for name, p in trainer.model.named_parameters():
                    if p.dim() == 4:
                        p.mul_(0.3)
        trainer.before_train = scaled
    return out


def _argv(kind, root, out, init=None, ranks=1):
    exp = {"prune": ("prune", "yolox_m_p6_prune.py"),
           "tune": ("tune", "yolox_m_p6_tune_distill.py"),
           "synflow": ("synflow", "yolox_m_synflow.py")}[kind]
    extra = {"prune": ["no_aug_epochs", "1", "prune_channels", "24", "prune_score_batches",
                       "1", "prune_site_floor", "1", "init_ckpt", "None"],
             "tune": ["no_aug_epochs", "0", "init_ckpt", init or "None"],
             "synflow": ["no_aug_epochs", "0", "prune_epoch", "0", "prune_iters", "3"]}[kind]
    # the exps' multiscale span: a (lo, hi) pair, and SynFlow's exp an int
    extra += ["multiscale_range", "0" if kind == "synflow" else "(0, 0)"]
    return ["-f", os.path.join(EXPS, *exp), "-d", str(ranks), *SMALL, *extra, "data_dir", root,
            "output_dir", out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("compress_ranks"))
    root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=4, n_val=2,
                               size_range=(64, 96), seed=0)
    mains = {"prune": tprune.main, "tune": ttune.main, "synflow": tsyn.main}
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
        for kind in KINDS:
            hook = scaled_synflow_hook if kind == "synflow" else tr.compress_hook
            init = (os.path.join(tmp, "single_prune", "yolox_m_p6_prune", "latest_ckpt.msgpack")
                    if kind == "tune" else None)
            single = mains[kind](_argv(kind, root, os.path.join(tmp, f"single_{kind}"), init),
                                 rank_hook=hook)
            out[kind] = {"single": {**hook(single, "end"), "digest": single.state_digest()}}
            single.after_train()
            out[kind]["ranks"] = mains[kind](
                _argv(kind, root, os.path.join(tmp, f"ranks_{kind}"), init, ranks=2),
                rank_hook=hook).ranks
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_hold_one_state(runs, kind):
    ranks = runs[kind]["ranks"]
    assert len(ranks) == 2 and ranks[0]["digest"] == ranks[1]["digest"]
    for path, v in ranks[0]["hook"]["variables"].items():
        np.testing.assert_array_equal(ranks[1]["hook"]["variables"][path], v, err_msg=str(path))


@pytest.mark.parametrize("kind", KINDS)
def test_masks_equal_the_single_rank(runs, kind):
    """The Pruner's gates after its events, the Tuner's fixed gates and
    SynFlow's conv masks: bit for bit the single rank's, on both ranks."""
    single = runs[kind]["single"]
    want = {p: v for p, v in single["variables"].items() if p[0] == "masks"}
    assert want
    for rank in runs[kind]["ranks"]:
        got = rank["hook"]
        for path, v in want.items():
            if path[-1] == "offset":
                np.testing.assert_allclose(got["variables"][path], v, rtol=1e-3, atol=1e-9,
                                           err_msg=str(path))
            else:
                np.testing.assert_array_equal(got["variables"][path], v, err_msg=str(path))
        for name, v in single["conv_masks"].items():
            np.testing.assert_array_equal(got["conv_masks"][name], v, err_msg=name)
        assert got["events"] == single["events"]
        assert got["synflow_kept"] == single["synflow_kept"]
    if kind == "prune":
        assert [e["pruned"] for e in single["events"]] == [24, 24]
    if kind == "synflow":
        total = sum(v.size for v in single["conv_masks"].values())
        assert single["synflow_kept"] == round(total * 0.5)


@pytest.mark.parametrize("kind", KINDS)
def test_losses_match_the_single_rank(runs, kind):
    want = runs[kind]["single"]["log"]
    for rank in runs[kind]["ranks"]:
        got = rank["hook"]["log"]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in tr.LOSSES:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-7, err_msg=k)
            assert np.isfinite(g["loss"])
