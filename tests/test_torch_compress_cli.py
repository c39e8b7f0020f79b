"""The compression chain's CLIs on the port (cocodet_tpu_torch/tools/prune.py,
tune.py, compress_pipeline.py), in process on the CPU, on the port's exp
copies at depth 0.33, width 0.125, 64 px, B=2, f32, over 4 synthetic train
and 2 val JPEGs: the Pruner for one epoch of 2 iterations with a prune event
after each, the Tuner from its checkpoint with distillation, then the
pipeline with ``--slim`` on the Tuner's checkpoint, and the w8a8 headline
built from the spec it wrote.

Every file is read by JAX's ``load_checkpoint`` and holds what JAX's tools
would have written from the same input: the Pruner's and Tuner's
checkpoints the trainer's keys with the ``masks`` collection in ``model``
(not in ``raw_model``), the masks, the injected tree and the slim spec
equal to JAX's functions' on the same checkpoint, the merged tree within
rtol 2e-6, atol 1e-6 (tests/test_torch_magnitude.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import magnitude as jmag
from cocodet_tpu.compress import merge as jmerge
from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.entry import build_headline
from cocodet_tpu_torch.tools import compress_pipeline, prune, tune
from cocodet_tpu_torch.utils.convert import flatten_tree

EXPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cocodet_tpu_torch", "exps")


def _opts(root, out):
    return ["-b", "2", "--device", "cpu", "depth", "0.33", "width", "0.125",
            "input_size", "(64, 64)", "test_size", "(64, 64)", "compute_dtype", "float32",
            "data_num_workers", "1", "data_dir", root, "output_dir", out,
            "print_interval", "1", "max_epoch", "1", "warmup_epochs", "0"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("compress_cli"))
    root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=4, n_val=2,
                               size_range=(64, 96), seed=0)
    out = os.path.join(tmp, "out")
    pruner = prune.main(["-f", os.path.join(EXPS, "prune", "yolox_m_p6_prune.py"),
                         *_opts(root, out), "no_aug_epochs", "1", "prune_channels", "24",
                         "prune_score_batches", "1", "init_ckpt", "None"])
    pruned = os.path.join(pruner.file_name, "latest_ckpt.msgpack")
    tuner = tune.main(["-f", os.path.join(EXPS, "tune", "yolox_m_p6_tune_distill.py"),
                       *_opts(root, out), "no_aug_epochs", "0", "eval_interval", "1",
                       "init_ckpt", pruned])
    tuned = os.path.join(tuner.file_name, "latest_ckpt.msgpack")
    written = compress_pipeline.main(["-c", tuned, "-o", os.path.join(tmp, "weights"),
                                      "--slim"])
    return {"pruner": pruner, "pruned": pruned, "tuner": tuner, "tuned": tuned,
            "written": written}


def _same(got, want, exact=True):
    """Two nested trees: the same leaves, equal (or within the merge's
    tolerance)."""
    g = flatten_dict(got)
    w = flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in w:
        if exact:
            np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=str(k))
        else:
            np.testing.assert_allclose(np.asarray(g[k]), w[k], rtol=2e-6, atol=1e-6,
                                       err_msg=str(k))


def test_prune_cli_prunes_and_writes_a_masked_checkpoint(chain):
    pruner = chain["pruner"]
    assert [e["pruned"] for e in pruner.prune_events] == [24, 24]
    assert pruner.epoch_stats[0]["iterations"] == 2
    assert pruner.epoch_stats[0]["nonfinite_losses"] == 0
    ck = jax_load_checkpoint(chain["pruned"])
    assert set(ck) == {"start_epoch", "model", "raw_model", "opt_state", "best_ap"}
    assert set(ck["model"]) == {"params", "batch_stats", "masks"}
    assert set(ck["raw_model"]) == {"params", "batch_stats"}
    closed = sum(int((np.asarray(v) == 0).sum()) for k, v in flatten_dict(ck["model"]["masks"])
                 .items() if k[-1] == "scale")
    assert closed == 48


def test_tune_cli_keeps_the_masks(chain):
    tuner = chain["tuner"]
    assert tuner.use_mask and tuner.distill_coefficient > 0
    assert tuner.epoch_stats[0]["nonfinite_losses"] == 0
    pruned = jax_load_checkpoint(chain["pruned"])["model"]["masks"]
    tuned = jax_load_checkpoint(chain["tuned"])
    assert set(tuned["model"]) == {"params", "batch_stats", "masks"}
    _same(tuned["model"]["masks"], pruned)
    assert tuner.eval_stats and tuner.eval_stats[0]["epoch"] == 1


def test_compress_pipeline_outputs_match_jax(chain):
    files = chain["written"]["files"]
    assert set(files) == {"mask", "direct_mask", "merged", "slim", "slim_spec"}
    assert [os.path.basename(files[k]) for k in ("mask", "direct_mask", "merged", "slim")] == [
        "mask_49_ckpt.msgpack", "direct_mask_49_ckpt.msgpack", "merged_49_ckpt.msgpack",
        "merged_49_slim_ckpt.msgpack"]
    variables = jax_load_checkpoint(chain["tuned"])["model"]
    masks = jmag.generate_magnitude_masks(variables["params"], prune_ratio=0.49, verbose=False)
    _same(jax_load_checkpoint(files["mask"])["masks"], masks)
    injected = jmag.inject_masks(variables, masks)
    _same(jax_load_checkpoint(files["direct_mask"])["model"], injected)
    merged = jmerge.merge_for_deployment(injected)
    _same(jax_load_checkpoint(files["merged"])["model"], merged, exact=False)
    _, spec = jmerge.slim_channels(jax.tree_util.tree_map(np.asarray, merged),
                                   injected["masks"])
    with open(files["slim_spec"]) as f:
        assert json.load(f) == json.loads(json.dumps(spec))
    assert chain["written"]["before_merge"] == jmerge.count_effective_params(
        injected, injected["masks"])


def test_headline_serves_the_ports_spec(chain):
    """entry.build_headline on the spec the pipeline wrote, with its slimmed
    tree: calibrated, quantized w8a8 and served on the CPU."""
    files = chain["written"]["files"]
    slimmed = jax_load_checkpoint(files["slim"])["model"]
    headline = build_headline(files["slim_spec"], depth=0.33, width=0.125,
                              dtype=torch.float32, device="cpu", variables=slimmed)
    images = np.random.RandomState(0).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    res = headline(images)
    assert tuple(res.boxes.shape) == (2, 300, 4) and torch.isfinite(res.boxes).all()
    assert any(k[-1] == "act_scale" for k in flatten_tree(headline.variables))


def test_port_reads_a_jax_masked_checkpoint(tmp_path):
    """A checkpoint JAX's save_checkpoint wrote from a pruned tree with
    ChannelMask gates and magnitude conv_masks: the port's trainer builds
    the ChannelMask model from it and loads params, statistics and gates;
    the conv_mask leaves, which the model lacks, are dropped (as JAX's
    load_matched drops them)."""
    from cocodet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from cocodet_tpu_torch.core.trainer import Trainer
    from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
    from cocodet_tpu_torch.utils.checkpoint import load_checkpoint
    from cocodet_tpu_torch.utils.convert import export_variables, random_variables
    from test_torch_channel_mask import close_some

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, use_mask=True)
    variables = close_some(random_variables(shapes, 1), 2)
    tree = jmag.inject_masks(variables, jmag.generate_magnitude_masks(
        variables["params"], verbose=False))
    path = jax_save_checkpoint({"model": tree}, False, str(tmp_path), "jax_pruned")
    model = load_checkpoint(path)["model"]
    assert any(k[-1] == "conv_mask" for k in flatten_tree(model["masks"]))
    trainer = object.__new__(Trainer)
    trainer.model = build_model("yolox-p6", depth=0.33, width=0.125, device="cpu",
                                use_mask=True)
    trainer._load_matched_into_model(model)
    got = flatten_tree(export_variables(trainer.model))
    want = flatten_tree(variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
