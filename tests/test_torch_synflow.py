"""SynFlow of the port (the weight-mask model of models/blocks.py,
core/trainer_synflow.py, exp SynFlowExp, the conv_mask leaves of
utils/convert.py and utils/checkpoint.py) against JAX's (blocks.py:219-223,
core/trainer_synflow.py, exp/yolox_exp.py:352-363), on the CPU, on the
SynFlow exp's model ("yolox", three levels) at depth 0.33, width 0.25 (0.125
for the trainer), 64 px.

Exact:
- the weight-mask model's layout (which convs carry a ``conv_mask``)
  against ``jax.eval_shape`` of flax's init;
- ``conv_mask`` leaves through checkpoints both ways (the port's bytes
  read by JAX's ``load_checkpoint``, JAX's loaded by the port) and into a
  weight-mask model, and skipped by a model without one;
- ``synflow_update_masks`` against JAX's on the same (tie-free) scores, and
  on scores with ties and NaN: the kept count, no dropped score above a
  kept one, the lower flat index kept on a tie, NaN never kept;
- the selections of both packages on their own scores in f64
  (``jax.enable_x64``), round after round, and a whole TrainerSynFlow epoch
  (prune_epoch 0, 3 rounds) against JAX's rounds in f64: the masks and the
  kept count.

At a tolerance:
- the weight-mask model's head maps with random 0/1 masks: 1e-5 of each
  map's largest magnitude (f32 convs sum in another order);
- one score pass in f32: 1e-5 of each leaf's largest score (measured 1.2e-6:
  the output sum is about 4e20, and the gradient of that sum through 40
  convs carries the f32 rounding of both frameworks' conv orders).

The kernels are scaled by 0.3 from ``random_variables``' U(+-sqrt(3/fan_in)):
at their full size the all-ones pass overflows f32 in both packages alike
(the same non-finite scores in both at width 0.25), and NaN scores make the
selection a rule about NaN, which the tie and NaN cases test apart.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.core import trainer_synflow as jsf
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from cocodet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from cocodet_tpu_torch.core import trainer_synflow as tsf
from cocodet_tpu_torch.exp import SynFlowExp, get_exp_by_file
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cocodet_tpu_torch.utils.convert import (export_tensors, export_variables, flatten_tree,
                                             jax_layout, load_variables, random_variables,
                                             unflatten_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, W, S = 0.33, 0.25, 64


def _variables(width=W, seed=0, keep=0.7):
    """The weight-mask model's variables: kernels at 0.3 of random_variables',
    about ``keep`` of each conv_mask 1."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox"], depth=D, width=width, weight_mask=True)
    flat = flatten_tree(random_variables(shapes, seed))
    rs = np.random.RandomState(seed + 1)
    for k in flat:
        if k[-1] == "conv_mask":
            flat[k] = (rs.rand(*flat[k].shape) < keep).astype(np.float32)
        elif k[-1] == "kernel":
            flat[k] = flat[k] * np.float32(0.3)
    return unflatten_tree(flat)


def _kernel_scores(scores_flax, model):
    """JAX's score tree -> the port's {parameter name: OIHW score} of the
    masked kernels."""
    flat = flatten_dict(scores_flax)
    return {f"{name}.weight": torch.from_numpy(
        np.asarray(flat[tuple(name.split(".")) + ("kernel",)]).transpose(3, 2, 0, 1).copy())
        for name in tsf.mask_sites(model)}


def _port_masks(model):
    return flatten_tree(export_variables(model)["masks"])


# --------------------------------------------------------------------------
# the weight-mask model and its masks across packages
# --------------------------------------------------------------------------


def test_weight_mask_layout_matches_flax():
    jm = jax_build("yolox", depth=D, width=W, weight_mask=True)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    want = {k: tuple(v.shape) for k, v in flatten_dict(dict(want)).items()}
    with torch.device("meta"):
        model = YOLOX(MODEL_SPECS["yolox"], depth=D, width=W, weight_mask=True)
    got = jax_layout(model)
    assert got == want
    masked = {k[1:-2] for k in got if k[-1] == "conv_mask"}
    assert not any(s[0] == "head" or s[1].startswith(("lateral", "bu_conv")) for s in masked)
    assert len(masked) == sum(1 for k in got if k[0] == "params" and k[-1] == "kernel"
                              and k[1] == "backbone" and not k[2].startswith(("lateral",
                                                                              "bu_conv")))


def test_masked_model_matches_jax():
    variables = _variables()
    imgs = np.random.RandomState(0).uniform(0, 255, (2, S, S, 3)).astype(np.float32)
    jm = jax_build("yolox", depth=D, width=W, weight_mask=True)
    want = jax.jit(jm.apply)(variables, imgs)
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        for k in ("reg", "obj", "cls"):
            w_k = np.asarray(w[k])
            np.testing.assert_allclose(g[k].numpy(), w_k, rtol=0,
                                       atol=1e-5 * np.abs(w_k).max(), err_msg=k)


def test_masked_weight_contributes_nothing():
    variables = _variables()
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables)
    x = torch.from_numpy(np.random.RandomState(2).uniform(0, 255, (1, S, S, 3))
                         .astype(np.float32))
    with torch.no_grad():
        before = model(x)
        for conv in tsf.mask_sites(model).values():
            conv.weight.add_(torch.randn_like(conv.weight) * (1 - conv.conv_mask))
        after = model(x)
    for a, b in zip(before, after):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_conv_mask_checkpoints_both_ways(tmp_path):
    variables = _variables()
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables)
    mine = save_checkpoint({"model": export_variables(model)}, False, str(tmp_path), "port")
    read = flatten_dict(jax_load_checkpoint(mine)["model"])
    for k, v in flatten_tree(variables).items():
        assert np.array_equal(np.asarray(read[k]), v), k
    jax_save_checkpoint({"model": variables}, False, str(tmp_path), "jax")
    theirs = load_checkpoint(os.path.join(str(tmp_path), "jax_ckpt.msgpack"))["model"]
    other = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=theirs)
    assert {k: v.tobytes() for k, v in _port_masks(other).items()} == \
        {k: v.tobytes() for k, v in flatten_tree(variables["masks"]).items()}
    # a model without weight masks skips the conv_mask leaves
    plain = build_model("yolox", depth=D, width=W, device="cpu")
    load_variables(plain, theirs)
    assert "masks" not in export_variables(plain)


# --------------------------------------------------------------------------
# the score pass and the selection
# --------------------------------------------------------------------------


def test_score_step_matches_jax():
    variables = _variables()
    jm = jax_build("yolox", depth=D, width=W, weight_mask=True)
    want = flatten_dict(jax.device_get(jsf.make_synflow_score_step(jm, (S, S))(variables)))
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables).train()
    scores, total = tsf.make_synflow_score_step(model, (S, S))()
    assert model.training and np.isfinite(float(total))
    got = flatten_tree(export_tensors(scores)["params"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=str(k))


def test_update_masks_matches_jax_on_the_same_scores():
    variables = _variables()
    jm = jax_build("yolox", depth=D, width=W, weight_mask=True)
    scores = jax.device_get(jsf.make_synflow_score_step(jm, (S, S))(variables))
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables)
    kernel_scores = _kernel_scores(scores, model)
    flat = torch.cat([s.reshape(-1) for s in kernel_scores.values()])
    ranked = torch.sort(flat, descending=True).values
    for keep in (0.35, 0.5 ** 2.5, 0.1):
        n = max(int(round(flat.numel() * keep)), 1)
        assert ranked[n - 1] > ranked[n]  # no tie at the cut: one right answer
        want = flatten_dict(jsf.synflow_update_masks(variables, scores, keep)["masks"])
        n = tsf.synflow_update_masks(model, kernel_scores, keep)
        got = _port_masks(model)
        for k in want:
            assert np.array_equal(got[k], np.asarray(want[k])), (keep, k)
        assert n == sum(int(np.asarray(m).sum()) for m in want.values())
        assert n == max(int(round(flat.numel() * keep)), 1)


def test_selection_with_ties_and_nan():
    rs = np.random.RandomState(5)
    shapes = [(4, 3, 3, 3), (6, 4, 1, 1), (2, 6, 3, 3)]
    scores = [torch.from_numpy(rs.randint(0, 5, s).astype(np.float32)) for s in shapes]
    flat = torch.cat([s.permute(2, 3, 1, 0).reshape(-1) for s in scores])
    for keep in (0.5, 0.37, 0.9, 1e-9):
        masks = tsf.synflow_keep(scores, keep)
        kept = torch.cat([m.permute(2, 3, 1, 0).reshape(-1) for m in masks]).bool()
        n = max(int(round(flat.numel() * keep)), 1)
        assert int(kept.sum()) == n
        if n < flat.numel():
            assert flat[~kept].max() <= flat[kept].min()
            cut = flat[kept].min()
            tied = torch.nonzero(flat == cut).flatten()
            n_tied = int(kept[tied].sum())
            assert kept[tied[:n_tied]].all() and not kept[tied[n_tied:]].any()
    nan = [s.clone() for s in scores]
    nan[0].view(-1)[::3] = float("nan")
    flat_nan = torch.cat([s.permute(2, 3, 1, 0).reshape(-1) for s in nan])
    kept = torch.cat([m.permute(2, 3, 1, 0).reshape(-1)
                      for m in tsf.synflow_keep(nan, 0.5)]).bool()
    assert not torch.isnan(flat_nan[kept]).any()
    # numpy puts NaN last too: JAX keeps no NaN while enough others remain
    all_scores = flat_nan.numpy()
    n = int(kept.sum())
    jkeep = np.zeros(all_scores.size, bool)
    jkeep[np.argpartition(-all_scores, n - 1)[:n]] = True
    assert not np.isnan(all_scores[jkeep]).any()


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _jax_rounds_f64(variables, rounds, ratio, width=W):
    """JAX's apply_synflow loop (trainer_synflow.py:111-118) in f64."""
    with jax.enable_x64(True):
        jm = jax_build("yolox", depth=D, width=width, weight_mask=True, dtype=jnp.float64)
        step = jsf.make_synflow_score_step(jm, (S, S))
        v = {"params": _f64(variables["params"]), "batch_stats": _f64(variables["batch_stats"]),
             "masks": variables["masks"]}
        for i in range(1, rounds + 1):
            v = jsf.synflow_update_masks(v, jax.device_get(step(v)), ratio ** (i / rounds))
        return {k: np.asarray(m) for k, m in flatten_dict(v["masks"]).items()}


def test_selection_f64_matches_jax():
    variables = _variables(keep=1.0)  # each round's cut above the masked zeros
    want = _jax_rounds_f64(variables, 3, 0.5)
    model = build_model("yolox", depth=D, width=W, weight_mask=True, device="cpu",
                        variables=variables).to(torch.float64)
    model.dtype = torch.float64
    step = tsf.make_synflow_score_step(model, (S, S))
    for i in range(1, 4):
        tsf.synflow_update_masks(model, step()[0], 0.5 ** (i / 3))
    got = _port_masks(model)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# TrainerSynFlow
# --------------------------------------------------------------------------


class FakeLoader:
    """Two fixed batches in turns, as a loader of 4 images at B=2."""

    dataset = range(4)

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        k = 0
        while True:
            yield (*self.batches[k % 2], None, None)
            k += 1

    def close_mosaic(self):
        pass


class Args:
    batch_size = 2
    resume = False
    ckpt = None
    cache = False
    no_aug = False
    start_epoch = None


def test_exp_attributes():
    exp = get_exp_by_file(os.path.join(REPO, "cocodet_tpu_torch", "exps", "synflow",
                                       "yolox_m_synflow.py"))
    assert isinstance(exp, SynFlowExp)
    assert (exp.depth, exp.width, exp.model_name, exp.strides) == (0.67, 0.75, "yolox",
                                                                   (8, 16, 32))
    assert (exp.prune_iters, exp.prune_ratio, exp.prune_epoch) == (100, 0.5, 10)
    with torch.device("meta"):
        assert exp.get_model(device="meta", variables=None).weight_mask


def test_trainer_synflow_epoch_matches_jax_f64(tmp_path, monkeypatch):
    """One epoch of the port's TrainerSynFlow (prune_epoch 0, 3 rounds to
    half, 2 iterations) from an init checkpoint, cast to f64 after
    before_train; JAX's rounds in f64 on the same weights: the masks equal,
    the kept count exactly max(round(N / 2), 1), the losses finite, and the
    masks in the saved checkpoint."""
    variables = _variables(width=0.125, keep=1.0)
    init = save_checkpoint({"model": {k: variables[k] for k in ("params", "batch_stats")}},
                           False, str(tmp_path), "init")
    exp = get_exp_by_file(os.path.join(REPO, "cocodet_tpu_torch", "exps", "synflow",
                                       "yolox_m_synflow.py"))
    exp.merge(["depth", str(D), "width", "0.125", "input_size", f"({S}, {S})",
               "multiscale_range", "0", "compute_dtype", "float32", "output_dir", str(tmp_path),
               "print_interval", "1", "max_epoch", "1", "warmup_epochs", "0",
               "no_aug_epochs", "0", "eval_interval", "10", "prune_epoch", "0",
               "prune_iters", "3"])
    exp.ema, exp.init_ckpt = False, init
    rs = np.random.RandomState(0)
    labels = np.zeros((2, 4, 5), np.float32)
    labels[:, 0] = [1, 32, 32, 16, 16]
    batches = [(rs.uniform(0, 255, (2, S, S, 3)).astype(np.float64), labels) for _ in range(2)]
    monkeypatch.setattr(exp, "get_data_loader", lambda **kw: FakeLoader(batches))
    monkeypatch.setattr(exp, "get_evaluator", lambda **kw: None)
    trainer = tsf.TrainerSynFlow(exp, Args(), device="cpu")
    trainer.before_train()
    trainer.model.to(torch.float64)
    trainer.model.dtype = torch.float64
    trainer.epoch = 0
    trainer.before_epoch()
    got = _port_masks(trainer.model)
    trainer.train_in_iter()
    trainer.save_ckpt("latest")
    trainer.after_train()

    want = _jax_rounds_f64(variables, 3, 0.5, width=0.125)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    total = sum(m.size for m in want.values())
    st = trainer.synflow_stats
    assert st["total"] == total and st["kept"] == max(int(round(total * 0.5)), 1)
    assert st["kept"] == sum(int(m.sum()) for m in want.values())
    assert trainer.epoch_stats[0]["nonfinite_losses"] == 0
    assert all(np.isfinite(st["output_sums"])) and not any(st["nonfinite_scores"])
    saved = flatten_tree(load_checkpoint(os.path.join(trainer.file_name,
                                                      "latest_ckpt.msgpack"))["model"])
    for k, m in got.items():
        assert np.array_equal(saved[("masks",) + k], m), k
