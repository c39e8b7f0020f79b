"""The Pruner and Tuner of the port (cocodet_tpu_torch/core/pruner.py,
tuner.py) against JAX's (cocodet_tpu/core/pruner.py, tuner.py), on the CPU.

Exact, given the same inputs:
- ``find_residual_groups`` on the masked model's scopes;
- ``apply_channel_prune``'s masks and count, given the same importance, for
  every option (``site_floor``, ``max_frac``, ``normalize="mean"``, tied
  residual groups, a count that makes a group pick overshoot), on
  importance with ties, in two rounds (already-pruned channels);
- the masks of a whole Pruner run of two prune events in f64
  (``jax.enable_x64``: f32 step parity is lost to BN over 1x1 maps,
  tests/torch_train_utils.py), so that the ranking is the same.

At a tolerance:
- ``channel_importance`` on the same arrays: 1e-6 relative (XLA may
  contract the products into FMAs);
- the score step's importance from each package's own gradients (f32,
  yolox-p6 depth 0.33, width 0.125, 64 px, B=2): 1e-3 of each site's
  largest value plus 1e-3 relative;
- the Pruner run in f64: the importance of each event within 1e-6 of its
  site's largest; each run's first step's losses within 1e-6 (they are f32
  in both). A later step's losses carry the f32 rounding of the losses'
  gradients (1e-7 relative) through an update, which BN over the 1x1 and
  2x2 maps of two images magnifies (tests/test_torch_train_step.py): each
  run's second step within 1e-4 (measured 1.3e-6 in the Pruner's, 1.0e-5
  in the Tuner's).
- the Tuner from the Pruner's checkpoint (written by the port, read by
  both), with the dense init as ``teacher_ckpt``: after its first distill
  step every parameter within 1e-5 of its update and every BN statistic
  within 1e-9; the gates unchanged after both.

The port's Pruner and Tuner are the classes as the CLIs run them, fed two
fixed batches by a stand-in loader and cast to f64 after ``before_train``;
JAX's side is its steps and selection in the order of its Pruner's and
Tuner's loops (pruner.py:385-424, tuner.py:69-88).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from cocodet_tpu.core import pruner as jpr
from cocodet_tpu.core.train_state import create_train_state as jax_create_state
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from cocodet_tpu_torch.core import pruner as tpr
from cocodet_tpu_torch.core.tuner import Tuner
from cocodet_tpu_torch.exp import get_exp_by_file
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree, random_variables
from test_torch_channel_mask import close_some
from torch_train_utils import DEPTH, STRIDES, WIDTH, inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 0.01
PRUNE = dict(prune_channels=40, site_floor=2, max_frac=0.75, normalize="mean")


def _masked_variables(seed=0):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=DEPTH, width=WIDTH, use_mask=True)
    return random_variables(shapes, seed)


def _random_importance(variables, seed, ties=True):
    rs = np.random.RandomState(seed)
    out = {}
    for path, v in flatten_tree(variables["masks"]).items():
        if path[-1] == "scale":
            a = rs.exponential(1.0, v.shape[0])
            out[path[:-2]] = (np.round(a, 1) if ties else a).astype(np.float32)
    return out


def test_channel_importance_matches_jax():
    variables = _masked_variables()
    rs = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(lambda a: rs.normal(0, 1, a.shape).astype(np.float32),
                                   variables["params"])
    want = jpr.channel_importance(variables, grads)
    got = tpr.channel_importance(variables, grads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6, atol=0)


def test_find_residual_groups_matches_jax():
    variables = _masked_variables()
    params = flatten_tree(variables["params"])
    scopes = [k[:-2] for k in flatten_tree(variables["masks"]) if k[-1] == "scale"]
    got = tpr.find_residual_groups(scopes, params)
    assert got == jpr.find_residual_groups(scopes, traverse_util.flatten_dict(
        variables["params"]))
    # dark2-dark4 CSPs and no SPP conv1, each with its bottlenecks' conv2s
    assert sorted(k[-2] for k in got) == ["dark2_csp", "dark3_csp", "dark4_csp"]
    assert [len(v) for _, v in sorted(got.items())] == [1, 3, 3]


@pytest.mark.parametrize("options", [
    dict(), dict(site_floor=6), dict(max_frac=0.3), dict(normalize="mean"),
    dict(site_floor=4, max_frac=0.6, normalize="mean"), dict(prune_channels=1),
    dict(prune_channels=3000, max_frac=0.5)], ids=lambda o: "-".join(
        f"{k}={v}" for k, v in o.items()) or "default")
def test_apply_channel_prune_matches_jax(options):
    options = dict(options)
    count = options.pop("prune_channels", 120)
    variables = close_some(_masked_variables(2), 3, frac=0.1)
    counts = []
    for round_ in range(2):
        importance = _random_importance(variables, 10 + round_)
        want, n_want = jpr.apply_channel_prune(variables, importance, count, **options)
        got, n_got = tpr.apply_channel_prune(variables, importance, count, **options)
        assert n_got == n_want
        w = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want["masks"]))
        g = flatten_tree(got["masks"])
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
        variables = got
        counts.append(n_got)
    assert counts[0] > 0


def test_group_picks_prune_every_tied_site():
    """A residual group (dark3: conv1 and three bottleneck conv2s, 4 sites)
    ranked cheapest: its first pick closes the channel at every tied site
    and costs 4; a second would overshoot a count of 6, so cheaper sites
    fill the rest. Exact against JAX."""
    variables = _masked_variables(4)
    importance = _random_importance(variables, 5, ties=False)
    csp = ("backbone", "backbone", "dark3_csp")
    lead, members = csp + ("conv1",), [csp + (f"m{i}", "conv2") for i in range(3)]
    for site in [lead, *members]:
        importance[site][:] = 0.0
    want, n_want = jpr.apply_channel_prune(variables, importance, 6)
    got, n = tpr.apply_channel_prune(variables, importance, 6)
    m = flatten_tree(got["masks"])
    w = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, want["masks"]))
    for k in w:
        np.testing.assert_array_equal(m[k], w[k], err_msg=str(k))
    closed = m[lead + ("mask", "scale")] == 0
    assert closed.sum() == 1 and n == n_want == 6
    for site in members:
        np.testing.assert_array_equal(m[site + ("mask", "scale")] == 0, closed)


def test_score_step_matches_jax():
    variables, images, labels = inputs()
    masked = close_some({**variables, "masks": _masked_variables()["masks"]}, 6, frac=0.2)
    jm = jax_build("yolox-p6", depth=DEPTH, width=WIDTH, use_mask=True)
    want = jax.device_get(jpr.make_score_step(jm, STRIDES)(masked, jnp.asarray(images),
                                                           jnp.asarray(labels)))
    model = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu", use_mask=True,
                        variables=masked)
    got = tpr.make_score_step(model, STRIDES)(torch.from_numpy(images), torch.from_numpy(labels))
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(w.max()), err_msg=str(k))
    assert not model.training  # build_model's eval mode, restored


# --------------------------------------------------------------------------
# a Pruner and a Tuner run, f64
# --------------------------------------------------------------------------


class FakeLoader:
    """Two fixed batches in turns, as a loader of 4 images at B=2."""

    dataset = range(4)

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        k = 0
        while True:
            imgs, labels = self.batches[k % 2]
            yield imgs, labels, None, None
            k += 1

    def close_mosaic(self):
        pass


def _batches():
    _, images, labels = inputs()
    other = np.random.RandomState(9).uniform(0, 255, images.shape).astype(np.float32)
    return [(images.astype(np.float64), labels), (other.astype(np.float64), labels)]


def _port_exp(path, tmp, monkeypatch, batches, **attrs):
    exp = get_exp_by_file(os.path.join(REPO, "cocodet_tpu_torch", "exps", path))
    exp.merge(["depth", str(DEPTH), "width", str(WIDTH), "input_size", "(64, 64)",
               "compute_dtype", "float32", "output_dir", tmp, "print_interval", "1"])
    for k, v in attrs.items():
        setattr(exp, k, v)
    monkeypatch.setattr(exp, "get_data_loader", lambda **kw: FakeLoader(batches))
    monkeypatch.setattr(exp, "get_evaluator", lambda **kw: None)
    return exp


class Args:
    batch_size = 2
    resume = False
    ckpt = None
    cache = False
    no_aug = False
    start_epoch = None


def _to_f64(trainer, *models):
    for m in models:
        m.to(torch.float64)
        m.dtype = torch.float64
    trainer.optimizer.schedule = lambda count: LR


def _jax_tx():
    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    return optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                       optax.sgd(LR, momentum=0.9, nesterov=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pruner"))
    mp = pytest.MonkeyPatch()
    variables, _, _ = inputs()
    init = save_checkpoint({"model": variables}, False, tmp, "init")
    batches = _batches()
    try:
        # the port's Pruner: 2 iterations, a prune event after each
        exp = _port_exp("prune/yolox_m_p6_prune.py", tmp, mp, batches, init_ckpt=init,
                        prune_channels=PRUNE["prune_channels"], prune_score_batches=1,
                        prune_site_floor=PRUNE["site_floor"],
                        prune_max_frac=PRUNE["max_frac"], prune_normalize=PRUNE["normalize"])
        pruner = tpr.Pruner(exp, Args(), device="cpu")
        pruner.before_train()
        _to_f64(pruner, pruner.model, pruner.teacher_model)
        imps, steps = [], []
        score, step = pruner.score_step, pruner.train_step
        pruner.score_step = lambda *a: imps.append(score(*a)) or imps[-1]
        pruner.train_step = lambda *a, **k: steps.append(step(*a, **k)) or steps[-1]
        pruner.epoch = 0
        pruner.train_in_iter()
        pruner.save_ckpt("latest")
        pruned = os.path.join(pruner.file_name, "latest_ckpt.msgpack")
        port = {"events": pruner.prune_events, "imps": imps, "steps": steps,
                "masks": flatten_tree(export_variables(pruner.model)["masks"])}
        pruner.after_train()

        # the port's Tuner from the Pruner's checkpoint, the dense init the teacher
        exp = _port_exp("tune/yolox_m_p6_tune_distill.py", tmp, mp, batches, init_ckpt=pruned,
                        teacher_ckpt=init, ema=False, warmup_epochs=0, no_aug_epochs=0,
                        max_epoch=2)
        tuner = Tuner(exp, Args(), device="cpu")
        tuner.before_train()
        assert tuner.use_mask
        _to_f64(tuner, tuner.model, tuner.teacher_model)
        tsteps, after_one = [], []
        dstep = tuner.distill_step

        def tune_step(*a, **k):
            tsteps.append(dstep(*a, **k))
            if len(tsteps) == 1:
                after_one.append(flatten_tree(export_variables(tuner.model)))
            return tsteps[-1]

        tuner.distill_step = tune_step
        tuner.epoch = 0
        tuner.train_in_iter()
        port["tune_steps"] = tsteps
        port["tuned"] = after_one[0]
        port["tuned_masks"] = flatten_tree(export_variables(tuner.model)["masks"])
        tuner.after_train()
    finally:
        mp.undo()

    # JAX: its Pruner's and Tuner's loops over the same batches
    ck = jax_load_checkpoint(pruned)["model"]
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        jm = jax_build("yolox-p6", depth=DEPTH, width=WIDTH, use_mask=True)
        jt = jax_build("yolox-p6", depth=DEPTH, width=WIDTH)
        tx = _jax_tx()
        state = jax_create_state(jm, tx, None, None, use_ema=False, init_vars=f64(variables))
        masks = jax.tree_util.tree_map(jnp.asarray, _masked_variables()["masks"])
        step = jpr.make_distill_train_step(jm, jt, tx, strides=STRIDES, use_ema=False)
        score = jpr.make_score_step(jm, STRIDES)
        jb = [(jnp.asarray(i), jnp.asarray(lab)) for i, lab in batches]
        want = {"events": [], "imps": [], "steps": []}
        for _ in range(2):
            state, metrics = step(state, f64(variables), masks, *jb[0], use_l1=False)
            want["steps"].append(jax.device_get(metrics))
            cur = {"params": state.params, "batch_stats": state.batch_stats, "masks": masks}
            imp = jax.device_get(score(cur, *jb[1]))
            want["imps"].append(imp)
            new, n = jpr.apply_channel_prune(cur, imp, PRUNE["prune_channels"],
                                             site_floor=PRUNE["site_floor"],
                                             max_frac=PRUNE["max_frac"],
                                             normalize=PRUNE["normalize"])
            masks = new["masks"]
            want["events"].append(n)
        want["masks"] = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, masks))
        # JAX's Tuner loads the checkpoint into its f32 state (load_matched), as the port's
        f32 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
        tstate = jax_create_state(jm, tx, None, None, use_ema=False, init_vars=f64(f32(
            {"params": ck["params"], "batch_stats": ck["batch_stats"]})))
        cmasks = jax.tree_util.tree_map(jnp.asarray, ck["masks"])
        want["tune_steps"] = []
        for k in range(2):
            tstate, metrics = step(tstate, f64(variables), cmasks, *jb[k], use_l1=False)
            want["tune_steps"].append(jax.device_get(metrics))
            if k == 0:
                want["tuned"] = traverse_util.flatten_dict(jax.device_get(
                    {"params": tstate.params, "batch_stats": tstate.batch_stats}))
        want["tune_init"] = traverse_util.flatten_dict(
            f32({"params": ck["params"], "batch_stats": ck["batch_stats"]}))
        want["ckpt_masks"] = traverse_util.flatten_dict(ck["masks"])
    return port, want


def test_pruner_run_masks_match_jax_f64(runs):
    port, want = runs
    assert [e["pruned"] for e in port["events"]] == want["events"]
    assert all(n > 0 for n in want["events"])
    assert port["masks"].keys() == want["masks"].keys()
    for k, w in want["masks"].items():
        if k[-1] == "scale":
            np.testing.assert_array_equal(port["masks"][k], w, err_msg=str(k))
        else:
            np.testing.assert_allclose(port["masks"][k], w, rtol=1e-6, atol=1e-7,
                                       err_msg=str(k))
    # the checkpoint carries them, as JAX's load_checkpoint reads it
    for k, w in want["ckpt_masks"].items():
        np.testing.assert_array_equal(np.asarray(w), port["masks"][k].astype(np.float32))


def test_pruner_run_importance_and_losses_match_jax_f64(runs):
    port, want = runs
    for got, imp in zip(port["imps"], want["imps"]):
        for k, w in imp.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-6 * float(w.max()) + 1e-300, err_msg=str(k))
    for key in ("steps", "tune_steps"):
        for i, (got, w) in enumerate(zip(port[key], want[key])):
            rtol = 1e-6 if i == 0 else 1e-4  # after an update: see the docstring
            for k in tpr.METRICS:
                np.testing.assert_allclose(float(got[k]), float(w[k]), rtol=rtol, atol=1e-7,
                                           err_msg=f"{key} {i} {k}")


def test_tuner_run_matches_jax_f64(runs):
    port, want = runs
    for k, w in want["tuned"].items():
        path = k
        p0 = np.asarray(want["tune_init"][k], np.float64)
        upd = np.abs(np.asarray(w) - p0).max()
        d = np.abs(port["tuned"][path] - np.asarray(w)).max()
        limit = 1e-5 * upd + 1e-12 if k[0] == "params" else 1e-9 * np.abs(w).max()
        assert d <= limit, (k, d, upd)
    # the gates stay fixed through the tune
    for k, w in want["ckpt_masks"].items():
        np.testing.assert_array_equal(port["tuned_masks"][k].astype(np.float32),
                                      np.asarray(w))
