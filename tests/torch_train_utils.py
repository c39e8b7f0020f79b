"""The train-step comparison shared by tests/test_torch_train_step.py (f64)
and tests/test_torch_train_step_f32.py: the model of
``__graft_entry__.dryrun_multichip`` (yolox-p6, depth 0.33, width 0.125) at
64 px, B=2, from the same numpy-drawn variables (head biases at the prior
0.01), with the optimizer of ``exp/yolox_exp.py`` (SGD, nesterov momentum
0.9, weight decay 5e-4 on the conv kernels) under a yoloxwarmcos schedule
whose lr changes every step, use_l1 on, three steps in each framework.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from cocodet_tpu.core.train_state import create_train_state as jax_create_state
from cocodet_tpu.core.train_state import make_train_step as jax_make_step
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.utils import lr_scheduler as jlr
from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils import lr_scheduler as tlr
from cocodet_tpu_torch.utils.convert import (export_variables, flatten_tree, jax_path,
                                             random_variables, unflatten_tree)

DEPTH, WIDTH, SIZE, BATCH = 0.33, 0.125, 64, 2
STRIDES = (8, 16, 32, 64)
SCHEDULE = dict(lr=0.01, iters_per_epoch=1, total_epochs=20, warmup_epochs=5,
                warmup_lr_start=0.002, no_aug_epochs=2)
STEPS = 3
METRICS = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss", "num_fg_per_gt")


def inputs(batch=BATCH, height=SIZE):
    """(variables, images (batch, height, 64, 3), labels (batch, 10, 5)):
    the first two images and their boxes are those of B=2 at 64 px, the
    boxes' y and height scaled with the image height."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=DEPTH, width=WIDTH)
    variables = random_variables(shapes, 3, prior_prob=0.01)
    rs = np.random.RandomState(0)
    images = rs.uniform(0, 255, (batch, height, SIZE, 3)).astype(np.float32)
    labels = np.zeros((batch, 10, 5), np.float32)
    boxes = [[[1, 32, 32, 16, 16], [5, 20, 40, 30, 20], [7, 50, 12, 10, 14]],
             [[2, 30, 30, 40, 40], [79, 10, 50, 12, 12]],
             [[3, 16, 48, 20, 12], [11, 44, 20, 24, 30]],
             [[4, 40, 24, 30, 18]]]
    for b in range(batch):
        labels[b, :len(boxes[b % 4])] = boxes[b % 4]
    labels[..., 2::2] *= height / SIZE
    return variables, images, labels


def jax_steps(variables, images, labels, dtype, mesh=None, steps=STEPS):
    """JAX's step ``steps`` times; on a ``mesh`` (cocodet_tpu.parallel) with
    the state replicated and the batch sharded."""
    from cocodet_tpu.parallel import replicate, shard_batch

    model = jax_build_model("yolox-p6", depth=DEPTH, width=WIDTH)

    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    tx = optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                     optax.sgd(jlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE),
                               momentum=0.9, nesterov=True))
    init = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(dtype)), variables)
    state = jax_create_state(model, tx, None, None, init_vars=init)
    step = jax_make_step(model, tx, strides=STRIDES, num_classes=80, donate=False)
    batch = (jnp.asarray(images.astype(dtype)), jnp.asarray(labels))
    if mesh is not None:
        state, batch = replicate(mesh, state), shard_batch(mesh, batch)
    out = []
    for _ in range(steps):
        state, metrics = step(state, *batch, use_l1=True)
        out.append(jax.device_get((metrics, {"params": state.params,
                                             "batch_stats": state.batch_stats},
                                   state.ema.shadow)))
    return out


def port_steps(variables, images, labels, dtype, steps=STEPS):
    model = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu",
                        variables=variables).to(dtype)
    model.dtype = dtype
    state = ts.create_train_state(
        model, ts.build_optimizer(model, tlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE)))
    step = ts.make_train_step(state, STRIDES)
    out = []
    for _ in range(steps):
        metrics = step(torch.from_numpy(images).to(dtype), torch.from_numpy(labels),
                       use_l1=True)
        shadow = {name: t.clone() for name, t in state.ema.shadow.items()}
        out.append(({k: float(v) for k, v in metrics.items()},
                    flatten_tree(export_variables(model)), shadow))
    return out


def run(dtype):
    """(initial flat variables, JAX's steps, the port's steps) in ``dtype``
    ("float32" or "float64", the latter under jax.enable_x64)."""
    variables, images, labels = inputs()
    if dtype == "float64":
        with jax.enable_x64(True):
            want = jax_steps(variables, images, labels, np.float64)
        got = port_steps(variables, images, labels, torch.float64)
    else:
        want = jax_steps(variables, images, labels, np.float32)
        got = port_steps(variables, images, labels, torch.float32)
    return flatten_tree(variables), want, got


def as_reference(port_step):
    """One of port_steps' steps in the layout of a JAX step (metrics, the
    flax variable tree, the EMA shadow as a flax tree), to hold another port
    step against it."""
    metrics, flat, shadow = port_step
    ema = {}
    for name, t in shadow.items():
        path, _ = jax_path(name, t)
        a = t.numpy()
        ema[path] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return metrics, unflatten_tree(flat), unflatten_tree(ema)


def _leaf_errors(p0, want, got):
    """{"params"|"batch_stats"|"ema": [(path, max |port - JAX|, max |JAX|,
    max |JAX update|)]} for one step's state."""
    _, wv, we = want
    _, gv, gshadow = got
    out = {"params": [], "batch_stats": [], "ema": []}
    for path, w in flatten_tree(wv).items():
        out[path[0]].append((path, np.abs(gv[path] - w).max(), np.abs(w).max(),
                             np.abs(w - p0[path]).max()))
    shadow = flatten_tree(we)
    for name, t in gshadow.items():
        path, _ = jax_path(name, t)
        a, w = t.numpy(), shadow[path]
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        out["ema"].append((path, np.abs(a - w).max(), np.abs(w).max(),
                           np.abs(w - p0[path]).max()))
    return out


def compare_tight(p0, want, got):
    """One f64 step, leaf by leaf: each parameter to 1e-5 of its update,
    each BN statistic to 1e-9 of its value, each EMA leaf (an f32 shadow)
    to 1e-5 of its update plus 4e-7 of its value (f32 rounding)."""
    wm, gm = want[0], got[0]
    for k in METRICS:
        np.testing.assert_allclose(gm[k], float(wm[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    errs = _leaf_errors(p0, want, got)
    for path, d, val, upd in errs["params"]:
        assert d <= 1e-5 * upd + 1e-12, (path, d, upd)
    for path, d, val, upd in errs["batch_stats"]:
        assert d <= 1e-9 * val, (path, d, val)
    for path, d, val, upd in errs["ema"]:
        assert d <= 1e-5 * upd + 4e-7 * val, (path, d, upd, val)


def compare_updates(p0, want, got, metrics_rtol, limits):
    """A step held by its updates: the losses to ``metrics_rtol`` and the
    same fg count; for each kind ("params", "batch_stats", "ema") the
    median and the 90th percentile over leaves of |port - JAX| over the size
    of JAX's update (both the max over the leaf) at most ``limits[kind]``.
    A step that updates nothing gives 1 on every leaf; a leaf that JAX left
    as it was stays so."""
    wm, gm = want[0], got[0]
    for k in METRICS:
        np.testing.assert_allclose(gm[k], float(wm[k]), rtol=metrics_rtol, atol=1e-7,
                                   err_msg=k)
    assert gm["num_fg_per_gt"] == float(wm["num_fg_per_gt"])
    for kind, errs in _leaf_errors(p0, want, got).items():
        assert all(d == 0 for path, d, _, upd in errs if upd == 0), kind
        rel = [d / upd for _, d, _, upd in errs if upd > 0]
        median, p90 = limits[kind]
        assert np.median(rel) <= median, (kind, np.median(rel))
        assert np.percentile(rel, 90) <= p90, (kind, np.percentile(rel, 90))


def compare_directions(p0, want, got, cos_min, ratio_max):
    """A state several f32 steps on, where rounding noise has moved the
    SimOTA assignment (tests/test_torch_train_step.py's docstring): for
    "params" and "batch_stats", the median over leaves of the cosine
    between the port's and JAX's change from ``p0`` at least
    ``cos_min[kind]``, and the median ratio of their norms within
    ``ratio_max`` of 1 either way."""
    wv, gv = flatten_tree(want[1]), got[1]
    for kind in ("params", "batch_stats"):
        cos, ratio = [], []
        for path, w in wv.items():
            dw = (w - p0[path]).ravel().astype(np.float64)
            dg = (gv[path] - p0[path]).ravel().astype(np.float64)
            if path[0] == kind and dw.any():
                cos.append(dw @ dg / (np.linalg.norm(dw) * np.linalg.norm(dg) + 1e-300))
                ratio.append(np.linalg.norm(dg) / np.linalg.norm(dw))
        assert np.median(cos) >= cos_min[kind], (kind, np.median(cos))
        assert 1 / ratio_max <= np.median(ratio) <= ratio_max, (kind, np.median(ratio))
