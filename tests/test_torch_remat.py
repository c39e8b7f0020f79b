"""remat: the train step with the forward recomputed in the backward
(``core/train_state.py::make_forward``, ``torch.utils.checkpoint``), as
JAX's ``jax.checkpoint(apply_fn)`` over the whole forward
(cocodet_tpu/core/train_state.py:92-93), on tests/torch_train_utils.py's
model, batch and schedule.

The recomputation runs train-mode BN again, which folds the batch
statistics into the running ones in place; it must leave them as the first
forward left them (JAX's mutable ``batch_stats`` come from the first
forward only). Held, in f64: the port's remat step against its plain step,
the BN running statistics bit for bit and the parameters, losses and EMA
within 1e-12 (the recomputed maps are the same ops on the same inputs);
and against JAX's remat step at tests/test_torch_train_step.py's one-step
tolerance (``compare_tight``: each parameter to 1e-5 of its update)."""

import numpy as np
import pytest
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
from cocodet_tpu_torch.models import build_model
from cocodet_tpu_torch.utils import lr_scheduler as tlr
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree
from torch_train_utils import DEPTH, SCHEDULE, STRIDES, WIDTH, compare_tight, inputs


def port_step(variables, images, labels, remat):
    model = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu",
                        variables=variables).to(torch.float64)
    model.dtype = torch.float64
    state = ts.create_train_state(
        model, ts.build_optimizer(model, tlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE)))
    step = ts.make_train_step(state, STRIDES, remat=remat)
    metrics = step(torch.from_numpy(images).double(), torch.from_numpy(labels), use_l1=True)
    return ({k: float(v) for k, v in metrics.items()}, flatten_tree(export_variables(model)),
            {name: t.clone() for name, t in state.ema.shadow.items()})


@pytest.fixture(scope="module")
def steps():
    variables, images, labels = inputs()
    return {"variables": variables,
            "plain": port_step(variables, images, labels, remat=False),
            "remat": port_step(variables, images, labels, remat=True),
            "jax": jax_remat_step(variables, images, labels)}


def jax_remat_step(variables, images, labels):
    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    with jax.enable_x64(True):
        model = jax_build_model("yolox-p6", depth=DEPTH, width=WIDTH)
        tx = optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                         optax.sgd(jlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE),
                                   momentum=0.9, nesterov=True))
        init = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.float64)), variables)
        state = jax_create_state(model, tx, None, None, init_vars=init)
        step = jax_make_step(model, tx, strides=STRIDES, num_classes=80, donate=False,
                             remat=True)
        state, metrics = step(state, jnp.asarray(images.astype(np.float64)),
                              jnp.asarray(labels), use_l1=True)
        return jax.device_get((metrics, {"params": state.params,
                                         "batch_stats": state.batch_stats}, state.ema.shadow))


def test_remat_leaves_bn_statistics_as_the_plain_step(steps):
    (pm, pv, pe), (rm, rv, re) = steps["plain"], steps["remat"]
    stats = [k for k in pv if k[0] == "batch_stats"]
    assert stats and sorted(pv) == sorted(rv)
    for k in stats:
        assert rv[k].dtype == pv[k].dtype and rv[k].tobytes() == pv[k].tobytes(), k
        # and they moved: one fold of the batch statistics, not zero, not two
        assert not np.array_equal(rv[k], flatten_tree(steps["variables"])[k]), k
    for k in pv:
        np.testing.assert_allclose(rv[k], pv[k], rtol=0, atol=1e-12, err_msg=str(k))
    for k in pm:
        np.testing.assert_allclose(rm[k], pm[k], rtol=1e-12, atol=0, err_msg=k)
    for k in pe:
        np.testing.assert_allclose(re[k].numpy(), pe[k].numpy(), rtol=0, atol=1e-12, err_msg=k)


def test_remat_step_matches_jax_remat_step(steps):
    compare_tight(flatten_tree(steps["variables"]), steps["jax"], steps["remat"])


def test_split_cat_with_remat_raises():
    model = torch.nn.Module()
    model.split_cat = True
    with pytest.raises(ValueError, match="split_cat cannot be combined with remat"):
        ts.make_forward(model, remat=True)
    assert ts.make_forward(model, remat=False) is not None


def test_the_recomputation_runs_and_would_fold_the_statistics_twice(steps, monkeypatch):
    """Without ``keep_bn_statistics`` the remat step's running statistics
    differ from the plain step's (the backward recomputed the forward and
    folded the batch statistics again): the guard is what keeps them."""
    import contextlib

    monkeypatch.setattr(ts, "keep_bn_statistics", lambda model: contextlib.nullcontext())
    variables, images, labels = inputs()
    _, twice, _ = port_step(variables, images, labels, remat=True)
    _, plain, _ = steps["plain"]
    stats = [k for k in plain if k[0] == "batch_stats"]
    assert sum(not np.array_equal(twice[k], plain[k]) for k in stats) == len(stats)
