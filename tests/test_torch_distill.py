"""The distillation of the port (cocodet_tpu_torch/models/distill.py and
core/pruner.py::make_distill_train_step) against JAX's
(cocodet_tpu/models/distill.py, core/pruner.py:43-103), on the CPU.

- ``distill_loss_pair`` on random maps, and ``distiller_loss`` with its
  gradient with respect to the student's maps: f32, the losses to rtol
  1e-5 (the same sums in other orders), the gradients to rtol 1e-4 plus
  1e-5 of each map's largest (a softmax-weighted sum with cancellation;
  measured 2.3e-5 relative on the smallest); the teacher gets no gradient.
- One distill step of the masked student (yolox-p6, depth 0.33, width
  0.125, 64 px, B=2, some gates closed) with the unmasked teacher, use_l1,
  in f64 (``jax.enable_x64``; f32 step parity is lost to BN over 1x1 maps,
  tests/torch_train_utils.py): the limits of
  ``torch_train_utils.compare_tight``, the losses within 1e-6 (they are f32
  in both packages, as JAX casts the maps; the distillation losses too),
  each parameter within 1e-5 of its update, and the closed gates' BN
  scales and biases unmoved.
"""

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
from cocodet_tpu.models import distill as jd
from cocodet_tpu_torch.core import pruner as tpr
from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.models import distill as td
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree, random_variables
from test_torch_channel_mask import close_some
from torch_port_utils import assert_close, nchw, nhwc
from torch_train_utils import DEPTH, STRIDES, WIDTH, inputs

LR = 0.01


def _maps(seed, shape=(2, 5, 6, 7)):
    rs = np.random.RandomState(seed)
    return rs.normal(0, 1, shape).astype(np.float32), rs.normal(0, 1.5, shape).astype(np.float32)


def test_distill_loss_pair_matches_jax():
    s, t = _maps(0)
    want = jd.distill_loss_pair(jnp.asarray(s), jnp.asarray(t))
    got = td.distill_loss_pair(nchw(s), nchw(t))
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


def test_distiller_loss_and_gradient_match_jax():
    rs = np.random.RandomState(1)
    shapes = [(2, 8, 8, 4), (2, 4, 4, 6), (2, 2, 2, 8), (2, 1, 1, 8)]
    def taps():
        draw = lambda ss: tuple(rs.normal(0, 1, s).astype(np.float32) for s in ss)  # noqa: E731
        return {"backbone": draw(shapes), "td": draw(shapes[1:3][::-1]), "pan": draw(shapes)}

    s_taps, t_taps = taps(), taps()

    def jax_loss(st):
        return jd.distiller_loss(st, jax.tree_util.tree_map(jnp.asarray, t_taps))

    want = jax_loss(jax.tree_util.tree_map(jnp.asarray, s_taps))
    jgrad = jax.grad(lambda st: jax_loss(st)["dis_loss"])(
        jax.tree_util.tree_map(jnp.asarray, s_taps))
    s_t = {k: tuple(nchw(a).requires_grad_() for a in v) for k, v in s_taps.items()}
    t_t = {k: tuple(nchw(a).requires_grad_() for a in v) for k, v in t_taps.items()}
    got = td.distiller_loss(s_t, t_t)
    for k in want:
        assert_close(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=0)
    got["dis_loss"].backward()
    for k in s_t:
        for a, w in zip(s_t[k], jgrad[k]):
            if k == "pan" and a is s_t["pan"][-1]:
                assert a.grad is None  # the deepest output is not a tap
                continue
            w = np.asarray(w)
            assert_close(nhwc(a.grad), w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()))
    assert all(a.grad is None for v in t_t.values() for a in v)


def _jax_tx():
    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    return optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                       optax.sgd(LR, momentum=0.9, nesterov=True))


@pytest.fixture(scope="module")
def one_step():
    variables, images, labels = inputs()
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=DEPTH, width=WIDTH, use_mask=True)
    masks = close_some(random_variables(shapes, 0), 11)["masks"]
    student = {**variables, "masks": masks}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        jm = jax_build("yolox-p6", depth=DEPTH, width=WIDTH, use_mask=True)
        jt = jax_build("yolox-p6", depth=DEPTH, width=WIDTH)
        tx = _jax_tx()
        state = jax_create_state(jm, tx, None, None, use_ema=False, init_vars=f64(variables))
        step = jpr.make_distill_train_step(jm, jt, tx, strides=STRIDES, use_ema=False)
        state, metrics = step(state, f64(variables), jax.tree_util.tree_map(jnp.asarray, masks),
                              jnp.asarray(images.astype(np.float64)), jnp.asarray(labels),
                              use_l1=True)
        want = jax.device_get((metrics, state.params))

    model = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu", use_mask=True,
                        variables=student).to(torch.float64)
    teacher = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu",
                          variables=variables).to(torch.float64)
    model.dtype = teacher.dtype = torch.float64
    tstate = ts.create_train_state(model, ts.build_optimizer(model, LR), use_ema=False)
    pstep = tpr.make_distill_train_step(tstate, teacher, STRIDES)
    got = pstep(torch.from_numpy(images).double(), torch.from_numpy(labels), use_l1=True)
    return variables, want, ({k: float(v) for k, v in got.items()},
                             export_variables(model)["params"]), masks


def test_one_distill_step_matches_jax_f64(one_step):
    variables, (jmetrics, jparams), (metrics, params), masks = one_step
    for k in tpr.METRICS:
        np.testing.assert_allclose(metrics[k], float(jmetrics[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert metrics["dis_loss"] > 0
    p0 = flatten_tree(variables["params"])
    want = traverse_util.flatten_dict(jparams)
    for k, v in flatten_tree(params).items():
        upd_w = np.asarray(want[k]) - p0[k]
        d = np.abs((v - p0[k]) - upd_w).max()
        assert d <= 1e-5 * float(np.abs(upd_w).max()) + 1e-12, (k, d)


def test_closed_gates_get_no_gradient(one_step):
    """A closed channel's BN scale and bias move by nothing (no gradient, no
    weight decay on them)."""
    variables, _, (_, params), masks = one_step
    p0, p1 = flatten_tree(variables["params"]), flatten_tree(params)
    for path, s in flatten_tree(masks).items():
        if path[-1] != "scale":
            continue
        closed = s == 0
        bn = path[:-2] + ("bn",)
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(p1[bn + (leaf,)][closed], p0[bn + (leaf,)][closed])
