"""QAT of the port (cocodet_tpu_torch/compress/qat.py, the quant="qat" conv
of models/blocks.py, tools/qat_tune.py) against JAX's (cocodet_tpu/compress/
qat.py, models/blocks.py:284-319, tools/qat_tune.py), on the CPU, on the
fused yolox-p6 at depth 0.33, width 0.25, 64 px, B=2, f32, with JAX's act
scales calibrated on the same images, per tensor and per channel.

- The QAT forward against JAX's jitted model: every head map within 1e-6 of
  the output's largest magnitude (measured 4.8e-6 / 11.2 = 4.3e-7: the f32
  convs sum in another order, and a fake-quant code may flip where an
  activation lies on a rounding boundary).
- One step of ``make_qat_step`` (SGD lr 1e-3, nesterov momentum 0.9, no
  weight decay, EMA decay 0.9 with the counter preset at 50,000) against
  JAX's: the losses within 1e-6 relative; every parameter within 2% of its
  leaf's largest update plus 1e-6 relative (measured at most 1.2% of the
  update: a parameter whose update is a few ulps of its value); the EMA
  shadow within 1e-6.
- ``requantize`` against JAX's on the same tuned parameters: int8 codes and
  scales equal.
- A copy of tests/test_qat.py::test_qat_forward_matches_w8a8 on the port:
  the QAT forward against the port's w8a8 forward of ``requantize``'s
  tree, within 5e-3 of the output's largest magnitude.
- The QAT CLI end to end on the port's synthetic JPEGs (depth 0.33, width
  0.125, 64 px, B=2, 2 steps): JAX's ``load_checkpoint`` reads the msgpack
  it writes, leaf for leaf, and its params are the leaves and shapes
  JAX's w8a8 model takes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import build_quant_tree as jax_build_quant_tree
from cocodet_tpu.compress import calibrate as jax_calibrate
from cocodet_tpu.compress import make_qat_step as jax_make_qat_step
from cocodet_tpu.compress import requantize as jax_requantize
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from cocodet_tpu.utils.ema import EMAState, ema_init
from cocodet_tpu_torch.compress import (act_scale_tree, make_qat_step, qat_ema, qat_optimizer,
                                        requantize)
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.tools import qat_tune
from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
from cocodet_tpu_torch.utils.convert import (ema_variables, export_variables, flatten_tree,
                                             random_variables, unflatten_tree)

D, W, S = 0.33, 0.25, 64
STRIDES = (8, 16, 32, 64)
LR = 1e-3


def _variables(depth=D, width=W):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width, fused=True)
    return random_variables(shapes, 0, prior_prob=0.01)


def _flat(outs):
    return np.concatenate([np.asarray(o[k], np.float32).ravel() for o in outs
                           for k in ("reg", "obj", "cls")])


@pytest.fixture(scope="module", params=[False, True], ids=["per_tensor", "per_channel"])
def setup(request):
    variables = _variables()
    imgs = np.random.RandomState(0).uniform(0, 255, (2, S, S, 3)).astype(np.float32)
    labels = np.zeros((2, 5, 5), np.float32)
    labels[:, 0] = [1, 32, 32, 16, 16]
    labels[1, 1] = [7, 20, 40, 24, 12]
    calib = jax_build("yolox-p6", depth=D, width=W, fused=True, quant="calib")
    quant = jax.tree_util.tree_map(np.asarray, jax_build_quant_tree(
        jax_calibrate(calib, variables, [jnp.asarray(imgs)]), per_channel_act=request.param))
    return variables, quant, imgs, labels


def _port_model(variables, quant, device="cpu"):
    return build_model("yolox-p6", depth=D, width=W, fused=True, quant="qat", device=device,
                       variables={"params": variables["params"], "quant": quant})


def test_qat_forward_matches_jax(setup):
    variables, quant, imgs, _ = setup
    jm = jax_build("yolox-p6", depth=D, width=W, fused=True, quant="qat")
    want = _flat(jax.jit(jm.apply)({"params": variables["params"], "quant": quant}, imgs))
    with torch.no_grad():
        got = _flat(_port_model(variables, quant)(torch.from_numpy(imgs)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture(scope="module")
def stepped(setup):
    variables, quant, imgs, labels = setup
    jm = jax_build("yolox-p6", depth=D, width=W, fused=True, quant="qat")
    tx = optax.sgd(LR, momentum=0.9, nesterov=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = ema_init(params)
    ema = EMAState(shadow=ema.shadow, updates=jnp.asarray(50_000, jnp.int32))
    step = jax_make_qat_step(jm, tx, strides=STRIDES, ema_decay=0.9, donate=False)
    p1, _, e1, m1 = step(params, tx.init(params), ema, quant, jnp.asarray(imgs),
                         jnp.asarray(labels))
    model = _port_model(variables, quant)
    ema_t = qat_ema(model, 0.9)
    metrics = make_qat_step(model, qat_optimizer(model, LR), STRIDES, ema=ema_t)(
        torch.from_numpy(imgs), torch.from_numpy(labels))
    want = {"metrics": jax.device_get(m1), "params": flatten_dict(jax.device_get(p1)),
            "ema": flatten_dict(jax.device_get(e1.shadow))}
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": flatten_tree(export_variables(model)["params"]),
           "ema": flatten_tree(ema_variables(ema_t)["params"]), "model": model}
    return got, want


def test_qat_step_matches_jax(setup, stepped):
    variables = setup[0]
    got, want = stepped
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-6, err_msg=k)
    p0 = flatten_tree(variables["params"])
    assert got["params"].keys() == want["params"].keys()
    moved = 0
    for k, w in want["params"].items():
        w = np.asarray(w)
        upd = np.abs(w - p0[k]).max()
        moved += upd > 0
        np.testing.assert_allclose(got["params"][k], w, rtol=1e-6, atol=0.02 * upd,
                                   err_msg=str(k))
    assert moved > len(p0) // 2  # leaves with a zero gradient stay
    for k, w in want["ema"].items():
        np.testing.assert_allclose(got["ema"][k], np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=str(k))


def test_act_scales_frozen_by_the_step(setup, stepped):
    quant = setup[1]
    got = flatten_tree(export_variables(stepped[0]["model"])["quant"])
    for k, v in flatten_tree(quant).items():
        np.testing.assert_array_equal(got[k], v)


def test_requantize_matches_jax(setup, stepped):
    quant = setup[1]
    got, _ = stepped
    tree = unflatten_tree(got["params"])
    p_got, q_got = requantize(tree, quant)
    p_want, q_want = jax_requantize(tree, quant)
    for got_t, want_t in ((p_got, p_want), (q_got, q_want)):
        g, w = flatten_tree(got_t), flatten_dict(jax.device_get(want_t))
        assert g.keys() == w.keys()
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    n_int8 = sum(np.asarray(v).dtype == np.int8 for v in flatten_tree(p_got).values())
    assert n_int8 > 50
    assert flatten_tree(act_scale_tree(q_got)).keys() == flatten_tree(quant).keys()


def test_split_concat_input_raises():
    """A split-concat parts input raises in qat mode, as in JAX
    (blocks.py:285-287)."""
    from cocodet_tpu_torch.models.blocks import Conv2d

    conv = Conv2d(8, 4, 1, quant="qat")
    with pytest.raises(ValueError, match="split-concat"):
        conv([torch.zeros(1, 4, 2, 2), torch.zeros(1, 4, 2, 2)])


def test_qat_forward_matches_w8a8(setup):
    """tests/test_qat.py:63-96 on the port: requantize the untouched float
    params; the QAT forward and the w8a8 forward agree within 5e-3 of the
    output's largest magnitude."""
    variables, quant, imgs, _ = setup
    with torch.no_grad():
        sim = _flat(_port_model(variables, quant)(torch.from_numpy(imgs)))
        p8, q8 = requantize(variables["params"], quant)
        w8a8 = build_model("yolox-p6", depth=D, width=W, fused=True, quant="w8a8", device="cpu",
                           variables={"params": p8, "quant": q8})
        dep = _flat(w8a8(torch.from_numpy(imgs)))
    assert np.abs(sim - dep).max() / np.abs(dep).max() < 5e-3


def test_qat_cli_writes_what_jax_reads(tmp_path):
    root = make_synthetic_coco(str(tmp_path / "coco"), n_train=4, n_val=2, size_range=(64, 96))
    variables = _variables(0.33, 0.125)
    ckpt = save_checkpoint({"model": variables}, False, str(tmp_path), "fused")
    out = str(tmp_path / "qat.msgpack")
    res = qat_tune.main(["-c", ckpt, "-o", out, "--depth", "0.33", "--width", "0.125",
                         "--data-dir", root, "--img-size", "64", "-b", "2", "--steps", "2",
                         "--calib-batches", "1", "--print-interval", "1", "--device", "cpu"])
    assert len(res["history"]) == 2 and all(np.isfinite(h["loss"]) for h in res["history"])
    tree = jax_load_checkpoint(out)
    assert set(tree) == {"params", "quant"}
    got = flatten_dict(tree)
    for k, v in flatten_tree(res["tree"]).items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
    assert sum(np.asarray(v).dtype == np.int8 for v in got.values()) > 50
    # every param leaf JAX's w8a8 model takes, in its shape (flax inits the
    # kernels as f32; the file holds them int8)
    jm = jax_build("yolox-p6", depth=0.33, width=0.125, fused=True, quant="w8a8")
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = {k: v.shape for k, v in flatten_dict(dict(want)).items() if k[0] == "params"}
    assert {("params",) + k: np.shape(v)
            for k, v in flatten_dict(tree["params"]).items()} == want
