"""The compression trainers' steps on a mesh of ranks: core/pruner.py::
make_distill_train_step(mesh=) and make_score_step(mesh=), and
models/distill.py::distiller_loss(mesh=), against the JAX package's steps
on its virtual CPU mesh (cocodet_tpu/core/pruner.py:43-141,
models/distill.py:31-97; the Pruner's ``_setup_mesh``, :333-372).

4 gloo ranks on the CPU (tests/torch_dist_utils.py::distill_rank), one
run: the masked student of tests/test_torch_distill.py (yolox-p6, depth
0.33, width 0.125, some gates closed, the unmasked teacher, use_l1) at 64
px, B=4, one image a rank on the 1-D data mesh, in f64, and on 256x64
images on the (2 data x 2 space) mesh, which splits each image's rows in
two (the least height the size guard admits); then the distillation loss
of random taps (B=4, 2-8 rows) on the (2 x 2) mesh.

Tolerances. The step in f64 (``jax.enable_x64``) against JAX's step on
``make_mesh(jax.devices()[:4])``: ``torch_train_utils.compare_tight``'s,
the losses within 1e-6 relative (f32 in both: the maps are cast), each
parameter within 1e-5 of its update, each BN statistic within 1e-9 of its
largest. The importance: each site within
1e-5 of its largest value (the gradients of f32 losses, in both, summed
over the ranks before the square; measured up to 1.9e-6; a sum of per-rank
squares is another number, off by more than 10%, which the test also
shows). The 2-D loss against JAX's ``distiller_loss`` jitted
on ``make_mesh_2d(2, jax.devices()[:4])`` with the taps sharded (batch
over data, rows over space): the three losses within 1e-5 relative, each
rank's gradient within 1e-5 of its map's largest (f32 sums in other
orders; measured 4.7e-7). The 2-D step against the port's single-process
f64 step on the whole batch (JAX's f64 gradients on a 2-D mesh take
minutes to compile): the same bounds, the importance within 1e-5 of the
largest.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from cocodet_tpu.core import pruner as jpr
from cocodet_tpu.core.train_state import create_train_state as jax_create_state
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.models import distill as jd
from cocodet_tpu.parallel import make_mesh, make_mesh_2d, replicate, shard_batch
from cocodet_tpu_torch.core import pruner as tpr
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.parallel.launch import run_ranks
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables
from test_torch_channel_mask import close_some
from test_torch_distill import LR, _jax_tx
from torch_dist_utils import distill_rank, distill_step
from torch_train_utils import DEPTH, STRIDES, WIDTH, inputs

WORLD, HEIGHT_2D = 4, 256


def _taps(seed):
    """Distiller taps, NCHW f32: the p6 taps' order and depth at 4 images."""
    rs = np.random.RandomState(seed)
    shapes = [(4, 4, 8, 8), (4, 6, 4, 4), (4, 8, 4, 2), (4, 8, 2, 2)]

    def draw(ss):
        return tuple(rs.normal(0, 1, s).astype(np.float32) for s in ss)
    return {"backbone": draw(shapes), "td": draw(shapes[1:3][::-1]), "pan": draw(shapes)}


@pytest.fixture(scope="module")
def runs():
    variables, images, labels = inputs(WORLD)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=DEPTH, width=WIDTH, use_mask=True)
    masks = close_some(random_variables(shapes, 0), 11)["masks"]
    taps = (_taps(1), _taps(2))
    _, images2, labels2 = inputs(WORLD, HEIGHT_2D)
    # the ranks train in their processes while JAX compiles here
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(run_ranks, distill_rank, WORLD, variables, masks,
                        ((images, labels), (images2, labels2)), LR, taps, device="cpu",
                        timeout=900)
    pool.shutdown(wait=False)
    single_2d = distill_step("cpu", variables, masks, (images2, labels2), LR)
    mesh = make_mesh(jax.devices()[:WORLD])
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        jm = jax_build("yolox-p6", depth=DEPTH, width=WIDTH, use_mask=True)
        jt = jax_build("yolox-p6", depth=DEPTH, width=WIDTH)
        tx = _jax_tx()
        jmasks = jax.tree_util.tree_map(jnp.asarray, masks)
        batch = shard_batch(mesh, (jnp.asarray(images.astype(np.float64)), jnp.asarray(labels)))
        score = jpr.make_score_step(jm, STRIDES)
        importance = jax.device_get(score(
            replicate(mesh, {**f64(variables), "masks": jmasks}), *batch))
        state = replicate(mesh, jax_create_state(jm, tx, None, None, use_ema=False,
                                                 init_vars=f64(variables)))
        step = jpr.make_distill_train_step(jm, jt, tx, strides=STRIDES, use_ema=False)
        state, metrics = step(state, replicate(mesh, f64(variables)), replicate(mesh, jmasks),
                              *batch, use_l1=True)
        want = jax.device_get((metrics, {"params": state.params,
                                         "batch_stats": state.batch_stats}))
    mesh2 = make_mesh_2d(2, jax.devices()[:WORLD])

    def nhwc(t):
        return {k: tuple(a.transpose(0, 2, 3, 1) for a in v) for k, v in t.items()}
    s2, t2 = shard_batch(mesh2, nhwc(taps[0])), shard_batch(mesh2, nhwc(taps[1]))
    loss_fn = jax.jit(lambda s, t: jd.distiller_loss(s, t))
    loss_2d = jax.device_get(loss_fn(s2, t2))
    grads_2d = jax.device_get(jax.jit(jax.grad(lambda s, t: jd.distiller_loss(s, t)["dis_loss"]))(
        s2, t2))
    return {"ranks": ranks.result(), "variables": variables, "masks": masks, "want": want,
            "single 2-D": single_2d,
            "importance": importance, "loss_2d": loss_2d, "grads_2d": grads_2d,
            "images": images, "labels": labels}


def _assert_step(got, want, p0):
    """compare_tight's bounds on one step's variables: each parameter within
    1e-5 of its update, each BN statistic within 1e-9 of its largest."""
    assert {k for k in got if k[0] != "masks"} == set(want)
    for k, w in want.items():
        d = np.abs(got[k] - w).max()
        if k[0] == "params":
            assert d <= 1e-5 * float(np.abs(w - p0[k]).max()) + 1e-12, (k, d)
        else:
            assert d <= 1e-9 * float(np.abs(w).max()), (k, d)


def test_distill_step_on_ranks_matches_jax_mesh_f64(runs):
    jmetrics, jvars = runs["want"]
    p0 = flatten_tree(runs["variables"])
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jvars).items()}
    for rank in runs["ranks"]:
        for k in tpr.METRICS:
            np.testing.assert_allclose(rank["metrics"][k], float(jmetrics[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        assert rank["metrics"]["dis_loss"] > 0
        _assert_step(rank["params"], want, p0)


def test_distill_step_2d_mesh_matches_single_process_f64(runs):
    """The step and the importance on the (2 data x 2 space) mesh, 256x64
    images (each rank 128 rows of one image), against the port's
    single-process f64 step on the whole batch: what it computes in
    another order (halo rows, per-rank sums), held as the 1-D step to JAX
    (tests/test_torch_dp_step.py holds the 2-D train step so)."""
    importance, metrics, state = runs["single 2-D"]
    p0 = flatten_tree(runs["variables"])
    top = max(float(np.abs(v).max()) for v in importance.values())
    for rank in runs["ranks"]:
        got_imp, got_metrics, got_state = rank["2-D"]
        for k in tpr.METRICS:
            np.testing.assert_allclose(got_metrics[k], metrics[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        _assert_step(got_state, {k: v for k, v in state.items() if k[0] != "masks"}, p0)
        for k, v in importance.items():
            np.testing.assert_allclose(got_imp[k], v, rtol=0, atol=1e-5 * top, err_msg=k)


def test_ranks_hold_one_state(runs):
    """Every rank reports the same global losses and holds the same
    parameters and importance, bit for bit."""
    r0 = runs["ranks"][0]
    for rank in runs["ranks"][1:]:
        assert rank["metrics"] == r0["metrics"]
        for k, v in rank["params"].items():
            np.testing.assert_array_equal(v, r0["params"][k], err_msg=str(k))
        for k, v in rank["importance"].items():
            np.testing.assert_array_equal(v, r0["importance"][k], err_msg=k)


def test_importance_on_ranks_matches_jax_global_batch(runs):
    """The score step's importance on 4 ranks against JAX's make_score_step
    on the global batch; the sum of the ranks' own importances (each
    squaring its share of the gradient) is another number."""
    want = {"/".join(k): np.asarray(v) for k, v in runs["importance"].items()}
    got = runs["ranks"][0]["importance"]
    assert sorted(got) == sorted(want) and len(want) > 50
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    # per-rank importances: each rank alone scores its own image
    from cocodet_tpu_torch.models import build_model

    student = build_model("yolox-p6", depth=DEPTH, width=WIDTH, device="cpu", use_mask=True,
                          variables={**runs["variables"], "masks": runs["masks"]}).double()
    student.dtype = torch.float64
    score = tpr.make_score_step(student, STRIDES)
    images, labels = runs["images"], runs["labels"]
    per_rank = [score(torch.from_numpy(images[i:i + 1]).double(),
                      torch.from_numpy(labels[i:i + 1])) for i in range(WORLD)]
    summed = {"/".join(k): sum(p[k] for p in per_rank).numpy() for k in per_rank[0]}
    off = max(np.abs(summed[k] - w).max() / np.abs(w).max() for k, w in want.items()
              if np.abs(w).max() > 0)
    assert off > 0.1


def test_distill_loss_2d_mesh_matches_jax(runs):
    """The (2 data x 2 space) loss: the global values on every rank and each
    rank's gradient of its share, against JAX's loss and gradient on its
    2-D mesh (the gradient's rows and images of that rank)."""
    want, grads = runs["loss_2d"], runs["grads_2d"]
    for rank in runs["ranks"]:
        for k, v in rank["loss_2d"].items():
            np.testing.assert_allclose(v, float(want[k]), rtol=1e-5, err_msg=k)
        di, si = rank["coords_2d"]
        for k, maps in rank["grads_2d"].items():
            for i, g in enumerate(maps):
                w = np.asarray(grads[k][i]).transpose(0, 3, 1, 2)
                if k == "pan" and i == len(maps) - 1:
                    assert g is None and not w.any()  # the deepest output is not a tap
                    continue
                b, h = w.shape[0] // 2, w.shape[2] // 2
                np.testing.assert_allclose(g, w[di * b:(di + 1) * b, :, si * h:(si + 1) * h],
                                           rtol=0, atol=1e-5 * np.abs(w).max(),
                                           err_msg=f"{k}[{i}]")
