"""Port parity: the data-parallel train step (core/train_state.py::
make_train_step on a parallel.Mesh) against JAX's make_train_step on a
device mesh, and against the port's single-process step.

The model and inputs are those of tests/torch_train_utils.py (yolox-p6,
depth 0.33, width 0.125, the yoloxwarmcos SGD and the EMA, use_l1), at B=4:
one 64 px image on each of 4 gloo ranks (the 1-D data mesh), and 256x64
images on the (2 data x 2 space) mesh, which splits each image's height in
two (the smallest height the spatial size guard admits for 2 space ranks).
One run of 4 ranks takes the three steps.

Tolerances, as tests/test_torch_train_step.py argues them: in f64 one step
of the 1-D mesh agrees with JAX's step on ``make_mesh(jax.devices()[:4])``
within ``compare_tight`` (each parameter to 1e-5 of its update, each BN
statistic to 1e-9, the EMA to 1e-5 of its update, the losses to 1e-6, which
stay f32 in both) and the same fg count. The 2-D step computes what the
single-process step computes on the whole batch, in another order (halo
rows, per-rank partial sums, gradients summed over ranks), so it is held to
the same bounds against the port's single-process f64 step, which
tests/test_torch_train_step.py holds to JAX. JAX's own 2-D step is compared
by its losses in f32 at rtol 1e-4, as tests/test_training.py compares it to
its single-device step; its f64 gradients on a 2-D mesh take minutes to
compile (test_training.py::test_2d_mesh_grad_parity_f64, slow).
"""

import numpy as np
import pytest
import torch

import jax

from cocodet_tpu.parallel import make_mesh, make_mesh_2d
from cocodet_tpu_torch.parallel.launch import run_ranks
from cocodet_tpu_torch.utils.convert import flatten_tree
from torch_dist_utils import train_rank
from torch_train_utils import METRICS, SCHEDULE, as_reference, compare_tight, inputs, \
    jax_steps, port_steps

WORLD, HEIGHT_2D = 4, 256


@pytest.fixture(scope="module")
def steps():
    variables, images, labels = inputs(WORLD)
    _, images2, labels2 = inputs(WORLD, HEIGHT_2D)
    runs = [(1, images.astype(np.float64), labels, "float64"),
            (2, images2.astype(np.float64), labels2, "float64"),
            (2, images2, labels2, "float32")]
    ranks = run_ranks(train_rank, WORLD, variables, runs, SCHEDULE, device="cpu", timeout=900)
    with jax.enable_x64(True):
        jax_1d = jax_steps(variables, images, labels, np.float64,
                           mesh=make_mesh(jax.devices()[:WORLD]), steps=1)[0]
    jax_2d = jax_steps(variables, images2, labels2, np.float32,
                       mesh=make_mesh_2d(2, jax.devices()[:WORLD]), steps=1)[0]
    single = port_steps(variables, images2.astype(np.float64), labels2, torch.float64,
                        steps=1)[0]
    return {"p0": flatten_tree(variables), "ranks": ranks, "jax 1-D": jax_1d,
            "jax 2-D": jax_2d, "single 2-D": single,
            "num_gts": float((labels.sum(-1) > 0).sum())}


def test_dp_1d_step_matches_jax_f64(steps):
    """compare_tight, and the same fg count: JAX reports num_fg / num_gts."""
    got = steps["ranks"][0][0]
    compare_tight(steps["p0"], steps["jax 1-D"], got)
    want_fg = float(steps["jax 1-D"][0]["num_fg_per_gt"]) * steps["num_gts"]
    assert got[0]["num_fg"] == want_fg > 0


def test_dp_2d_step_matches_single_process_f64(steps):
    got, single = steps["ranks"][0][1], steps["single 2-D"]
    compare_tight(steps["p0"], as_reference(single), got)
    assert got[0]["num_fg"] == single[0]["num_fg"] > 0


def test_dp_2d_losses_match_jax_f32(steps):
    got, want = steps["ranks"][0][2][0], steps["jax 2-D"][0]
    for k in METRICS:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
    assert got["num_fg_per_gt"] == float(want["num_fg_per_gt"])


@pytest.mark.parametrize("run", ["1-D f64", "2-D f64", "2-D f32"])
def test_dp_ranks_hold_one_state(steps, run):
    """After the step every rank holds the same parameters, BN statistics
    and EMA, bit for bit, and reports the same global losses."""
    i = ["1-D f64", "2-D f64", "2-D f32"].index(run)
    metrics0, flat0, ema0 = steps["ranks"][0][i]
    for rank in steps["ranks"][1:]:
        metrics, flat, ema = rank[i]
        assert metrics == metrics0
        for path, v in flat.items():
            np.testing.assert_array_equal(v, flat0[path], err_msg=str(path))
        for name, t in ema.items():
            assert torch.equal(t, ema0[name]), name
