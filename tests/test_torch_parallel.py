"""Port parity: cocodet_tpu_torch/parallel (the mesh, batch sharding, the
differentiable collectives, the launcher), the height-sharded layers of
models/blocks.py, ops/fuse.py::bn_stats_allreduce and
entry.dryrun_multichip, against cocodet_tpu/parallel and the unsharded
layers.

The ranks are gloo processes on the CPU, spawned by
``parallel.launch.run_ranks`` through a ``file://`` rendezvous (no fixed
port), each with a join timeout; their bodies are in
tests/torch_dist_utils.py and one run of 4 ranks serves the module.

Tolerances. The collectives are held by ``torch.autograd.gradcheck`` in
f64 (its own default tolerances). A sharded layer computes the same sums as
the whole layer in another order (a conv's halo rows, BN's per-rank partial
sums, the parameter gradients summed over ranks), so in f64 it agrees to
1e-12 of the output's scale, and the parameter gradients, sums of a few
hundred products over up to four ranks, to 1e-11 (measured: at most 5e-13).
"""

import numpy as np
import pytest
import torch

import jax

from cocodet_tpu.parallel import batch_sharding_fn as jax_batch_sharding_fn
from cocodet_tpu.parallel import make_mesh as jax_make_mesh
from cocodet_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from cocodet_tpu_torch.parallel import launch
from cocodet_tpu_torch.parallel.mesh import backend_for, check_spatial_sizes
from torch_dist_utils import HALOS, LAYERS, failing_rank, halo_case, parallel_rank

WORLD = 4
MESHES = ("(4 data x 1 space)", "(2 data x 2 space)", "(1 data x 4 space)")


def _leaves():
    rs = np.random.RandomState(6)
    return [rs.normal(size=(8, 64, 32, 3)).astype(np.float32),  # images
            rs.normal(size=(8, 10, 5)).astype(np.float32),      # labels
            rs.normal(size=(8, 5, 4, 4)).astype(np.float32),    # per-tile boxes
            rs.normal(size=(8, 64, 32, 1)).astype(np.float32),  # a mask
            rs.normal(size=(8, 3, 32, 3)).astype(np.float32),   # odd height
            np.arange(8, dtype=np.int64)]                       # a vector


@pytest.fixture(scope="module")
def runs():
    return launch.run_ranks(parallel_rank, WORLD, _leaves(), device="cpu", timeout=600)


@pytest.mark.parametrize("case", ["all_reduce_sum", "gather_rows"]
                         + [halo_case(r, *h) for r in (1, 2) for h in HALOS])
def test_collective_gradcheck(runs, case):
    assert all(r["gradcheck"][case] for r in runs)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("layer", LAYERS)
def test_sharded_layer_equals_whole_layer(runs, layer, mesh):
    """Forward, the input's gradient, the parameters' gradients (summed over
    the ranks) and BN's running statistics of the layer on each rank's
    share against the layer on the whole batch."""
    for r in runs:
        y, gx, gp, stats, scale = r["layers"][f"{layer} on {mesh}"]
        assert y <= 1e-12 * max(1.0, scale) and gx <= 1e-12 * max(1.0, scale), (y, gx)
        assert gp <= 1e-11 and stats <= 1e-12, (gp, stats)


def test_batch_sharding_matches_jax(runs):
    """batch_sharding_fn picks the spec JAX picks for every leaf, and
    shard_batch hands each rank that slice (rank = data * n_space + space)."""
    leaves = _leaves()
    for name, mesh in (("1-D", jax_make_mesh(jax.devices()[:WORLD])),
                       ("2-D", jax_make_mesh_2d(2, jax.devices()[:WORLD]))):
        want = [tuple(jax_batch_sharding_fn(mesh)(x).spec) for x in leaves]
        want = [w + (None,) * (x.ndim - len(w)) for w, x in zip(want, leaves)]
        for rank, r in enumerate(runs):
            got = [s + (None,) * (x.ndim - len(s)) for s, x in zip(r["mesh"]["specs"][name],
                                                                   leaves)]
            assert got == want, (name, got, want)
            d, s, n_data, n_space = r["mesh"][f"coords {name}"]
            assert (d, s) == divmod(rank, n_space) and n_data * n_space == WORLD
            for x, spec, shard in zip(leaves, want, r["mesh"]["shards"][name]):
                b = x.shape[0] // n_data
                part = x[d * b:(d + 1) * b]
                if spec[1:2] == ("space",):
                    h = x.shape[1] // n_space
                    part = part[:, s * h:(s + 1) * h]
                np.testing.assert_array_equal(shard, part)
    assert runs[0]["mesh"]["specs"]["2-D"][:5] == [
        ("data", "space", None, None), ("data", None, None), ("data", None, None, None),
        ("data", "space", None, None), ("data", None, None, None)]


def test_replicate_broadcasts_rank0(runs):
    want = runs[0]["mesh"]["replicated"]
    for r in runs[1:]:
        for k, v in r["mesh"]["replicated"].items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_bn_stats_allreduce_is_the_mean(runs):
    for r in runs:
        mean, var = r["mesh"]["bn mean"]
        np.testing.assert_array_equal(mean, np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(var, np.full(3, 4.0, np.float32))


def test_process_allgather_detections(runs):
    want = [{"rank": q, "i": i} for q in range(WORLD) for i in range(q + 1)]
    for r in runs:
        assert r["mesh"]["detections"] == want
        assert [float(t[0]) for t in r["mesh"]["gathered"]] == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("size,multiscale_range,ok", [
    ((256, 256), 0, True), ((128, 128), 0, False), ((640, 640), 1, False),
    ((640, 640), 0, True)])
def test_spatial_size_guard_matches_jax(size, multiscale_range, ok):
    """check_spatial_sizes refuses what Trainer._check_spatial_sizes refuses
    (tests/test_training.py::test_spatial_size_guard), on the same sizes."""
    from types import SimpleNamespace

    from cocodet_tpu.core.trainer import Trainer
    from cocodet_tpu.exp import get_exp

    exp = get_exp(exp_name="yolox-m-p6")
    exp.input_size, exp.multiscale_range, exp.multiscale_step = size, multiscale_range, 64
    sizes = list(exp.multiscale_sizes())
    if tuple(exp.input_size) not in sizes:
        sizes.append(tuple(exp.input_size))
    for check in (lambda: Trainer._check_spatial_sizes(SimpleNamespace(exp=exp), 2),
                  lambda: check_spatial_sizes(sizes, 2, max(exp.strides))):
        if ok:
            check()
        else:
            with pytest.raises(ValueError, match="unsafe sharding regime"):
                check()


def test_failed_rank_fails_the_run():
    """A rank that raises fails the run (the error reported may be rank 1's
    own or the other rank's broken collective, whichever exits first)."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        launch.run_ranks(failing_rank, 2, "raise", device="cpu", timeout=120)


def test_hung_rank_times_out():
    with pytest.raises(TimeoutError):
        launch.run_ranks(failing_rank, 2, "hang", device="cpu", timeout=6)


def test_cuda_ranks_need_a_card():
    """device="cuda" never moves to the CPU: without a card it raises."""
    assert backend_for(torch.device("cpu"), 4) == "gloo"
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.rank_device("cuda", 0)


def test_dryrun_multichip_on_cpu(capsys):
    """entry.dryrun_multichip(2) on gloo ranks: the 1-D step and the (1 data
    x 2 space) step, finite losses equal on both ranks, printed as JAX's
    dryrun prints them."""
    from cocodet_tpu_torch.entry import dryrun_multichip

    results = dryrun_multichip(2, device="cpu", timeout=300)
    assert len(results) == 2 and results[0] == results[1]
    assert all(np.isfinite(v) for v in results[0].values())
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): ok, loss=" in out
    assert "dryrun_multichip(2): 2-D (1 data x 2 space) mesh ok, loss=" in out
