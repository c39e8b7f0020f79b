"""The port's trainer over two hosts (``tools/train.py --coordinator
--num-hosts --host-id``; JAX's multi-host CLI, tools/train.py:35-50): two
processes on this machine, each a host that spawns its one rank
(``parallel/launch.py::run_ranks``), the two joined through a
``tcp://127.0.0.1`` rendezvous on a free port, against the single-rank
trainer on the same command (tests/test_torch_trainer_ranks.py's exp and
f64 model, whose docstring says why f64), and against JAX's Trainer, which
spreads the batch of 2 over a 2-device mesh of the 8 virtual CPU devices of
tests/conftest.py (trainer.py:206-219). JAX's Trainer runs under
``jax.enable_x64`` with its model in f64 from the port's initial weights,
and is fed the port's global batches (its loader's are JAX's own
preprocessing, which the device-mosaic tests hold to bounds, not bits);
its first two iterations run its real step, the later ones and its
evaluation are stubbed (one compiled step).

Held: the hosts' slices, concatenated, equal the single rank's batches bit
for bit (each host takes its data row of the one global stream); the
losses within 1e-4 relative; both hosts hold one state (digest); only host
0's rank writes checkpoints; the lr of each iteration within 1e-6 relative
of JAX's (JAX evaluates its schedule in f32), the sizes and ``use_l1``
exactly; the hosts' losses of the first two iterations within 1e-6
relative of JAX's mesh trainer's (1.3e-7 measured: the losses are f32 in
both, as in tests/test_torch_train_step.py)."""

import os
import queue
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import cocodet_tpu.core.trainer as jtr
import torch_trainer_ranks as tr
from cocodet_tpu.exp import get_exp_by_file as jax_exp
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import train
from cocodet_tpu_torch.utils.convert import random_variables

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hosts"))
    root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=4, n_val=2,
                               size_range=(64, 128), seed=0)
    out_dir = os.path.join(tmp, "hosts")
    os.makedirs(out_dir)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO,
                                                       os.environ.get("PYTHONPATH", "")]))
    logs = [os.path.join(tmp, f"host{h}.log") for h in (0, 1)]
    procs = []
    for h, log in enumerate(logs):
        with open(log, "w") as f:  # a file, not a pipe: nothing reads it until they end
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_trainer_ranks.py"),
                 *tr.argv(root, out_dir, "-d", "1", "--coordinator", f"127.0.0.1:{port}",
                          "--num-hosts", "2", "--host-id", str(h))],
                env=env, stdout=subprocess.DEVNULL, stderr=f))
    # JAX's trainer is built on a thread while the single rank trains, and
    # trains once the single rank's batches come
    fed, jax_out = queue.Queue(), {}

    def jax_side():
        try:
            with jax.enable_x64(True):
                jax_out["log"] = jax_run(root, os.path.join(tmp, "jax"), fed)
        except BaseException as e:  # raised again below
            jax_out["error"] = e
    thread = threading.Thread(target=jax_side)
    mp = pytest.MonkeyPatch()
    steps = []
    try:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # its import takes seconds
        thread.start()
        single = train.main(tr.argv(root, os.path.join(tmp, "single")), rank_hook=tr.f64_hook)
        out = {"single": tr.f64_hook(single, "end")}
        steps = out["single"]["steps"]
        single.after_train()
    finally:
        fed.put(steps)
        thread.join()
        mp.undo()
        for p, log in zip(procs, logs):
            try:
                p.wait(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            with open(log) as f:
                assert p.returncode == 0, f.read()[-4000:]
    if "error" in jax_out:
        raise jax_out["error"]
    out["jax"] = jax_out["log"]
    out["hosts"] = [torch.load(os.path.join(out_dir, f"host{h}.pt"), weights_only=False)
                    for h in (0, 1)]
    return out


REAL_STEPS = 2  # JAX's iterations that run its real step


def jax_run(root, out, fed):
    """JAX's Trainer on the exp in f64, over its own mesh, fed the batches
    that come through the queue ``fed`` (the port's global (images,
    labels) of each iteration), its real step for the first
    ``REAL_STEPS``: each iteration's (epoch, it, size, use_l1, lr) and,
    for those, its losses."""
    exp = jax_exp(os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"))
    exp.merge(tr.OPTS + ["data_dir", root, "output_dir", out])

    class Args:
        batch_size = 2
        resume = False
        ckpt = None
        cache = False
        no_aug = False
        start_epoch = None

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    tree = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, np.float64),
                                  random_variables(shapes, 0, prior_prob=0.01))
    mp = pytest.MonkeyPatch()
    log = []
    try:
        # the model in the dtype of its f64 variables, as the port's f64 hook makes it
        mp.setattr(exp, "get_model", lambda **kw: jax_build_model(
            exp.model_name, num_classes=exp.num_classes, depth=exp.depth, width=exp.width,
            **kw))
        orig = jtr.create_train_state
        mp.setattr(jtr, "create_train_state",
                   lambda model, tx, rng, sample, use_ema=True, init_vars=None:
                   orig(model, tx, rng, sample, use_ema=use_ema, init_vars=tree))
        t = jtr.Trainer(exp, Args())
        t.before_train()
        assert t.mesh is not None and t.mesh.devices.size == 2
        zeros = {k: np.float32(0) for k in tr.LOSSES}
        step, batches = t.train_step, []

        def train_step(state, *a, **k):
            if len(log) < REAL_STEPS:
                return step(state, *a, **k)
            return state, zeros

        def next_batch():
            if not batches:
                batches.extend(fed.get(timeout=600)[::-1])
            imgs, labels = batches.pop()
            return (jax.device_put(imgs.astype(np.float64), t.data_sharding),
                    jax.device_put(labels, t.data_sharding), None, None)
        t.train_step, t._next_batch = train_step, next_batch
        t.evaluate_and_save_model = lambda: None
        t.save_ckpt = lambda *a, **k: None
        t._log_progress = lambda it, size: log.append(
            {"epoch": t.epoch, "it": it, "size": tuple(size), "use_l1": t.use_l1,
             "lr": t.meter["lr"].latest, **{k: t.meter[k].latest for k in tr.LOSSES}})
        for t.epoch in range(t.start_epoch, t.max_epoch):
            t.before_epoch()
            t.train_in_iter()
            t.after_epoch()
    finally:
        mp.undo()
    return log


def test_hosts_take_their_rows_of_one_stream(runs):
    want = runs["single"]["steps"]
    hosts = [h[0]["hook"]["steps"] for h in runs["hosts"]]
    assert [h[0]["rank"] for h in runs["hosts"]] == [0, 1]
    assert len(want) == 4
    for k, (imgs, labels) in enumerate(want):
        assert tr.same_arrays(np.concatenate([h[k][0] for h in hosts]), imgs), k
        assert tr.same_arrays(np.concatenate([h[k][1] for h in hosts]), labels), k


def test_hosts_losses_state_and_checkpoints(runs):
    (h0,), (h1,) = runs["hosts"]
    assert h0["digest"] == h1["digest"]
    for a, b in zip(h0["hook"]["log"], runs["single"]["log"]):
        for k in tr.LOSSES:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=0, err_msg=k)
    assert len(h0["ckpt_stats"]) == 4 and h1["ckpt_stats"] == []
    assert h0["hook"]["files"] == runs["single"]["files"]


def test_bookkeeping_matches_jax_on_a_mesh(runs):
    got, want = runs["hosts"][0][0]["hook"]["log"], runs["jax"]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert (a["epoch"], a["it"], a["size"], a["use_l1"]) == (b["epoch"], b["it"], b["size"],
                                                               b["use_l1"])
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6, atol=0)
    assert [r["use_l1"] for r in got] == [False, False, True, True]


def test_hosts_losses_match_jax_on_a_mesh(runs):
    got, want = runs["hosts"][0][0]["hook"]["log"], runs["jax"]
    for a, b in zip(got[:REAL_STEPS], want):
        for k in tr.LOSSES:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=0, err_msg=k)
        assert np.isfinite(a["loss"]) and a["loss"] != 0
