"""The port's Trainer (cocodet_tpu_torch/core/trainer.py) against JAX's
(cocodet_tpu/core/trainer.py) on a tiny exp: the phase-1 exp file at depth
0.33, width 0.125, 128 px (multiscale buckets 128 and 192), 8 synthetic JPEG
images, B=2, 2 epochs, f32, device mosaic, both from one init checkpoint
(written by the port, read by both).

JAX's train step runs for the first iteration only, and is stubbed to zero
metrics after it (each size and ``use_l1`` compiles it anew, at ~15 s
each on this CPU). What is compared, with its tolerance:
- the first preprocessed batch: the labels' classes exact and boxes within
  1e-3 px; the images within 1 grey level, at most 1% of values more than
  1e-3 apart (the jitted-JAX bound of tests/test_torch_device_mosaic.py,
  whose docstring says why it is looser than 0.1%);
- the lr of each iteration within 1e-6 relative (JAX evaluates its schedule
  in f32, the port in f64 and the SGD rounds it to f32), the multiscale
  size of each iteration, the epoch of the no-aug switch and ``use_l1``:
  exact;
- the checkpoint files' keys, shapes and dtypes: exact;
- the resume bookkeeping (start epoch, best AP, the EMA's update count, the
  optimizer's step count as each saved it): exact;
- the first step's losses (the same weights, both steps fed JAX's first
  preprocessed batch, f32) within 1e-4 relative (measured: at most 4.6e-5,
  cls_loss): XLA:CPU and oneDNN sum the convs in other orders
  (tests/test_torch_model.py holds the f32 maps to 1e-4 (1 + |v|)). Fed
  the port's own batch instead, the total loss moves by 0.33%: the images'
  differences above shift the SimOTA assignment's costs;
- every loss of the port's run finite.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import cocodet_tpu.core.trainer as jtr
from cocodet_tpu.exp import get_exp_by_file as jax_exp
from cocodet_tpu_torch.core import trainer as ptr
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.exp import get_exp_by_file as port_exp
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import train as ptrain
from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["device_mosaic", "True", "depth", "0.33", "width", "0.125", "input_size", "(128, 128)",
        "test_size", "(128, 128)", "multiscale_range", "(0, 1)", "multiscale_step", "64",
        "max_epoch", "2", "warmup_epochs", "1", "no_aug_epochs", "1", "print_interval", "1",
        "compute_dtype", "float32", "data_num_workers", "1"]
LOSSES = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss")


class Args:
    batch_size = 2
    resume = False
    ckpt = None
    cache = True
    no_aug = False
    start_epoch = None


def make_exp(factory, path, root, out, init):
    exp = factory(path)
    exp.merge(OPTS + ["data_dir", root, "output_dir", out])
    exp.init_ckpt = init
    return exp


def init_checkpoint(tmp):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    variables = random_variables(shapes, 0, prior_prob=0.01)
    return save_checkpoint({"model": variables}, False, tmp, "init")


def no_mesh(self, batch_size):
    self.mesh = self.data_sharding = self.eval_sharding = None


def jax_setup(monkeypatch, init):
    """JAX's trainer on one device like the port's (the test session's 8
    virtual CPU devices would make it a mesh), its state created from the
    init checkpoint's tree instead of an eager ``model.init`` (which takes
    ~30 s here; the init checkpoint overwrites those values anyway)."""
    monkeypatch.setattr(jtr.Trainer, "_setup_mesh", no_mesh)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # both skip TensorBoard
    orig = jtr.create_train_state
    tree = jax.tree_util.tree_map(jax.numpy.asarray, load_checkpoint(init)["model"])

    def create(model, tx, rng, sample, use_ema=True, init_vars=None):
        return orig(model, tx, rng, sample, use_ema=use_ema, init_vars=init_vars or tree)

    monkeypatch.setattr(jtr, "create_train_state", create)


def record_progress(trainer, log):
    def progress(it, cur_size):
        log.append({"epoch": trainer.epoch, "it": it, "size": tuple(cur_size),
                    "use_l1": trainer.use_l1, "lr": trainer.meter["lr"].latest,
                    **{k: trainer.meter[k].latest for k in LOSSES}})
    trainer._log_progress = progress


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainer"))
    mp = pytest.MonkeyPatch()
    try:
        root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=8, n_val=4,
                                   size_range=(64, 128), seed=0)
        init = init_checkpoint(tmp)
        jax_setup(mp, init)
        out = {"root": root, "init": init}
        for name, factory, path, module in (
                ("jax", jax_exp, os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"), jtr),
                ("port", port_exp, os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                                "yolox_m_p6.py"), ptr)):
            exp = make_exp(factory, path, root, os.path.join(tmp, name), init)
            kw = {"device": "cpu"} if name == "port" else {}
            t = module.Trainer(exp, Args(), **kw)
            log, first = [], []
            record_progress(t, log)
            if name == "jax":
                zero = {k: np.float32(0) for k in LOSSES + ("num_fg",)}
                t.evaluate_and_save_model = lambda t=t: t.save_ckpt(f"epoch_{t.epoch + 1}")
                nb = t._next_batch

                def next_batch(nb=nb):
                    b = nb()
                    if not first:
                        first.append((np.asarray(b[0]), np.asarray(b[1])))
                    return b
                t._next_batch = next_batch
                t.before_train()
                real, calls = t.train_step, []

                def first_step_only(state, *a, real=real, calls=calls, **k):
                    calls.append(1)
                    return real(state, *a, **k) if len(calls) == 1 else (state, zero)
                t.train_step = first_step_only
                for t.epoch in range(t.start_epoch, t.max_epoch):  # JAX's Trainer.train
                    t.before_epoch()
                    t.train_in_iter()
                    t.after_epoch()
            else:
                pre = ptr.apply_device_preproc
                jimgs, jlabels = out["jax"]["first"]

                def preproc(*a):
                    b = pre(*a)
                    if not first:
                        # record the port's batch, and step on JAX's: the
                        # first step's losses compare the steps alone
                        first.append((b[0].numpy(), b[1].numpy()))
                        return torch.from_numpy(jimgs.copy()), torch.from_numpy(jlabels.copy())
                    return b
                mp.setattr(ptr, "apply_device_preproc", preproc)
                t.train()
            out[name] = {"trainer": t, "log": log, "first": first[0],
                         "latest": os.path.join(t.file_name, "latest_ckpt.msgpack")}
        yield out
    finally:
        mp.undo()


def test_first_preprocessed_batch_matches_jax(runs):
    (ji, jl), (pi, pl) = runs["jax"]["first"], runs["port"]["first"]
    assert pi.shape == ji.shape == (2, 128, 128, 3) and pl.shape == jl.shape == (2, 120, 5)
    np.testing.assert_array_equal(pl[..., 0], jl[..., 0])
    np.testing.assert_allclose(pl[..., 1:], jl[..., 1:], rtol=0, atol=1e-3)
    d = np.abs(pi.astype(np.float64) - ji)
    assert d.max() <= 1.0 and (d > 1e-3).mean() <= 1e-2


def test_schedule_sizes_and_switch_match_jax(runs):
    jlog, plog = runs["jax"]["log"], runs["port"]["log"]
    assert len(plog) == len(jlog) == 8
    for a, b in zip(plog, jlog):
        assert (a["epoch"], a["it"], a["size"], a["use_l1"]) == (b["epoch"], b["it"], b["size"],
                                                               b["use_l1"])
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6, atol=0)
    assert {r["size"] for r in plog} <= {(128, 128), (192, 192)}
    pt, jt = runs["port"]["trainer"], runs["jax"]["trainer"]
    assert pt.use_l1 == jt.use_l1 and pt.exp.eval_interval == jt.exp.eval_interval == 1
    for r in plog:
        assert all(np.isfinite(r[k]) for k in LOSSES)
    assert all(st["nonfinite_losses"] == 0 for st in pt.epoch_stats)
    assert [e["epoch"] for e in pt.eval_stats] == [1, 2]


def test_first_step_losses_match_jax(runs):
    p, j = runs["port"]["log"][0], runs["jax"]["log"][0]
    for k in LOSSES:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
    assert all(v != 0 for v in (p["loss"], j["loss"]))


def test_checkpoint_keys_and_shapes_match_jax(runs):
    a = flatten_tree(load_checkpoint(runs["port"]["latest"]))
    b = flatten_tree(load_checkpoint(runs["jax"]["latest"]))
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.shape(a[k]) == np.shape(b[k]) and np.asarray(a[k]).dtype == np.asarray(
            b[k]).dtype, k
    names = sorted(os.listdir(runs["port"]["trainer"].file_name))
    assert names == sorted(os.listdir(runs["jax"]["trainer"].file_name))


def test_resume_bookkeeping_matches_jax(runs):
    class Resume(Args):
        resume = True

    got = {}
    for name, factory, path, module in (
            ("jax", jax_exp, os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"), jtr),
            ("port", port_exp, os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                            "yolox_m_p6.py"), ptr)):
        t = runs[name]["trainer"]
        exp = make_exp(factory, path, runs["root"], t.exp.output_dir, None)
        exp.max_epoch = 3
        r = module.Trainer(exp, Resume(), **({"device": "cpu"} if name == "port" else {}))
        mp = pytest.MonkeyPatch()
        jax_setup(mp, runs["init"])
        try:
            r.before_train()
        finally:
            mp.undo()
        saved = load_checkpoint(runs[name]["latest"])
        count = (r.optimizer.count if name == "port"
                 else int(r.state.opt_state[1][1].count))
        got[name] = (r.start_epoch, r.best_ap, int(r.state.ema.updates))
        assert count == int(saved["opt_state"]["1"]["1"]["count"])
        if name == "port":
            r.after_train()
    assert got["port"] == got["jax"] == (2, 0.0, 8)


@pytest.mark.parametrize("attr, value", [("num_accumulate", 2), ("remat", True),
                                         ("spatial_devices", 2)])
def test_unported_training_paths_raise(runs, tmp_path, attr, value):
    """Named when gradient accumulation, remat and the trainer's spatial
    mesh raised (ROADMAP Queue 1 item 1); now each trains an epoch of the
    tiny exp on one rank. Accumulation: the optimizer is optax.MultiSteps'
    (the parameters move every second iteration, the lr's count with them)
    and the checkpoint's ``opt_state`` is the ``MultiStepsState`` tree,
    which JAX's ``from_state_dict`` reads into ``optax.MultiSteps(
    exp.get_optimizer(2), 2).init`` (trainer.py:106-110). remat: the
    step's forward recomputed, the losses finite. ``spatial_devices`` on
    one rank: JAX's warning and an unsharded run (trainer.py:172-178)."""
    import optax
    from flax import serialization

    exp = make_exp(port_exp, os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                          "yolox_m_p6.py"), runs["root"], str(tmp_path),
                   runs["init"])
    setattr(exp, attr, value)
    t = ptr.Trainer(exp, Args(), device="cpu")
    t.before_train()
    try:
        t.train_in_iter()
        if attr == "num_accumulate":
            t.save_ckpt("latest")
    finally:
        t.after_train()
    assert t.epoch_stats[0]["iterations"] == 4 and t.epoch_stats[0]["nonfinite_losses"] == 0
    assert t.mesh is None
    if attr == "num_accumulate":
        assert (t.optimizer.every_k, t.optimizer.count, t.optimizer.mini_step) == (2, 2, 0)
        tree = load_checkpoint(os.path.join(t.file_name, "latest_ckpt.msgpack"))
        jexp = make_exp(jax_exp, os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"),
                        runs["root"], str(tmp_path), None)
        params = jax.tree_util.tree_map(jax.numpy.asarray, tree["raw_model"]["params"])
        jexp.get_lr_scheduler(jexp.basic_lr_per_img * 2, t.iters_per_epoch)
        target = optax.MultiSteps(jexp.get_optimizer(2), every_k_schedule=2).init(params)
        restored = serialization.from_state_dict(target, tree["opt_state"])
        assert (int(restored.mini_step), int(restored.gradient_step)) == (0, 2)
        assert int(restored.inner_opt_state[1][1].count) == 2
    if attr == "spatial_devices":
        with open(os.path.join(t.file_name, "train_log.txt")) as f:
            assert "training UNSHARDED" in f.read()


def test_masked_exp_builds_the_trainer(tmp_path):
    """A masked exp (use_mask) is a trainer the port builds: the
    NotImplementedError it raised is gone (the masked training itself:
    tests/test_torch_compress_cli.py, tests/test_torch_pruner.py)."""
    exp = port_exp(os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py"))
    exp.output_dir = str(tmp_path)
    exp.use_mask = True
    exp.multiscale_step = 64  # the 4-level model's stride (ROADMAP Queue 3)
    assert ptr.Trainer(exp, Args(), device="cpu").exp.use_mask


def test_cli_refuses_several_hosts():
    """Named when ``--num-hosts > 1`` raised; now the CLI joins several
    hosts (tests/test_torch_trainer_hosts.py) and refuses only what cannot
    form a world: no ``--coordinator``, or a ``--host-id`` that is not one
    of the hosts. ``-d`` counts this host's ranks (1 on the CPU unless
    given)."""
    from cocodet_tpu_torch.tools.train import build, launch, local_ranks

    exp, args = build(["-n", "yolox-m-p6", "--num-hosts", "2", "--device", "cpu"])
    assert (args.num_hosts, args.host_id, local_ranks(args)) == (2, 0, 1)
    assert local_ranks(build(["-n", "yolox-m-p6", "-d", "3"])[1]) == 3
    with pytest.raises(ValueError, match="--coordinator"):
        launch(ptr.Trainer, ["-n", "yolox-m-p6", "--num-hosts", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--host-id 2"):
        launch(ptr.Trainer, ["-n", "yolox-m-p6", "--num-hosts", "2", "--host-id", "2",
                             "--device", "cpu"])


def fake_world(monkeypatch, world=2, rank=0):
    """The trainer's view of a process group of ``world`` ranks, for the
    guards that run before anything is built."""
    monkeypatch.setattr(ptr, "world_size", lambda: world)
    monkeypatch.setattr(ptr.dist, "get_rank", lambda: rank)


def test_ranks_refuse_what_they_cannot_shard(tmp_path, monkeypatch):
    """A batch the data rows do not divide raises before the first step (a
    rank cannot drop out of the mesh, as JAX's devices do); so do a space
    axis that does not divide the ranks, a training size in the unsafe
    sharding regime, and a test size the space axis does not divide
    (trainer.py:183-187, :221-252)."""
    fake_world(monkeypatch, world=4)
    path = os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6_spatial.py")
    cases = [({}, 3, "does not split over 2 data rows"),
             ({"spatial_devices": 3}, 4, "must divide the 4 ranks"),
             ({"multiscale_step": 64}, 4, "training size 704 is in the unsafe"),
             ({"test_size": (641, 640)}, 4, "test_size height 641")]
    for over, batch, match in cases:
        exp = port_exp(path)
        exp.output_dir = str(tmp_path)
        for k, v in over.items():
            setattr(exp, k, v)

        class A(Args):
            batch_size = batch
        with pytest.raises(ValueError, match=match):
            ptr.Trainer(exp, A(), device="cpu")
    exp = port_exp(path)
    exp.output_dir = str(tmp_path)

    class B(Args):
        batch_size = 4
    t = ptr.Trainer(exp, B(), device="cpu")  # 2 data rows of 2 images, 2 space ranks
    assert (t.world, t.rank, t.spatial_devices) == (4, 0, 2)


RANKLESS = {"pruner": ("prune", "yolox_m_p6_prune.py"),
            "tuner_distill": ("tune", "yolox_m_p6_tune_distill.py"),
            "synflow": ("synflow", "yolox_m_synflow.py")}


def rankless_trainer(kind):
    from cocodet_tpu_torch.core.pruner import Pruner
    from cocodet_tpu_torch.core.trainer_synflow import TrainerSynFlow
    from cocodet_tpu_torch.core.tuner import Tuner

    return {"pruner": Pruner, "tuner_distill": Tuner, "synflow": TrainerSynFlow}[kind]


@pytest.mark.parametrize("kind", sorted(RANKLESS))
def test_pruner_and_distillation_on_several_ranks_raise(tmp_path, monkeypatch, kind):
    """Named when the Pruner's distill and score steps, the Tuner's
    distillation step and SynFlow on several ranks raised (ROADMAP Queue 1
    item 1, done); now each builds on a world of 2 ranks and what it
    raises is the Trainer's guard: a batch the data rows do not divide
    (tests/test_torch_compress_ranks.py trains them on ranks)."""
    fake_world(monkeypatch)
    exp = port_exp(os.path.join(REPO, "cocodet_tpu_torch", "exps", *RANKLESS[kind]))
    exp.output_dir = str(tmp_path)
    assert rankless_trainer(kind)(exp, Args(), device="cpu").world == 2
    args = Args()
    args.batch_size = 3
    with pytest.raises(ValueError, match="does not split over 2 data rows"):
        rankless_trainer(kind)(exp, args, device="cpu")


@pytest.mark.parametrize("kind", ["trainer", "tuner", *sorted(RANKLESS)])
def test_cli_starts_one_rank_where_ranks_are_unported(monkeypatch, kind):
    """``-d``'s default on a host of 2 cards: a rank a card for every
    trainer (named when the Pruner, the distilling Tuner and SynFlow took
    one); an explicit ``-d`` is taken as given."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    rel = RANKLESS.get(kind, ("p6", "yolox_m_p6.py" if kind == "trainer"
                              else "yolox_m_p6_tune.py"))
    exp_file = os.path.join(REPO, "cocodet_tpu_torch", "exps", *rel)
    assert ptrain.local_ranks(ptrain.build(["-f", exp_file])[1]) == 2
    assert ptrain.local_ranks(ptrain.build(["-f", exp_file, "-d", "3"])[1]) == 3
