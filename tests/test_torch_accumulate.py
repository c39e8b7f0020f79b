"""Gradient accumulation (``num_accumulate > 1``): the port's SGD under
``core/train_state.py::multi_steps`` against ``optax.MultiSteps(chain(
add_decayed_weights(wd, mask), sgd(schedule, 0.9, nesterov=True)), 2)``
(cocodet_tpu/core/trainer.py:106-110; optax 0.2.6
transforms/_accumulation.py), and the ``MultiStepsState`` tree a checkpoint
carries (utils/convert.py), read by flax's ``from_state_dict`` and resumed
from JAX's.

Exact: ``mini_step``, ``gradient_step`` and the inner count after each of 4
mini-steps, the lr of each step (the schedule at ``gradient_step``), the
parameters left alone on the mini-steps that do not emit, the EMA's update
count (every mini-step) and the state's tree layout. Within 1 f32 ulp: the
parameters, the running mean ``acc_grads`` and the momentum trace, against
optax run op by op (``jax.disable_jit``): both compute ``acc + (g - acc) /
(n + 1)``, then ``g + wd p``, ``t = g + 0.9 t``, ``u = g + 0.9 t`` and ``p +
(-lr) u`` in f32, each op rounded on its own. Jitted, optax differs: the
``lax.cond`` of ``MultiSteps.update`` compiles the inner update, and XLA:CPU
contracts ``g + wd p`` and the momentum sums into FMAs (measured: the
parameters 16 ulps apart where ``p + u`` cancels to 1e-6, 3e-8 at most
absolute)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization, traverse_util

from cocodet_tpu.utils import checkpoint as jck
from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.models.yolox import build_model
from cocodet_tpu_torch.utils import checkpoint as pck
from cocodet_tpu_torch.utils.convert import (export_tensors, export_variables,
                                             load_optimizer_state, optimizer_state_dict,
                                             random_variables)

K = 2


def schedule(count):
    return 0.01 * 2.0 ** count


def tiny_model(seed=0):
    """Three conv-BN-act blocks: kernels (decayed) and BN vectors (not)."""
    from cocodet_tpu_torch.models.blocks import ConvBnAct

    torch.manual_seed(seed)
    model = torch.nn.Module()
    model.a, model.b, model.c = ConvBnAct(3, 8, 3), ConvBnAct(8, 16, 1), ConvBnAct(16, 4, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape))
    return model


def small_model(seed=0):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    return build_model("yolox-p6", depth=0.33, width=0.125, device="cpu",
                       variables=random_variables(shapes, seed, prior_prob=0.01))


def jax_tx():
    def mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    inner = optax.chain(optax.add_decayed_weights(5e-4, mask=mask),
                        optax.sgd(learning_rate=schedule, momentum=0.9, nesterov=True))
    return optax.MultiSteps(inner, every_k_schedule=K)


def grads_of(model, seed):
    rs = np.random.RandomState(seed)
    return {name: rs.randn(*p.shape).astype(np.float32) for name, p in model.named_parameters()}


def port_step(model, opt, g):
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(g[name].copy())
    opt.step()


def jax_step(tx, state, params, model, g):
    """optax's update and apply_updates, op by op (the module docstring says
    why)."""
    gtree = jax.tree_util.tree_map(jnp.asarray, export_tensors(
        {n: torch.from_numpy(v) for n, v in g.items()})["params"])
    with jax.disable_jit():
        upd, state = tx.update(gtree, state, params)
        return state, optax.apply_updates(params, upd)


def within_ulp(a, b, maxulp=1):
    fa = traverse_util.flatten_dict(a)
    fb = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_max_ulp(np.asarray(fa[k], np.float32),
                                        np.asarray(fb[k], np.float32), maxulp=maxulp)


@pytest.fixture(scope="module")
def four_mini_steps():
    model = tiny_model()
    opt = ts.multi_steps(ts.build_optimizer(model, schedule), K)
    tx = jax_tx()
    params = jax.tree_util.tree_map(jnp.asarray, export_variables(model)["params"])
    jstate = tx.init(params)
    rows = []
    for step in range(4):
        g = grads_of(model, seed=10 + step)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        port_step(model, opt, g)
        jstate, params = jax_step(tx, jstate, params, model, g)
        moved = any(not torch.equal(before[n], p) for n, p in model.named_parameters())
        rows.append({"moved": moved, "lr": opt.param_groups[0]["lr"] if moved else None,
                     "port": optimizer_state_dict(opt, model),
                     "params": export_variables(model)["params"],
                     "jax_state": serialization.to_state_dict(jstate), "jax_params": params})
    return rows


def test_counts_and_emits_match_optax(four_mini_steps):
    for step, row in enumerate(four_mini_steps):
        js, ps = row["jax_state"], row["port"]
        assert int(ps["mini_step"]) == int(js["mini_step"]) == (step + 1) % K
        assert int(ps["gradient_step"]) == int(js["gradient_step"]) == (step + 1) // K
        assert int(ps["inner_opt_state"]["1"]["1"]["count"]) == int(
            js["inner_opt_state"]["1"]["1"]["count"]) == (step + 1) // K
        assert row["moved"] == (step % K == K - 1)
        if row["moved"]:  # the lr is the schedule at the gradient step, not the iteration
            assert row["lr"] == schedule(step // K)


def test_parameters_and_state_within_one_ulp(four_mini_steps):
    for row in four_mini_steps:
        within_ulp(row["params"], row["jax_params"])
        within_ulp(row["port"]["acc_grads"], row["jax_state"]["acc_grads"])
        within_ulp(row["port"]["inner_opt_state"]["1"]["0"]["trace"],
                   row["jax_state"]["inner_opt_state"]["1"]["0"]["trace"])


def test_state_layout_is_optax_multisteps(four_mini_steps):
    port, jax_sd = four_mini_steps[2]["port"], four_mini_steps[2]["jax_state"]
    jax_sd = jax.tree_util.tree_map(np.asarray, jax_sd)
    assert jax.tree_util.tree_structure(port) == jax.tree_util.tree_structure(jax_sd)
    assert port["skip_state"] == {} and sorted(port) == sorted(jax_sd)
    for k in ("mini_step", "gradient_step"):
        assert port[k].dtype == jax_sd[k].dtype == np.int32
    flat = traverse_util.flatten_dict(port["acc_grads"])
    assert all(v.dtype == np.float32 for v in flat.values())


def test_checkpoint_reads_in_jax_and_jax_state_resumes_in_the_port(tmp_path):
    """A port checkpoint of a run stopped between two mini-steps, read by
    JAX's load_checkpoint + from_state_dict into MultiSteps.init's tree; and
    JAX's state at that point loaded into a fresh port optimizer, after
    which one more mini-step (the emitting one) agrees within 1 ulp."""
    model = tiny_model()
    opt = ts.multi_steps(ts.build_optimizer(model, schedule), K)
    tx = jax_tx()
    params = jax.tree_util.tree_map(jnp.asarray, export_variables(model)["params"])
    jstate = tx.init(params)
    for step in range(3):
        g = grads_of(model, seed=20 + step)
        port_step(model, opt, g)
        jstate, params = jax_step(tx, jstate, params, model, g)
    path = pck.save_checkpoint({"opt_state": optimizer_state_dict(opt, model)}, False,
                               str(tmp_path), "latest")
    restored = serialization.from_state_dict(tx.init(params),
                                             jck.load_checkpoint(path)["opt_state"])
    assert int(restored.mini_step) == 1 and int(restored.gradient_step) == 1
    within_ulp(serialization.to_state_dict(restored)["acc_grads"],
               serialization.to_state_dict(jstate)["acc_grads"])

    fresh = tiny_model(seed=3)
    with torch.no_grad():
        for p, q in zip(fresh.parameters(), model.parameters()):
            p.copy_(q)
    opt2 = ts.multi_steps(ts.build_optimizer(fresh, schedule), K)
    load_optimizer_state(opt2, fresh, jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jstate)))
    assert (opt2.count, opt2.mini_step) == (1, 1)
    g = grads_of(fresh, seed=30)
    port_step(fresh, opt2, g)
    jstate, params = jax_step(tx, jstate, params, fresh, g)
    assert opt2.count == 2 and opt2.mini_step == 0
    within_ulp(export_variables(fresh)["params"], params)
    with pytest.raises(ValueError, match="MultiSteps"):
        load_optimizer_state(ts.build_optimizer(fresh, schedule), fresh,
                             jax.tree_util.tree_map(np.asarray,
                                                    serialization.to_state_dict(jstate)))


def test_train_step_moves_ema_and_bn_every_mini_step():
    """Through ``make_train_step``: 4 mini-steps at k=2 move the EMA and the
    BN statistics every call and the parameters every second call, as
    JAX's step under MultiSteps (train_state.py:103-111)."""
    model = small_model()
    opt = ts.multi_steps(ts.build_optimizer(model, schedule), K)
    state = ts.create_train_state(model, opt)
    step = ts.make_train_step(state, (8, 16, 32, 64))
    rs = np.random.RandomState(0)
    labels = torch.zeros(2, 8, 5)
    labels[:, 0] = torch.tensor([3.0, 32.0, 32.0, 20.0, 24.0])
    stem = dict(model.named_parameters())
    name = next(n for n in stem if n.endswith("kernel") or stem[n].dim() == 4)
    bn = next(b for n, b in model.named_buffers() if n.endswith("running_mean"))
    for call in range(4):
        w0, bn0 = stem[name].detach().clone(), bn.clone()
        step(torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32) * 255), labels)
        assert state.ema.updates == call + 1
        assert not torch.equal(bn, bn0)
        assert torch.equal(stem[name], w0) == (call % K == 0)
    assert (opt.count, opt.mini_step) == (2, 0)


def test_pruner_ignores_num_accumulate(tmp_path):
    """JAX's Pruner builds exp.get_optimizer with no MultiSteps
    (cocodet_tpu/core/pruner.py:340); so does the port's, and the Tuner
    inherits the Trainer's accumulation."""
    from cocodet_tpu_torch.core.pruner import Pruner
    from cocodet_tpu_torch.core.tuner import Tuner
    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
    from cocodet_tpu_torch.exp import get_exp_by_file

    root = make_synthetic_coco(str(tmp_path / "coco"), n_train=2, n_val=1, size_range=(64, 96))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    class Args:
        batch_size = 2
        resume = False
        ckpt = None
        cache = False
        no_aug = False
        start_epoch = None

    got = {}
    for cls, rel in ((Pruner, ("prune", "yolox_m_p6_prune.py")),
                     (Tuner, ("tune", "yolox_m_p6_tune_distill.py"))):
        exp = get_exp_by_file(os.path.join(repo, "cocodet_tpu_torch", "exps", *rel))
        exp.merge(["depth", "0.33", "width", "0.125", "input_size", "(64, 64)", "test_size",
                   "(64, 64)", "multiscale_range", "(0, 0)", "compute_dtype", "float32",
                   "data_num_workers", "1", "data_dir", root, "output_dir", str(tmp_path),
                   "num_accumulate", "2", "init_ckpt", "None"])
        exp.distill_coefficient = 0.0
        t = cls(exp, Args(), device="cpu")
        t.before_train()
        got[cls.__name__] = t.optimizer.every_k
        t.after_train()
    assert got == {"Pruner": 1, "Tuner": 2}
