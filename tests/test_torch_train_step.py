"""Port parity: cocodet_tpu_torch/core/train_state.py (the train step, its
optimizer, the EMA, the lr schedules and resize_batch) against
cocodet_tpu/core/train_state.py and its helpers.

The step is held against JAX's ``make_train_step`` on the model of
``__graft_entry__.dryrun_multichip`` (yolox-p6, depth 0.33, width 0.125) at
64 px, B=2, from the same numpy-drawn variables (head biases at the prior
0.01), with the optimizer of ``exp/yolox_exp.py`` (SGD, nesterov momentum
0.9, weight decay 5e-4 on the conv kernels) under a yoloxwarmcos schedule
whose lr changes every step, use_l1 on. JAX's step is compiled once for the
module.

Tolerances. At this size the deepest levels are 1x1 and 2x2 maps of two
images, and BN over two or eight values per channel magnifies rounding
noise a thousandfold: a 1e-6 relative change of the parameters after the
first step moves the port's own third-step losses by up to 1.5e-2, and its
f32 step differs from JAX's f32 step by 13% of a parameter's update (median
over leaves). So the tight comparison runs both frameworks in f64
(``jax.enable_x64``, hard-swish and its gradient in f64 too; the losses
stay f32 in both, as JAX casts the maps): after one step each parameter
agrees to 1e-5 of its update, each BN statistic to 1e-9 and each EMA leaf
(an f32 shadow) to 1e-5 of its update. After three steps the f32 rounding
of the losses' gradients (1e-7 relative) has grown as described: the
losses agree to 3e-2, the fg count exactly, and each leaf is held by JAX's
update of it over the three steps (measured on the CPU: a median 0.052 and
a 90th percentile 0.23 of the update for the parameters, 0.0032 and 0.029
for the BN statistics, 0.0069 and 0.19 for the EMA; a step that updated
nothing would give 1). The update rule itself (momentum, the schedule's
step count, weight decay, the EMA ramp) is held exactly over three steps on
the same gradients (test_sgd_and_ema_match_optax). The f32 steps:
tests/test_torch_train_step_f32.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.core.train_state import resize_batch as jax_resize_batch
from cocodet_tpu.utils import ema as jema
from cocodet_tpu.utils import lr_scheduler as jlr
from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.utils import ema as tema
from cocodet_tpu_torch.utils import lr_scheduler as tlr
from torch_train_utils import STEPS, compare_tight, compare_updates, run


@pytest.fixture(scope="module")
def f64_runs():
    return run("float64")


def test_train_step_one_step_matches_jax_f64(f64_runs):
    p0, want, got = f64_runs
    compare_tight(p0, want[0], got[0])


def test_train_step_three_steps_match_jax_f64(f64_runs):
    p0, want, got = f64_runs
    compare_updates(p0, want[STEPS - 1], got[STEPS - 1], metrics_rtol=3e-2,
                    limits={"params": (0.2, 0.6), "batch_stats": (0.02, 0.1),
                            "ema": (0.05, 0.6)})


def _optax_sgd(schedule):
    from flax import traverse_util

    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    import optax

    return optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                       optax.sgd(schedule, momentum=0.9, nesterov=True))


def test_sgd_and_ema_match_optax():
    """Three SGD and EMA steps on the same gradients: build_optimizer's
    weight decay on the conv kernels only, nesterov momentum, the lr read at
    the count before each step, and the EMA ramp, against optax and
    utils/ema.py; to f32 rounding (1e-6 of each value)."""
    import optax

    rs = np.random.RandomState(8)
    model = torch.nn.Module()
    model.conv = torch.nn.Module()
    model.conv.weight = torch.nn.Parameter(torch.from_numpy(rs.normal(0, 1, (4, 3, 3, 3))
                                                            .astype(np.float32)))
    model.bn = torch.nn.BatchNorm2d(4)
    with torch.no_grad():
        model.bn.weight.uniform_(0.5, 1.5)
        model.bn.running_mean.normal_()
    kw = dict(lr=0.01, iters_per_epoch=1, total_epochs=20, warmup_epochs=5,
              warmup_lr_start=0.002, no_aug_epochs=2)
    opt = ts.build_optimizer(model, tlr.build_lr_schedule("yoloxwarmcos", **kw))
    ema = tema.ModelEMA(model, 0.9998)
    params = {"conv": {"kernel": jnp.asarray(model.conv.weight.detach().numpy())},
              "bn": {"scale": jnp.asarray(model.bn.weight.detach().numpy()),
                     "bias": jnp.asarray(model.bn.bias.detach().numpy())}}
    tx = _optax_sgd(jlr.build_lr_schedule("yoloxwarmcos", **kw))
    opt_state = tx.init(params)
    stats = {"bn": {"mean": jnp.asarray(model.bn.running_mean.numpy()),
                    "var": jnp.asarray(model.bn.running_var.numpy())}}
    ema_state = jema.ema_init({"params": params, "batch_stats": stats})
    for _ in range(3):
        grads = {"conv": {"kernel": rs.normal(0, 1, (4, 3, 3, 3)).astype(np.float32)},
                 "bn": {"scale": rs.normal(0, 1, 4).astype(np.float32),
                        "bias": rs.normal(0, 1, 4).astype(np.float32)}}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        ema_state = jema.ema_update(ema_state, {"params": params, "batch_stats": stats})
        model.conv.weight.grad = torch.from_numpy(grads["conv"]["kernel"])
        model.bn.weight.grad = torch.from_numpy(grads["bn"]["scale"])
        model.bn.bias.grad = torch.from_numpy(grads["bn"]["bias"])
        opt.step()
        ema.update()
    pairs = [(model.conv.weight, params["conv"]["kernel"], ema.shadow["conv.weight"],
              ema_state.shadow["params"]["conv"]["kernel"]),
             (model.bn.weight, params["bn"]["scale"], ema.shadow["bn.weight"],
              ema_state.shadow["params"]["bn"]["scale"]),
             (model.bn.bias, params["bn"]["bias"], ema.shadow["bn.bias"],
              ema_state.shadow["params"]["bn"]["bias"]),
             (model.bn.running_mean, stats["bn"]["mean"], ema.shadow["bn.running_mean"],
              ema_state.shadow["batch_stats"]["bn"]["mean"])]
    for got, want, got_ema, want_ema in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_ema.numpy(), np.asarray(want_ema), rtol=1e-6, atol=1e-6)
    assert opt.count == 3 and ema.updates == 3


def test_build_optimizer_decays_conv_kernels_only():
    from cocodet_tpu_torch.models import build_model

    model = build_model("yolox-p6", depth=0.33, width=0.125, device="cpu")
    opt = ts.build_optimizer(model, 0.01)
    decay, rest = opt.param_groups
    assert decay["weight_decay"] == 5e-4 and rest["weight_decay"] == 0.0
    assert all(p.dim() == 4 for p in decay["params"]) and all(p.dim() == 1 for p in rest["params"])
    assert decay["nesterov"] and decay["momentum"] == 0.9
    assert len(decay["params"]) + len(rest["params"]) == len(list(model.parameters()))


@pytest.mark.parametrize("name", ["cos", "warmcos", "yoloxwarmcos", "yoloxsemiwarmcos",
                                  "multistep"])
def test_lr_schedules_match_jax(name):
    kw = dict(iters_per_epoch=10, total_epochs=30, warmup_epochs=3, warmup_lr_start=1e-4,
              no_aug_epochs=5, min_lr_ratio=0.05, milestones=(10, 20), gamma=0.1)
    want = jlr.build_lr_schedule(name, 0.02, **kw)
    got = tlr.build_lr_schedule(name, 0.02, **kw)
    for it in (0, 1, 7, 29, 30, 31, 150, 199, 200, 249, 250, 251, 299, 300):
        # JAX computes in f32: 1e-6 relative, or 1e-9 absolute where the
        # cosine ends near -1 and 1 + cos cancels
        np.testing.assert_allclose(got(it), float(want(jnp.asarray(it))), rtol=1e-6,
                                   atol=1e-9, err_msg=f"{name} at {it}")


def test_ema_ramp_matches_jax():
    """d(t) = decay * (1 - exp(-t / 2000)) in f32, as utils/ema.py computes
    it. numpy's and XLA's f32 exp may differ by one ulp (6e-8), which
    1 - exp(-t / 2000) magnifies to 1.2e-4 relative at t = 1."""
    for t in (1, 2, 10, 1000, 2000, 10000, 100000):
        d_jax = float(jnp.float32(0.9998) * (1.0 - jnp.exp(-jnp.float32(t) / 2000.0)))
        np.testing.assert_allclose(tema.ema_decay(0.9998, t), d_jax, rtol=2e-4)


@pytest.mark.parametrize("size", [(48, 40), (96, 112), (64, 64)], ids=["down", "up", "same"])
def test_resize_batch_matches_jax(size):
    """jax.image.resize "bilinear" antialiases when it shrinks: the port's
    antialiased bilinear interpolate agrees both ways, to f32 rounding of
    0-255 pixels."""
    images = np.random.RandomState(9).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_resize_batch(jnp.asarray(images), size))
    got = ts.resize_batch(torch.from_numpy(images), size).numpy()
    assert got.shape == want.shape == (2, *size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_build_trainer_on_cpu():
    """entry.build_trainer: the model in train mode with f32 parameters
    computing in the given dtype, the head's cls/obj biases at logit(0.01),
    and a step that returns finite device metrics and moves the parameters,
    the BN statistics and the EMA."""
    from cocodet_tpu_torch.entry import build_trainer

    model, step = build_trainer(0.33, 0.125, torch.bfloat16, device="cpu", seed=2)
    assert model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(model.head.obj_pred0.bias.detach().numpy(),
                               -np.log(99.0), rtol=1e-6)
    w0 = model.head.reg_pred0.weight.detach().clone()
    mean0 = model.head.stem0.bn.running_mean.clone()
    rs = np.random.RandomState(3)
    images = torch.from_numpy(rs.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    labels = torch.zeros(2, 4, 5)
    labels[:, 0] = torch.tensor([3.0, 30.0, 30.0, 20.0, 16.0])
    metrics = step(images, labels, use_l1=True)
    assert set(metrics) == {"loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss",
                            "num_fg_per_gt", "num_fg"}
    assert all(torch.isfinite(v) for v in metrics.values()) and float(metrics["num_fg"]) > 0
    assert not torch.equal(model.head.reg_pred0.weight.detach(), w0)
    assert not torch.equal(model.head.stem0.bn.running_mean, mean0)


@pytest.mark.parametrize("lr", [None, 0.0025], ids=["default", "0.0025"])
def test_build_trainer_lr(lr):
    """entry.build_trainer's ``lr`` (``dryrun_multichip``'s 0.01 by
    default) is the SGD's: after the first step every parameter is, bit for
    bit, p + (-lr) * (0.9 t + t) with t = g + 5e-4 p on the conv kernels and
    t = g elsewhere, optax's nesterov step from a zero trace in its order."""
    import inspect

    from cocodet_tpu_torch.entry import build_trainer

    kw = {} if lr is None else {"lr": lr}
    model, step = build_trainer(0.33, 0.125, torch.float32, device="cpu", seed=2, **kw)
    lr = 0.01 if lr is None else lr
    opt = inspect.getclosurevars(step).nonlocals["state"].optimizer
    assert [g["lr"] for g in opt.param_groups] == [lr, lr]
    before = [p.detach().clone() for p in model.parameters()]
    rs = np.random.RandomState(3)
    images = torch.from_numpy(rs.uniform(0, 255, (1, 64, 64, 3)).astype(np.float32))
    labels = torch.zeros(1, 4, 5)
    labels[:, 0] = torch.tensor([3.0, 30.0, 30.0, 20.0, 16.0])
    step(images, labels)
    moved = 0
    for p0, p in zip(before, model.parameters()):
        t = p0 * 5e-4 + p.grad if p.dim() == 4 else p.grad
        want = p0 + (t * 0.9 + t) * -lr
        assert torch.equal(p.detach(), want)
        moved += int(not torch.equal(p.detach(), p0))
    assert moved > 0
