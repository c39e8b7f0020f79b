"""Port parity: train-mode BatchNorm fused with the activation after it
(cocodet_tpu_torch/models/blocks.py::_BatchNormAct over
ops/cuda/bn_act.py) against flax's nn.BatchNorm followed by
jax.nn.hard_swish (cocodet_tpu/models/blocks.py:403-415, :53-54), and its
closed-form backward against autograd through plain ops.

On the CPU the Function runs the kernels' plain stages (reduce, then apply,
each way). Tolerances are test_torch_blocks.py::test_batchnorm_train_matches
_flax's: the statistics are f32 sums in another order (XLA against ATen), so
f32 agrees to 1e-5 and the parameter gradients to 1e-4; in bf16 the output
and the input gradient may round one bf16 step apart (2**-7 relative); f64
agrees to 1e-10.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cocodet_tpu_torch.models import blocks as tb
from cocodet_tpu_torch.ops.cuda import bn_act as bnk
from torch_port_utils import assert_close, nchw

SHAPES = [(4, 5, 5, 3), (2, 4, 3, 13)]  # NHWC; C = 13 is not a multiple of 8
ACTS = ["hard_swish", "identity"]
TOLS = {"float32": dict(out=1e-5, stats=(1e-5, 1e-6), params=1e-4),
        "bfloat16": dict(out=2**-7, stats=(1e-5, 1e-6), params=2**-7),
        "float64": dict(out=1e-10, stats=(1e-10, 1e-10), params=1e-10)}


def _case(shape, seed):
    """NHWC x (channel 1 constant: var = 0) and cotangent g, and the BN's
    variables, from a numpy seed. Scales up to 2.5 put a good share of the
    BN output past hard-swish's bends at -3 and 3."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = rs.normal(0.5, 2.0, shape)
    x[..., 1] = 0.5
    g = rs.normal(0, 1, shape)
    variables = {"params": {"scale": rs.uniform(0.5, 2.5, c), "bias": rs.normal(0, 0.5, c)},
                 "batch_stats": {"mean": rs.normal(0, 0.1, c), "var": rs.uniform(0.5, 1.5, c)}}
    return x, g, variables


def _flax(x, g, variables, dtype, act):
    """(y, running stats, dx, dparams) of flax BatchNorm (+ hard-swish) and
    jax.vjp, as float64 numpy."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float64": jnp.float64}[dtype]
    pdt = jnp.float64 if dtype == "float64" else jnp.float32
    cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdt), variables)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3, dtype=jdt)

    def f(params, xin):
        y, st = bn.apply({"params": params, "batch_stats": cast["batch_stats"]}, xin,
                         mutable=["batch_stats"])
        return (jax.nn.hard_swish(y) if act == "hard_swish" else y), st

    y, vjp, st = jax.vjp(f, cast["params"], jnp.asarray(x, pdt).astype(jdt), has_aux=True)
    dparams, dx = vjp(jnp.asarray(g, pdt).astype(jdt))
    as64 = lambda a: np.asarray(jnp.asarray(a, jnp.float32 if dtype != "float64" else
                                            jnp.float64), np.float64)
    return (as64(y), {k: as64(v) for k, v in st["batch_stats"].items()}, as64(dx),
            {k: as64(v) for k, v in dparams.items()})


def _module(variables, dtype):
    c = len(variables["params"]["scale"])
    m = tb.BatchNorm(c).to(torch.float64 if dtype == torch.float64 else torch.float32)
    with torch.no_grad():
        for name, src in (("weight", ("params", "scale")), ("bias", ("params", "bias")),
                          ("running_mean", ("batch_stats", "mean")),
                          ("running_var", ("batch_stats", "var"))):
            getattr(m, name).copy_(torch.from_numpy(variables[src[0]][src[1]]))
    return m.train()


def _nhwc64(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _port(x, g, variables, dtype, act):
    """The same through the port's train-mode BN with ``act`` fused in."""
    m = _module(variables, dtype)
    xt = nchw(x, dtype).detach().requires_grad_()
    out = m(xt, act=act)
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    out.backward(nchw(g, dtype))
    return (_nhwc64(out),
            {"mean": m.running_mean.double().numpy(), "var": m.running_var.double().numpy()},
            _nhwc64(xt.grad),
            {"scale": m.weight.grad.double().numpy(), "bias": m.bias.grad.double().numpy()})


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=["C3", "C13"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_act_matches_flax(dtype, shape, act):
    """Output, running mean and variance, and the gradients of x, scale and
    bias, with a constant channel (var = 0, where jnp.maximum splits its
    gradient)."""
    x, g, variables = _case(shape, seed=3)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = _flax(x.astype(np.float32), g.astype(np.float32), variables, dtype, act)
    got = _port(x.astype(np.float32), g.astype(np.float32), variables, tdt, act)
    tol = TOLS[dtype]
    assert_close(got[0], want[0], rtol=tol["out"], atol=tol["out"])
    assert_close(got[2], want[2], rtol=tol["out"], atol=tol["out"])
    for k in ("mean", "var"):
        assert_close(got[1][k], want[1][k], rtol=tol["stats"][0], atol=tol["stats"][1])
    for k in ("scale", "bias"):
        assert_close(got[3][k], want[3][k], rtol=tol["params"], atol=tol["params"])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=["C3", "C13"])
def test_bn_act_f64_matches_flax(shape, act):
    """Under jax.enable_x64 both compute in f64: 1e-10."""
    x, g, variables = _case(shape, seed=4)
    with jax.enable_x64(True):
        want = _flax(x, g, variables, "float64", act)
    got = _port(x, g, variables, torch.float64, act)
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-10, atol=1e-10)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=1e-10, atol=1e-10)


def _bn_act_autograd(x, weight, bias, act):
    """Train-mode BN + act as plain ops under autograd (the port's BN before
    its kernels): flax's formula, torch.maximum's even split at var = 0, and
    the hard-swish autograd Function with JAX's VJP."""
    mean, mean2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
    mul = torch.rsqrt(var + 1e-3) * weight
    y = (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return tb.hard_swish(y) if act == "hard_swish" else y


@pytest.mark.parametrize("act", ACTS)
def test_closed_form_backward_matches_autograd_f64(act):
    """The Function's backward (bn_act.py::grad_finish_plain's closed form)
    against autograd through the plain ops, in f64, with a constant channel."""
    x, g, variables = _case((3, 4, 5, 13), seed=5)
    m = _module(variables, torch.float64)
    xt = nchw(x, torch.float64).detach().requires_grad_()
    m(xt, act=act).backward(nchw(g, torch.float64))
    w = m.weight.detach().clone().requires_grad_()
    b = m.bias.detach().clone().requires_grad_()
    xr = xt.detach().clone().requires_grad_()
    _bn_act_autograd(xr, w, b, act).backward(nchw(g, torch.float64))
    for got, want in ((xt.grad, xr.grad), (m.weight.grad, w.grad), (m.bias.grad, b.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("act", ACTS)
def test_gradcheck_f64(act):
    """torch.autograd.gradcheck of the Function in f64, no constant channel
    (the variance's max with 0 has a kink there)."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.normal(0.3, 1.5, (2, 5, 3, 4))).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    w = torch.from_numpy(rs.uniform(0.5, 2.5, 5)).requires_grad_()
    b = torch.from_numpy(rs.normal(0, 0.5, 5)).requires_grad_()
    bn = tb.BatchNorm(5).double()
    assert torch.autograd.gradcheck(
        lambda *a: tb._BatchNormAct.apply(*a, bn, act, None), (x, w, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stages_compose_to_the_module(dtype):
    """reduce_plain then apply_plain is the module's forward, bit for bit,
    running statistics included; grad_reduce_plain then grad_apply_plain its
    backward. The data-parallel split (stats, finish; grad_stats,
    grad_finish) gives the same bits; the CPU wrappers are the plain
    stages."""
    x, g, variables = _case((2, 6, 7, 13), seed=7)
    for act in ACTS:
        m = _module(variables, dtype)
        xt = nchw(x, dtype).detach().requires_grad_()
        gt = nchw(g, dtype)
        y = m(xt, act=act)
        y.backward(gt)
        ref = _module(variables, dtype)
        args = (ref.weight.detach(), ref.running_mean, ref.running_var, ref.eps, ref.momentum)
        sums, fvec = bnk.reduce_plain(xt.detach(), *args)
        assert torch.equal(bnk.apply_plain(xt.detach(), fvec, ref.bias.detach(), act), y)
        assert torch.equal(ref.running_mean, m.running_mean)
        assert torch.equal(ref.running_var, m.running_var)
        count = sums[-1:]
        gsums, bvec = bnk.grad_reduce_plain(xt.detach(), gt, fvec, ref.bias.detach(),
                                            ref.weight.detach(), count, act)
        dx = bnk.grad_apply_plain(xt.detach(), gt, fvec, ref.bias.detach(), bvec, act)
        assert torch.equal(dx, xt.grad)
        assert torch.equal(bvec[2], m.weight.grad) and torch.equal(bvec[3], m.bias.grad)

        split = _module(variables, dtype)
        s2 = bnk.stats_plain(xt.detach())
        f2 = bnk.finish_plain(s2, split.weight.detach(), split.running_mean, split.running_var,
                              split.eps, split.momentum)
        assert torch.equal(s2, sums) and torch.equal(f2, fvec)
        assert torch.equal(split.running_var, m.running_var)
        gs2 = bnk.grad_stats_plain(xt.detach(), gt, fvec, ref.bias.detach(), act)
        assert torch.equal(bnk.grad_finish_plain(gs2, fvec, ref.weight.detach(), count,
                                                 local=gs2), bvec)
        # the wrappers take the plain stages for CPU tensors
        cpu = _module(variables, dtype)
        s3, f3 = bnk.reduce(xt.detach(), cpu.weight.detach(), cpu.running_mean,
                            cpu.running_var, cpu.eps, cpu.momentum)
        assert torch.equal(f3, fvec) and torch.equal(
            bnk.grad_apply(xt.detach(), gt, f3, cpu.bias.detach(),
                           bnk.grad_reduce(xt.detach(), gt, f3, cpu.bias.detach(),
                                           cpu.weight.detach(), s3[-1:], act)[1], act), dx)


def test_conv_bn_act_routes_the_activation():
    """A train-mode ConvBnAct with hard-swish runs it inside its BN (the
    standalone hard-swish is not called); another activation follows the
    BN's identity epilogue; eval mode is the folded BN and the standalone
    activation, as before."""
    rs = np.random.RandomState(8)
    x = nchw(rs.normal(0, 1, (2, 6, 6, 4)).astype(np.float32))
    for act in ("hard_swish", "silu"):
        m = tb.ConvBnAct(4, 8, 3, 1, act=act)
        with torch.no_grad():
            m.conv.weight.copy_(torch.from_numpy(rs.normal(0, 0.3, m.conv.weight.shape)))
            m.bn.weight.uniform_(0.5, 1.5)
            m.bn.bias.normal_(0, 0.3)
        assert m.act_in_bn == (act == "hard_swish")
        conv = m.conv(x)
        for train in (True, False):
            m.train(train)
            ref = tb.BatchNorm(8).train(train)
            ref.load_state_dict(m.bn.state_dict())
            with torch.no_grad():
                want = tb.get_activation(act)(ref(conv))
                got = m(x)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_args_mirror_the_kernel_struct():
    """bn_act.py::_Args lists csrc/bn_act.cu::BnActArgs's fields in order, each of
    the size of its C type."""
    src = (Path(bnk.__file__).resolve().parents[2] / "csrc" / "bn_act.cu").read_text()
    body = re.search(r"struct BnActArgs \{(.*?)\n\};", src, re.S).group(1)
    sizes = {"int64_t": 8, "int": 4, "float": 4}
    want = [(name, 8 if star else sizes[ty]) for ty, star, name in
            re.findall(r"^\s*(?:const )?(\w+)(\*?) (\w+);", body, re.M)]
    assert len(want) == 32
    assert [(n, ctypes.sizeof(t)) for n, t in bnk._Args._fields_] == want


@pytest.mark.parametrize("width", [32, 256])
@pytest.mark.parametrize("c,v", [(c, v) for c in (1, 3, 13, 48, 96, 192, 256, 384, 576, 768,
                                                   1040, 2056) for v in (1, 4, 8) if c % v == 0])
def test_grid_plan_covers_every_channel(c, v, width):
    """The channels-last plan: tiles of at most ``width`` channels, a block
    of at most 256 threads with at least a thread a channel of its tile (the
    last block's finish gives each channel a thread), and tiles that cover
    C."""
    groups, lanes, tiles = bnk._cl_tiles(c, v, width)
    assert groups * v <= max(width, v) and groups * lanes <= 256 and lanes >= 1
    assert groups * v <= groups * lanes
    assert tiles * groups * v >= c > (tiles - 1) * groups * v
