"""Port parity: cocodet_tpu_torch/models/blocks.py against
cocodet_tpu/models/blocks.py, block by block, in f32 on the CPU.

Tolerance: rtol = atol = 1e-4. XLA:CPU and oneDNN sum a convolution in
different orders, so f32 results differ in the last bits; elementwise ops
(space-to-depth, pooling, upsampling) are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.models import blocks as jb
from cocodet_tpu_torch.models import blocks as tb
from cocodet_tpu_torch.utils.convert import load_variables
from torch_port_utils import assert_close, fp_state, nchw, nhwc, shared_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def _image(shape, seed=0):
    return np.random.RandomState(seed).uniform(-2.0, 2.0, shape).astype(np.float32)


def _parity(jax_module, torch_module, x, seed=0):
    variables = shared_variables(jax_module, torch_module, x, seed)
    load_variables(torch_module, variables)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(torch_module.eval()(nchw(x)))
    return got, want


@pytest.mark.parametrize("act", ["silu", "hard_swish", "relu", "lrelu", "mish",
                                 "identity"])
def test_get_activation(act):
    """hard_swish is bit for bit (test_hard_swish_matches_jax); the others
    call exp/tanh/softplus, which XLA and PyTorch round differently.

    On a failure the message names the side that is off against an f64
    evaluation and the process state that could explain it
    (torch_port_utils.fp_state): mish failed once, in one xdist worker of a
    whole run, with PyTorch's side off by up to 4.5e-4 (ROADMAP Queue 3)."""
    x = _image((4096,), seed=1) * 4
    want = np.asarray(jb.get_activation(act)(jnp.asarray(x)))
    got = tb.get_activation(act)(torch.from_numpy(x)).numpy()
    if act == "hard_swish":
        np.testing.assert_array_equal(got, want)
        return
    ok = np.abs(got - want) <= 1e-6 + 1e-6 * np.abs(want)
    if not ok.all():
        ref = tb.get_activation(act)(torch.from_numpy(x).double()).numpy()
        i = int(np.argmax(np.abs(got - want)))
        pytest.fail(f"{act}: {int((~ok).sum())} of {x.size} differ; at x = {x[i]!r} the port "
                    f"gives {got[i]!r}, JAX {want[i]!r}, f64 {ref[i]!r}; max |port - f64| = "
                    f"{np.abs(got - ref).max():.3e}, max |JAX - f64| = "
                    f"{np.abs(want - ref).max():.3e}; state: {fp_state()}")


def test_elementwise_math_matches_f64():
    """The sentinel of the mish fault (ROADMAP Queue 3): torch's f32 exp,
    tanh and softplus on mish's input are within 2 ulp of their f64 values,
    as SLEEF's 1-ulp kernels give them; the message reports the process
    state when they are not."""
    x = torch.from_numpy(_image((4096,), seed=1) * 4)
    for name, fn in (("exp", torch.exp), ("tanh", torch.tanh),
                     ("softplus", torch.nn.functional.softplus)):
        got = fn(x).double()
        ref = fn(x.double())
        ulp = torch.from_numpy(np.spacing(np.abs(ref.float().numpy()))).double()
        bad = (got - ref).abs() > 2 * ulp
        assert not bad.any(), (f"{name}: {int(bad.sum())} values off by more than 2 ulp, the "
                               f"worst {float(((got - ref).abs() / ulp).max()):.1f} ulp; state: "
                               f"{fp_state()}")


def _bits(a):
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_swish_matches_jax(dtype):
    """The port's hard_swish equals jax.nn.hard_swish bit for bit on the CPU.

    f32: 2^21 values, uniform on [-4, 4] (the bend) and N(0, 50^2) (the
    linear parts). bf16: every bit pattern but the NaNs. XLA:CPU flushes
    subnormals to zero and PyTorch does not, so subnormal inputs are left
    out, and where the port's output is at most the smallest normal (an
    intermediate in f32 may fall below it) JAX's is that or a zero."""
    if dtype == "float32":
        rs = np.random.RandomState(0)
        x = np.concatenate([rs.uniform(-4, 4, 1 << 20),
                            rs.normal(0, 50, 1 << 20)]).astype(np.float32)
        want = np.asarray(jax.nn.hard_swish(jnp.asarray(x)))
        got = tb.hard_swish(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    f = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    tiny = np.finfo(np.float32).tiny
    f = f[~np.isnan(f) & ~((f != 0) & (np.abs(f) < tiny))]
    want = np.asarray(jax.nn.hard_swish(jnp.asarray(f).astype(jnp.bfloat16)).astype(jnp.float32))
    got = tb.hard_swish(torch.from_numpy(f).to(torch.bfloat16)).float().numpy()
    flushed = (got != 0) & (np.abs(got) <= tiny)
    assert ((want[flushed] == 0) | (want[flushed] == got[flushed])).all()
    both_nan = np.isnan(got) & np.isnan(want)  # -inf * 0
    same = (_bits(got) == _bits(want)) | both_nan
    assert same[~flushed].all(), f[~flushed & ~same][:10]
    assert (~flushed).sum() > 64000


@pytest.mark.parametrize("k,stride,groups,fused", [
    (3, 2, 1, False), (1, 1, 1, True), (4, 2, 1, False), (3, 1, 8, False),
    (5, 1, 8, True)])
def test_conv_bn_act(k, stride, groups, fused):
    x = _image((2, 16, 16, 8))
    got, want = _parity(
        jb.ConvBnAct(12 if groups == 1 else 8, k, stride, groups=groups,
                     act="hard_swish", fused=fused),
        tb.ConvBnAct(8, 12 if groups == 1 else 8, k, stride, groups=groups,
                     act="hard_swish", fused=fused), x)
    assert got.shape == want.shape
    assert_close(got, want, **TOL)


def test_conv2d_bias():
    x = _image((2, 8, 8, 16))
    got, want = _parity(jb.Conv2d(80, 1, use_bias=True),
                        tb.Conv2d(16, 80, 1, use_bias=True), x)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("shortcut,depthwise,custom,is_last", [
    (True, False, False, False), (False, False, True, False),
    (False, True, True, False), (False, True, True, True),
    (True, True, False, False)])
def test_bottleneck(shortcut, depthwise, custom, is_last):
    x = _image((2, 12, 12, 16))
    kw = dict(shortcut=shortcut, expansion=1.0, depthwise=depthwise,
              kernel_size=5 if depthwise else 3, is_last=is_last,
              custom=custom, act="hard_swish")
    got, want = _parity(jb.Bottleneck(16, **kw), tb.Bottleneck(16, 16, **kw), x)
    assert_close(got, want, **TOL)


def test_spp_bottleneck():
    x = _image((2, 16, 16, 24))
    got, want = _parity(jb.SPPBottleneck(20, act="hard_swish"),
                        tb.SPPBottleneck(24, 20, act="hard_swish"), x)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("custom,n,shortcut", [(True, 2, True), (True, 1, False),
                                               (False, 2, True)])
def test_csp_layer(custom, n, shortcut):
    # cin != features: the custom bypass width is cin - hidden
    x = _image((2, 8, 8, 24))
    kw = dict(n=n, shortcut=shortcut, custom=custom, act="hard_swish")
    got, want = _parity(jb.CSPLayer(16, **kw), tb.CSPLayer(24, 16, **kw), x)
    assert_close(got, want, **TOL)


def test_max_pool_same_pads_with_neg_inf():
    x = -10.0 - np.abs(_image((2, 9, 9, 3)))  # all negative: a zero pad would show
    for k in (5, 9, 13):
        want = np.asarray(jb.max_pool_same(jnp.asarray(x), k))
        got = nhwc(tb.max_pool_same(nchw(x), k))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ["pixel_unshuffle", "slice_cat"])
def test_space_to_depth(order):
    x = _image((2, 8, 6, 3))
    want = np.asarray(jb.space_to_depth(jnp.asarray(x), order))
    got = tb.space_to_depth(torch.from_numpy(x), order).numpy()
    np.testing.assert_array_equal(got, want)
    if order == "pixel_unshuffle":  # the p6 stem's order is F.pixel_unshuffle
        pu = torch.nn.functional.pixel_unshuffle(nchw(x), 2)
        np.testing.assert_array_equal(nhwc(pu), want)


@pytest.mark.parametrize("order", ["pixel_unshuffle", "slice_cat"])
def test_focus(order):
    x = _image((2, 16, 16, 3))
    jm = jb.Focus(8, kernel_size=3, act="hard_swish", order=order)
    tm = tb.Focus(3, 8, kernel_size=3, act="hard_swish", order=order)
    variables = shared_variables(jm, tm, x)
    load_variables(tm, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm.eval()(torch.from_numpy(x), torch.float32))
    assert_close(got, want, **TOL)


def test_upsample2x():
    x = _image((2, 5, 7, 4))
    want = np.asarray(jb.upsample2x(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tb.upsample2x(nchw(x))), want)


def test_conv_bn_act_bf16():
    """bf16 compute: the port casts the f32 weights per call as flax does;
    flax's BN and the conv round at other places, so the stated tolerance is
    a few bf16 ulps (2**-8 relative)."""
    x = _image((2, 16, 16, 8))
    jm = jb.ConvBnAct(12, 3, 1, act="hard_swish", dtype=jnp.bfloat16)
    tm = tb.ConvBnAct(8, 12, 3, 1, act="hard_swish")
    variables = shared_variables(jm, tm, x)
    load_variables(tm, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = tm.eval()(nchw(x, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert_close(nhwc(out), want, rtol=3e-2, atol=3e-2)


_HS_VJP = jax.jit(lambda x, g: jax.vjp(jax.nn.hard_swish, x)[1](g)[0])


def _hs_grad(x: np.ndarray, g: np.ndarray, dtype):
    """(port, JAX) d/dx of hard-swish at x with cotangent g, as f32 numpy:
    the port through autograd (models/blocks.py::hard_swish), JAX by
    jax.jit(jax.vjp) on XLA:CPU."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = np.asarray(_HS_VJP(jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    tb.hard_swish(xt).backward(torch.from_numpy(g).to(tdt))
    return xt.grad.float().numpy(), want


def _assert_bits_equal(got, want):
    """Equal bits, NaN on both (inf * 0), or a port result at most the
    smallest normal where XLA:CPU flushed it to zero (or gave the same)."""
    tiny = np.finfo(np.float32).tiny
    flushed = (got != 0) & (np.abs(got) <= tiny)
    assert ((want[flushed] == 0) | (want[flushed] == got[flushed])).all()
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same[~flushed].all(), (got[~flushed & ~same][:8], want[~flushed & ~same][:8])


def test_hard_swish_grad_matches_jax_bf16():
    """The port's hard-swish backward equals jax.vjp of jax.nn.hard_swish
    under jax.jit, bit for bit, on every non-NaN, non-subnormal bf16 x times
    a set of cotangents (bf16: each op rounded to bf16, relu6's mask on the
    rounded x + 3)."""
    f = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    tiny = np.finfo(np.float32).tiny
    f = f[~np.isnan(f) & ~((f != 0) & (np.abs(f) < tiny))]
    cots = [1.0, -1.0, 0.5, 3.0, -2.5, 1e-3, 700.0, -0.3333, 1e30]
    rs = np.random.RandomState(0)
    for c in cots + [None]:
        g = rs.normal(0, 2, f.shape).astype(np.float32) if c is None else np.full_like(f, c)
        _assert_bits_equal(*_hs_grad(f, g, "bfloat16"))


def test_hard_swish_grad_matches_jax_f32():
    """2^20 f32 values (the bend, the linear parts, and +-3, 0, the clamp
    bounds and their neighbours), bit for bit: XLA:CPU fuses g * h + s into
    one fused multiply-add, which the plain version rounds once."""
    rs = np.random.RandomState(1)
    edges = np.array([-3, 3, 0, -0.0, 6, -6, 2.9999998, -2.9999998, 3.0000002,
                      -3.0000002, -3.0000005, 2.9999995], np.float32)
    n = (1 << 20) - edges.size
    x = np.concatenate([rs.uniform(-4, 4, n // 2), rs.normal(0, 50, n - n // 2),
                        edges]).astype(np.float32)
    g = rs.normal(0, 3, x.shape).astype(np.float32)
    _assert_bits_equal(*_hs_grad(x, g, "float32"))


def test_hard_swish_f64_matches_jax():
    """Under jax.enable_x64 the port computes f64 in f64: the forward bit for
    bit (a multiply by the f64 1/6), the backward up to the rounding of
    g * h, which XLA fuses into the sum (1e-11 of the gradient's size where
    the two terms cancel); 0 at x = -3 and 1 at x = 3."""
    rs = np.random.RandomState(2)
    x = np.concatenate([rs.uniform(-4, 4, 1 << 16), rs.normal(0, 50, 1 << 15),
                        [0.0, 6.0, -6.0, -3.0, 3.0]])
    g = np.concatenate([rs.normal(0, 3, x.size - 2), [1.0, 1.0]])
    with jax.enable_x64(True):
        y_jax = np.asarray(jax.jit(jax.nn.hard_swish)(jnp.asarray(x)))
        dx_jax = np.asarray(_HS_VJP(jnp.asarray(x), jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    y = tb.hard_swish(xt)
    y.backward(torch.from_numpy(g))
    assert y.dtype == xt.grad.dtype == torch.float64
    np.testing.assert_array_equal(y.detach().numpy(), y_jax)
    np.testing.assert_allclose(xt.grad.numpy(), dx_jax, rtol=0, atol=1e-11 * np.abs(g).max())
    np.testing.assert_array_equal(xt.grad.numpy()[-2:], [0.0, 1.0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_swish_grad_at_the_bounds(dtype):
    """relu6's gradient is 0 at both bounds: d/dx is 0 at x = -3 and 1 at
    x = 3, and in bf16 x = 2.999 rounds to 3 (autograd through clamp would
    give -0.5, 1.5, 1.5)."""
    x = np.array([-3.0, 3.0, 2.999], np.float32)
    got, want = _hs_grad(x, np.ones_like(x), dtype)
    np.testing.assert_array_equal(want[:2], [0.0, 1.0])
    np.testing.assert_array_equal(got, want)
    if dtype == "bfloat16":
        assert got[2] == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Train-mode BN against flax.linen.BatchNorm (momentum 0.97, eps 1e-3,
    dtype): the output, the running mean and the biased running variance,
    and the gradients of x, scale and bias. The statistics are f32 sums in
    another order (XLA against ATen): f32 to 1e-5; in bf16 the output and
    the input gradient may round one bf16 step apart (2**-7 relative)."""
    import flax.linen as fnn

    rs = np.random.RandomState(2)
    x = (rs.normal(0.5, 2.0, (4, 5, 5, 3))).astype(np.float32)
    g = rs.normal(0, 1, x.shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3, dtype=jdt)
    variables = {"params": {"scale": rs.uniform(0.5, 1.5, 3).astype(np.float32),
                            "bias": rs.normal(0, 0.1, 3).astype(np.float32)},
                 "batch_stats": {"mean": rs.normal(0, 0.1, 3).astype(np.float32),
                                 "var": rs.uniform(0.5, 1.5, 3).astype(np.float32)}}
    xj = jnp.asarray(x).astype(jdt)

    def apply(params, xin):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xin,
                        mutable=["batch_stats"])

    y, stats = apply(variables["params"], xj)
    _, vjp = jax.vjp(lambda p, xin: apply(p, xin)[0], variables["params"], xj)
    dparams, dx = vjp(jnp.asarray(g).astype(jdt))

    m = tb.BatchNorm(3)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        m.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        m.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        m.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    xt = nchw(x, tdt).detach().requires_grad_()
    out = m.train()(xt)
    assert out.dtype == tdt
    out.backward(nchw(g, tdt))

    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    assert_close(nhwc(out), np.asarray(y.astype(jnp.float32)), **tol)
    assert_close(nhwc(xt.grad), np.asarray(dx.astype(jnp.float32)), **tol)
    for name, want in (("running_mean", "mean"), ("running_var", "var")):
        assert_close(getattr(m, name).numpy(), np.asarray(stats["batch_stats"][want]),
                     rtol=1e-5, atol=1e-6)
    assert_close(m.weight.grad.numpy(), np.asarray(dparams["scale"]), rtol=1e-4, atol=1e-4)
    assert_close(m.bias.grad.numpy(), np.asarray(dparams["bias"]), rtol=1e-4, atol=1e-4)
    # the biased variance: nn.BatchNorm2d's unbiased update is another number
    ref = torch.nn.BatchNorm2d(3, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        ref.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
        ref(nchw(x))
    assert not np.allclose(ref.running_var.numpy(), m.running_var.numpy(), rtol=1e-6, atol=0)
