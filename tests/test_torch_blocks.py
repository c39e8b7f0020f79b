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
from torch_port_utils import assert_close, nchw, nhwc, shared_variables

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
    call exp/tanh/softplus, which XLA and PyTorch round differently."""
    x = _image((4096,), seed=1) * 4
    want = np.asarray(jb.get_activation(act)(jnp.asarray(x)))
    got = tb.get_activation(act)(torch.from_numpy(x)).numpy()
    if act == "hard_swish":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


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
