"""The fake-quant of the port (cocodet_tpu_torch/ops/cuda/fake_quant.py and
csrc/fake_quant.cu) against JAX's (cocodet_tpu/models/blocks.py::
fake_quant, as the quant="qat" conv uses it), on the CPU.

Bit for bit against ``jax.jit`` (XLA:CPU, the roundings of the jitted QAT
step; the forward's two roundings ``vc + (round(vc/s)*s - vc)`` are not
contracted into a fused multiply-add there, and XLA folds ``127 * (am /
127)`` into ``am`` and ``/ 127`` into a multiply by f32(1/127)):

- the plain forward and its VJP on values around and on +-127*s, on exact
  ties at .5, beyond the clip and at NaN, with a scalar scale, a
  per-input-channel activation scale and the per-out-channel kernel scale
  with the per-channel act_scale folded in and divided out; the gradient
  1/2 at the bounds (every out channel's largest weight) and ((g / av) *
  gate) * av for the folded kernel.

And csrc/fake_quant.cu's kernels, compiled by g++ against the CPU stand-in
of tests/cuda_emu/ (fake_quant_emu.cpp), against the plain versions, bit
for bit, forward and backward, in the layouts the port hands them (a
channels-last map, a contiguous NCHW one, an OIHW kernel in channels-last
memory), on the vector path with ragged tails and on the scalar path, in
32-bit and 64-bit indices.
Subnormals are left out: XLA:CPU flushes them, PyTorch and the kernel keep
them.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.models.blocks import fake_quant as jax_fake_quant
from cocodet_tpu_torch.models.blocks import fake_quant
from cocodet_tpu_torch.ops.cuda import fake_quant as fq

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "..", "cocodet_tpu_torch", "csrc", "fake_quant.cu")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_bits(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    both_nan = np.isnan(got) & np.isnan(want)
    diff = (_bits(got) != _bits(want)) & ~both_nan
    assert not diff.any(), (f"{what}: {int(diff.sum())} of {diff.size} differ, e.g. got "
                            f"{got[diff][:4]} want {want[diff][:4]}")


def _values(rs, shape, scale):
    """Values on a grid of +-140 * scale with exact ties at .5, the bounds,
    values one ulp either side of them and beyond the clip."""
    s = np.broadcast_to(np.asarray(scale, np.float32), shape)
    k = rs.randint(-140, 141, shape).astype(np.float32)
    v = (k + rs.choice([0.0, 0.5, 0.25, 0.49999], shape).astype(np.float32)) * s
    pick = rs.rand(*shape)
    hi = np.float32(127.0) * s
    v = np.where(pick < 0.1, hi, v)
    v = np.where((pick >= 0.1) & (pick < 0.2), -hi, v)
    v = np.where((pick >= 0.2) & (pick < 0.25), np.nextafter(hi, np.float32(np.inf)), v)
    v = np.where((pick >= 0.25) & (pick < 0.3), np.nextafter(-hi, np.float32(0)), v)
    return np.ascontiguousarray(v.astype(np.float32))


def _jax_value_and_grad(f, v, scale, g):
    """f(v, scale) and the gradient of sum(f * g) with respect to v, each in
    one jit with the scale an argument, as the QAT step has them (a scale
    baked in as a constant, or the backward jitted apart from the forward,
    turns some divisions into multiplies by a reciprocal)."""
    y = jax.jit(f)(v, scale)
    dv = jax.jit(jax.grad(lambda t, s, c: jnp.sum(f(t, s) * c)))(v, scale, g)
    return np.asarray(y), np.asarray(dv)


# --------------------------------------------------------------------------
# the plain versions against JAX
# --------------------------------------------------------------------------


def test_grad_example_of_the_clip():
    """jax.grad of the clip gives [0.5, 0.5, 1, 0] at [63.5, -63.5, 63.4,
    70] with s = 0.5; the port's the same."""
    v = np.asarray([63.5, -63.5, 63.4, 70.0], np.float32)
    s = np.float32(0.5)
    want = jax.grad(lambda x: jnp.sum(jax_fake_quant(x, s)))(v)
    x = torch.tensor(v, requires_grad=True)
    st = torch.tensor(s)
    fake_quant(x, st, fq.act_bound(st), axis=0).sum().backward()
    np.testing.assert_array_equal(np.asarray(want), [0.5, 0.5, 1.0, 0.0])
    _assert_bits(x.grad.numpy(), want, "grad")


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per_input_channel"])
def test_activation_matches_jax(per_channel):
    """An activation (B, H, W, C) in JAX, (B, C, H, W) channels-last here:
    forward and VJP bit for bit, NaN included (NaN out, 0 gradient)."""
    rs = np.random.RandomState(1 + per_channel)
    C = 24
    scale = (rs.uniform(0.001, 0.3, C) if per_channel else rs.uniform(0.001, 0.3, ())
             ).astype(np.float32)
    x = _values(rs, (3, 5, 7, C), scale)
    x[0, 0, 0, :3] = np.nan
    g = rs.randn(*x.shape).astype(np.float32)
    y_want, dx_want = _jax_value_and_grad(jax_fake_quant, x, scale, g)

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    st = torch.from_numpy(scale)
    y = fake_quant(xt, st, fq.act_bound(st), axis=1)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    _assert_bits(y.detach().permute(0, 2, 3, 1).numpy(), y_want, "forward")
    _assert_bits(xt.grad.permute(0, 2, 3, 1).numpy(), dx_want, "gradient")
    assert (np.asarray(dx_want) == 0.5 * g).any()  # the bounds were hit


def _jax_kernel_fq(kernel, av):
    """The kernel path of JAX's quant="qat" conv (blocks.py:288-319)."""
    kf = kernel.astype(jnp.float32)
    if av is not None:
        avb = av[None, None, :, None]
        kf = kf * avb
    ws = jax.lax.stop_gradient(jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)), 1e-8) / 127.0)
    q = jax_fake_quant(kf, ws)
    return q / avb if av is not None else q


def _port_kernel_fq(weight, av):
    kf = weight * av.view(1, -1, 1, 1) if av is not None else weight
    return fake_quant(kf, *fq.weight_scale_bound(kf), axis=0, div=av)


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar_act", "folded_act"])
def test_kernel_matches_jax(per_channel):
    """A conv kernel (HWIO in JAX, OIHW in channels-last memory here): the
    dynamic per-out-channel scale, the fold of a per-channel act_scale, the
    forward and the VJP bit for bit; every out channel's largest weight
    takes the gradient 1/2."""
    rs = np.random.RandomState(3 + per_channel)
    k = (rs.randn(3, 3, 16, 32) * 0.05).astype(np.float32)
    k[..., 5] = 0.0  # an all-zero channel: the 1e-8 floor
    av = rs.uniform(0.01, 0.2, 16).astype(np.float32) if per_channel else None
    g = rs.randn(*k.shape).astype(np.float32)
    y_want, dk_want = _jax_value_and_grad(_jax_kernel_fq, k, av, g)

    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = _port_kernel_fq(w, None if av is None else torch.from_numpy(av))
    y.backward(torch.from_numpy(g.transpose(3, 2, 0, 1).copy()))
    _assert_bits(y.detach().permute(2, 3, 1, 0).numpy(), y_want, "forward")
    _assert_bits(w.grad.permute(2, 3, 1, 0).numpy(), dk_want, "gradient")
    kf = k * (av[None, None, :, None] if per_channel else 1)
    top = np.abs(kf) == np.abs(kf).max(axis=(0, 1, 2), keepdims=True)
    top[..., 5] = False
    halves = dk_want[top] / (g[top] if not per_channel else
                             ((g / av[None, None, :, None]) * av[None, None, :, None])[top])
    np.testing.assert_array_equal(halves, 0.5)


def test_ties_round_half_to_even():
    s = torch.tensor(1.0)
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5])
    np.testing.assert_array_equal(fq.fake_quant_plain(v, s, fq.act_bound(s), axis=0).numpy(),
                                  [0.0, 2.0, 2.0, -0.0, -2.0, 126.0, -126.0])


def test_cuda_tensor_without_kernel_raises():
    """A wrapper takes its plain version only for CPU tensors; anything else
    launches the kernel or raises (here: no CUDA device to launch on)."""
    v = torch.zeros(4, device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        fq.fake_quant(v, torch.tensor(1.0), torch.tensor(127.0), axis=0)


# --------------------------------------------------------------------------
# the CUDA source through the CPU stand-in
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_quant_emu")
    src = open(SOURCE).read()
    src = src[:src.index("}  // namespace")].replace("namespace {", "")
    (out / "kernels.inc").write_text(src)
    lib = out / "libfake_quant_emu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-w",
           f"-I{os.path.join(HERE, 'cuda_emu')}", f"-I{out}", "-o", str(lib),
           os.path.join(HERE, "cuda_emu", "fake_quant_emu.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    fn = ctypes.CDLL(str(lib)).emu_fake_quant
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, p, p, i64, p, p, i64, i64, p, i64, i64, i, i, i]
    fn.restype = i
    return fn


def _emu_run(fn, v, g, scale, bound, axis, div, vec, wide, offset=0):
    """One emulated launch on ``v`` (its storage as it lies), starting
    ``offset`` elements into a buffer so that the scalar path is taken."""
    n = v.numel()
    buf = torch.empty(n + offset + 4)
    buf[offset:offset + n] = _storage(v)
    out = torch.zeros(n + offset + 4)
    gbuf = None
    if g is not None:
        gbuf = torch.zeros(n + offset + 4)
        gbuf[offset:offset + n] = _storage(g)
    s_inner, s_count = fq._channels(v, bound, axis, "scale")
    d_inner, d_count = fq._channels(v, div, 1, "div")
    scale = (bound if scale is None else scale).contiguous()
    ptr = lambda t: t.data_ptr() + 4 * offset  # noqa: E731
    rc = fn(ptr(buf), None if g is None else ptr(gbuf), ptr(out), n, scale.data_ptr(),
            bound.contiguous().data_ptr(), s_inner, s_count,
            None if div is None else div.contiguous().data_ptr(), d_inner, d_count,
            int(g is not None), vec, wide)
    assert rc == 0
    return torch.as_strided(out[offset:offset + n].clone(), v.shape, v.stride())


def _storage(t):
    """The elements of a dense tensor in storage order."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return t.permute(*order).reshape(-1)


CASES = {
    # name: (shape, memory format, axis of the scale, per channel, fold)
    "map_channels_last_scalar": ((2, 24, 5, 7), torch.channels_last, 1, False, False),
    "map_channels_last_channel": ((2, 24, 5, 7), torch.channels_last, 1, True, False),
    "map_nchw_channel": ((2, 12, 3, 5), torch.contiguous_format, 1, True, False),
    "map_ragged_tail": ((1, 7, 3, 3), torch.channels_last, 1, True, False),
    "kernel_per_out_channel": ((32, 16, 3, 3), torch.channels_last, 0, True, False),
    "kernel_folded": ((32, 16, 3, 3), torch.channels_last, 0, True, True),
    "kernel_1x1_folded_odd": ((9, 13, 1, 1), torch.channels_last, 0, True, True),
}


@pytest.mark.parametrize("wide", [0, 1], ids=["i32", "i64"])
@pytest.mark.parametrize("vec", [1, 0], ids=["vector", "scalar"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_matches_plain(emu, case, vec, wide):
    shape, fmt, axis, per_channel, fold = CASES[case]
    rs = np.random.RandomState(abs(hash(case)) % 2**31)
    v = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 3).contiguous(memory_format=fmt)
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32)).contiguous(memory_format=fmt)
    div = None
    if axis == 0:
        if fold:
            div = torch.from_numpy(rs.uniform(0.01, 0.2, shape[1]).astype(np.float32))
            v = (v * div.view(1, -1, 1, 1)).contiguous(memory_format=fmt)
        scale, bound = fq.weight_scale_bound(v)
    else:
        c = shape[1]
        scale = torch.from_numpy((rs.uniform(0.005, 0.05, c) if per_channel else
                                  rs.uniform(0.005, 0.05, ())).astype(np.float32))
        bound = fq.act_bound(scale)
        sb = scale.view(1, -1, 1, 1) if per_channel else scale
        k = torch.from_numpy(rs.randint(-140, 141, shape).astype(np.float32))
        v = ((k + 0.5 * torch.from_numpy(rs.randint(0, 2, shape).astype(np.float32))) * sb
             ).contiguous(memory_format=fmt)
        if fmt == torch.contiguous_format:
            v.view(-1)[:3] = float("nan")
    want = fq.fake_quant_plain(v, scale, bound, axis, div)
    got = _emu_run(emu, v, None, scale, bound, axis, div, vec, wide, offset=0 if vec else 1)
    _assert_bits(got.numpy(), want.numpy(), "forward")
    want = fq.fake_quant_grad_plain(v, g, bound, axis, div)
    got = _emu_run(emu, v, g, None, bound, axis, div, vec, wide, offset=0 if vec else 1)
    _assert_bits(got.numpy(), want.numpy(), "backward")
    assert (want == 0.5 * (g if div is None else (g / div.view(1, -1, 1, 1)))).any() or \
        axis == 1
