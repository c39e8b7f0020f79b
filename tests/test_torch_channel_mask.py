"""The ChannelMask gate of the port (cocodet_tpu_torch/models/blocks.py) against
JAX's (cocodet_tpu/models/blocks.py:110-130, :412-413), on the CPU.

- The gate folded into the BN's vectors (``ChannelMask.fold``) against the
  explicit gate ``y * s + o * (1 - s)``: 0 elements differ, forward and
  backward (the input's, the conv kernel's and the BN scale's and bias's
  gradients), and the running statistics, in train and eval mode, f32 and
  bf16, with closed channels whose offsets are not zero. The explicit gate
  is applied after the activation, which an elementwise activation and a
  0/1 scale allow (act(z * s + o * (1 - s)) = act(z) * s + act(o) * (1 -
  s)), so that the unmasked BN+act is the same Function on the same inputs.
- A masked residual CSP layer, a masked head and the masked model against
  JAX's in f32, train and eval mode: rtol = atol = 1e-4 (XLA:CPU and
  oneDNN sum the convs in other orders; tests/test_torch_blocks.py), the
  gradients of a random cotangent 1e-3 relative to each gradient's largest
  value (BN in train mode divides by the batch's deviation).
- The masked model's flax layout, its distillation taps and their order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.models import blocks as jb
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.models.head import YOLOXHead as JaxHead
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.models import blocks as tb
from cocodet_tpu_torch.models.head import YOLOXHead
from cocodet_tpu_torch.utils.convert import (export_masks, flatten_tree, load_masks,
                                             load_variables, unflatten_tree)
from torch_port_utils import assert_close, nchw, nhwc, shared_variables

TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close_some(variables, seed, frac=0.4):
    """The variables with about ``frac`` of every gate closed (scale 0) and
    those channels' offsets drawn N(0, 0.5)."""
    rs = np.random.RandomState(seed)
    flat = flatten_tree(variables)
    for path in [p for p in flat if p[0] == "masks" and p[-1] == "scale"]:
        n = flat[path].shape[0]
        s = (rs.uniform(size=n) >= frac).astype(np.float32)
        s[0] = 1.0
        flat[path] = s
        flat[path[:-1] + ("offset",)] = (rs.normal(0, 0.5, n) * (1 - s)).astype(np.float32)
    return unflatten_tree(flat)


def _conv_bn_act(gate: bool, cin=6, cout=8):
    return tb.ConvBnAct(cin, cout, 3, 1, act="hard_swish", use_mask=gate)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_fold_equals_explicit_gate(dtype, mode):
    tdt = DTYPES[dtype]
    rs = np.random.RandomState(3)
    masked, plain = _conv_bn_act(True), _conv_bn_act(False)
    with torch.no_grad():
        kernel = torch.from_numpy(rs.normal(0, 0.3, (8, 6, 3, 3)).astype(np.float32))
        masked.conv.weight.copy_(kernel)
        plain.conv.weight.copy_(kernel)
        w, b = rs.uniform(0.5, 1.5, 8), rs.normal(0, 0.5, 8)
        mean, var = rs.normal(0, 0.2, 8), rs.uniform(0.5, 1.5, 8)
        for m in (masked, plain):
            m.bn.weight.copy_(torch.tensor(w))
            m.bn.bias.copy_(torch.tensor(b))
            m.bn.running_mean.copy_(torch.tensor(mean))
            m.bn.running_var.copy_(torch.tensor(var))
        s = torch.tensor([1, 0, 1, 0, 0, 1, 1, 0], dtype=torch.float32)
        o = torch.from_numpy(rs.normal(0, 1.0, 8).astype(np.float32)) * (1 - s)
        masked.mask.scale.copy_(s)
        masked.mask.offset.copy_(o)
    for m in (masked, plain):
        m.to(memory_format=torch.channels_last).train(mode == "train")
    x = nchw(rs.normal(0, 2, (2, 7, 7, 6)).astype(np.float32), tdt)
    g = nchw(rs.normal(0, 1, (2, 7, 7, 8)).astype(np.float32), tdt)
    xs = [x.clone().requires_grad_(), x.clone().requires_grad_()]

    y = masked(xs[0])
    s4, o4 = s.view(1, -1, 1, 1).to(tdt), o.view(1, -1, 1, 1)
    const = tb.hard_swish(o4.to(tdt))  # act(T(o)): the gated BN output, activated
    ref = plain(xs[1]) * s4 + const * (1 - s4)
    assert torch.equal(y, ref)
    (y * g).sum().backward()
    (ref * g).sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    for name in ("conv.weight", "bn.weight", "bn.bias"):
        got = masked.get_parameter(name).grad
        want = plain.get_parameter(name).grad
        assert torch.equal(got, want), name
    assert (masked.bn.weight.grad[s == 0] == 0).all() and (masked.bn.bias.grad[s == 0] == 0).all()
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(masked.bn, name), getattr(plain.bn, name))


def test_gate_after_a_fused_conv_matches_jax():
    """A fused (BN-free) ConvBnAct with use_mask applies the gate itself."""
    x = np.random.RandomState(0).normal(0, 1, (2, 6, 6, 5)).astype(np.float32)
    jm = jb.ConvBnAct(7, 3, 1, act="hard_swish", fused=True, use_mask=True)
    pm = tb.ConvBnAct(5, 7, 3, 1, act="hard_swish", fused=True, use_mask=True)
    variables = close_some(shared_variables(jm, pm, x), 1)
    load_variables(pm, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(pm.eval()(nchw(x)))
    assert_close(got, want, **TOL)


def _grads_close(got, want, rel=1e-3):
    for k, w in flatten_tree(want).items():
        w = np.asarray(w)
        assert_close(got[k], w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-6))


def _jax_and_port(jm, pm, x, variables, train):
    """(output, grads of the params or None) of both on a random cotangent."""
    g = np.random.RandomState(7).normal(0, 1, np.shape(jm.apply(
        variables, jnp.asarray(x), train=False))).astype(np.float32)
    load_variables(pm, variables)
    pm.train(train)
    if not train:
        want = np.asarray(jm.apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            return nhwc(pm(nchw(x))), want, None, None

    def f(params):
        y, _ = jm.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
        return y

    want, vjp = jax.vjp(f, variables["params"])
    (jgrads,) = vjp(jnp.asarray(g))
    y = pm(nchw(x))
    (y * nchw(g)).sum().backward()
    from cocodet_tpu_torch.utils.convert import export_tensors

    pgrads = export_tensors({n: p.grad for n, p in pm.named_parameters()})["params"]
    return nhwc(y), np.asarray(want), flatten_tree(pgrads), jax.tree_util.tree_map(
        np.asarray, jgrads)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_masked_residual_csp_matches_jax(mode):
    x = np.random.RandomState(1).normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm = jb.CSPLayer(16, n=2, shortcut=True, custom=True, act="hard_swish", use_mask=True)
    pm = tb.CSPLayer(16, 16, n=2, shortcut=True, custom=True, act="hard_swish", use_mask=True)
    variables = close_some(shared_variables(jm, pm, x), 2)
    # conv1 leads the residual group; conv3 is never gated
    assert "mask" in variables["masks"]["conv1"] and "conv3" not in variables["masks"]
    got, want, pg, jg = _jax_and_port(jm, pm, x, variables, mode == "train")
    assert_close(got, want, **TOL)
    if pg is not None:
        _grads_close(pg, jg)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_masked_head_matches_jax(mode):
    rs = np.random.RandomState(4)
    xs = [rs.normal(0, 1, (2, 8 >> k, 8 >> k, c)).astype(np.float32)
          for k, c in enumerate((16, 24))]
    jm = JaxHead(num_classes=3, width=0.125, num_levels=2, use_mask=True)
    pm = YOLOXHead((16, 24), num_classes=3, width=0.125, use_mask=True)
    jvars = jax.eval_shape(jm.init, jax.random.PRNGKey(0), [jnp.asarray(a) for a in xs])
    from flax.traverse_util import flatten_dict

    from cocodet_tpu_torch.utils.convert import jax_layout, random_variables

    assert jax_layout(pm) == {k: tuple(v.shape) for k, v in flatten_dict(jvars).items()}
    variables = close_some(random_variables(pm, 3), 5)
    load_variables(pm, variables)
    pm.train(mode == "train")
    if mode == "train":
        outs, _ = jm.apply(variables, [jnp.asarray(a) for a in xs], train=True,
                           mutable=["batch_stats"])
    else:
        outs = jm.apply(variables, [jnp.asarray(a) for a in xs])
    with torch.no_grad():
        got = pm([nchw(a) for a in xs])
    for o, w in zip(got, outs):
        for key in ("reg", "obj", "cls"):
            assert_close(o[key].numpy(), np.asarray(w[key]), **TOL)


@pytest.fixture(scope="module")
def masked_small():
    x = np.random.RandomState(0).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jm = jax_build("yolox-p6", depth=0.33, width=0.125, use_mask=True)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, use_mask=True)
    from cocodet_tpu_torch.models import build_model
    from cocodet_tpu_torch.utils.convert import random_variables

    variables = close_some(random_variables(shapes, 0), 6)
    pm = build_model("yolox-p6", depth=0.33, width=0.125, device="cpu", use_mask=True,
                     variables=variables)
    return jm, pm, variables, x


def test_masked_model_taps_match_jax(masked_small):
    """return_taps: the backbone's 4 maps, the 2 deepest top-down maps and
    the 4 outputs, in JAX's order and values (eval mode); 9 distill taps."""
    from cocodet_tpu.models.distill import taps_to_distill_list as jax_list
    from cocodet_tpu_torch.models.distill import taps_to_distill_list

    jm, pm, variables, x = masked_small
    want_maps, want_taps = jm.apply(variables, jnp.asarray(x), return_taps=True)
    with torch.no_grad():
        got_maps, got_taps = pm(torch.from_numpy(x), return_taps=True)
    assert [len(got_taps[k]) for k in ("backbone", "td", "pan")] == [4, 2, 4]
    got_list, want_list = taps_to_distill_list(got_taps), jax_list(want_taps)
    assert len(got_list) == len(want_list) == 9
    for g, w in zip(got_list, want_list):
        assert_close(nhwc(g), np.asarray(w), rtol=1e-3, atol=1e-3)
    for g, w in zip(got_maps, want_maps):
        assert_close(g["cls"].numpy(), np.asarray(w["cls"]), rtol=1e-3, atol=1e-3)


def test_masks_export_and_load(masked_small):
    """export_masks/load_masks round trip; a conv_mask leaf is skipped."""
    _, pm, variables, _ = masked_small
    masks = export_masks(pm)
    assert flatten_tree(masks).keys() == flatten_tree(variables["masks"]).keys()
    for k, v in flatten_tree(variables["masks"]).items():
        np.testing.assert_array_equal(flatten_tree(masks)[k], v)
    flat = flatten_tree(masks)
    key = next(k for k in flat if k[-1] == "scale")
    flat[key] = np.zeros_like(flat[key])
    flat[("backbone", "backbone", "stem", "conv", "conv", "conv_mask")] = np.ones((3, 3, 12, 8))
    load_masks(pm, unflatten_tree(flat))
    assert not flatten_tree(export_masks(pm))[key].any()
    load_masks(pm, variables["masks"])
