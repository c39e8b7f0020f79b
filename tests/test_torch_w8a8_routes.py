"""The int8 conv's last w8a8 routes (cocodet_tpu_torch/ops/cuda/int8_conv.py,
models/blocks.py::Conv2d) against the JAX package, on the CPU, where the
kernel wrappers take their plain versions:

- split-concat parts (cocodet_tpu/models/blocks.py:258-276): a w8a8
  ``ConvBnAct`` with hard-swish on parts, ``up2x`` ones included, against
  JAX's, and its s32 sums against the conv of the materialized concat;
- the w8a8 latency graph (``stem6`` + ``split_cat``) of YOLOX-P6 at depth
  0.33, width 0.125, 128 px, B=2, quantized by JAX (per-channel activation
  scales, the Focus stem per-tensor): every w8a8 conv's output against
  JAX's (``capture_intermediates``) and its head maps, and against the
  port's own plain w8a8 graph of the same tree;
- ``fold_focus_quant`` leaf for leaf, and a per-channel stem scale, which
  both packages refuse;
- a height slab with its halo rows (``padding=(0, pad)``, as
  ``Conv2d._forward_sharded`` hands it) against the whole map.

Tolerances: every int8 result is exact (s32 sums, and the f32 and bf16
outputs of an int8 conv: the same integers through the same roundings), the
JAX model run op by op (under ``jax.jit`` XLA:CPU does not divide by IEEE
division; tests/test_torch_headline.py). The latency graph's head maps
against JAX's within 1e-5 * (1 + |v|): its float prediction convs sum in
another order (tests/test_torch_headline.py); against the port's plain
graph they are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import build_quant_tree as jax_build_quant_tree
from cocodet_tpu.compress import quantize_weights as jax_quantize_weights
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.models.blocks import ConvBnAct as JaxConvBnAct
from cocodet_tpu.ops import fuse as jfuse
from cocodet_tpu_torch.entry import fold_w8a8_stem
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.models.blocks import Conv2d, ConvBnAct
from cocodet_tpu_torch.ops.cuda import int8_conv as ic
from cocodet_tpu_torch.ops.fuse import fold_focus_quant
from cocodet_tpu_torch.utils.convert import flatten_tree, load_variables, random_variables
from torch_port_utils import nchw, nhwc

ARCH = dict(depth=0.33, width=0.125)
SIZE = 128


def _parts(spec, b, h, w, seed):
    """NHWC numpy parts (an up2x one at half resolution) and their NCHW
    channels-last torch views."""
    rs = np.random.RandomState(seed)
    arrays = [((rs.rand(b, h // 2 if up else h, w // 2 if up else w, c) * 60 - 20)
               .astype(np.float32), up) for c, up in spec]
    return arrays, [(nchw(a), up) for a, up in arrays]


PARTS = {"td merge": ((16, True), (8, False)), "bu merge": ((8, False), (16, False)),
         "spp": ((8, False),) * 4, "all up2x": ((8, True), (4, True)),
         "ragged": ((12, False), (4, True), (16, False))}


@pytest.mark.parametrize("vector", [False, True], ids=["per-tensor", "per-channel"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(PARTS))
def test_parts_conv_matches_jax(name, dtype, vector):
    """A w8a8 ConvBnAct (1x1, hard-swish) on split-concat parts: the port's
    output equals JAX's, and its s32 sums equal the conv of the concat."""
    spec = PARTS[name]
    cin, o = sum(c for c, _ in spec), 24
    arrays, parts = _parts(spec, 2, 8, 12, seed=len(name))
    rs = np.random.RandomState(7)
    variables = {
        "params": {"conv": {"kernel": rs.randint(-127, 128, (1, 1, cin, o)).astype(np.int8),
                            "bias": (rs.rand(o) * 2 - 1).astype(np.float32)}},
        "quant": {"conv": {"w_scale": (rs.rand(o) * 1e-2 + 1e-3).astype(np.float32),
                           "act_scale": (rs.rand(cin) * 0.3 + 0.05).astype(np.float32)
                           if vector else np.float32(0.2)}}}
    jm = JaxConvBnAct(o, 1, act="hard_swish", fused=True, quant="w8a8", dtype=dtype)
    want = jm.apply(variables, [(jnp.asarray(a), up) for a, up in arrays])
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    port = ConvBnAct(cin, o, 1, act="hard_swish", fused=True, quant="w8a8")
    load_variables(port, variables)
    got = port(parts, tdtype)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(nhwc(got), np.asarray(want, np.float32))

    conv = port.conv
    bias = conv.bias.detach().to(tdtype)
    y, acc = ic.int8_conv_parts_acc(parts, conv.weight, conv.act_scale, conv.w_scale, bias,
                                    dtype=tdtype, act="hard_swish")
    concat = torch.cat([torch.nn.functional.interpolate(p, scale_factor=2.0) if up else p
                        for p, up in parts], dim=1)
    acc_concat = ic.int8_conv_acc_plain(ic.quantize_activations(concat, conv.act_scale),
                                        conv.weight)
    assert acc.dtype == torch.int32 and torch.equal(acc, acc_concat)
    assert torch.equal(y, got)
    assert torch.equal(y, ic.conv2d_w8a8_plain(concat, conv.weight, conv.act_scale,
                                               conv.w_scale, bias, dtype=tdtype,
                                               act="hard_swish"))


@pytest.fixture(scope="module")
def quantized():
    """(NHWC images, the JAX package's w8a8 quantization of numpy seed 3
    fused YOLOX-P6 weights, calibrated with the jitted calib model on 2
    random images, per-channel activation scales)."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, **ARCH)
    variables = random_variables(shapes, 3)
    calib = jax_build_model("yolox-p6", fused=True, quant="calib", **ARCH)
    images = (np.random.RandomState(1).rand(2, SIZE, SIZE, 3) * 255).astype(np.float32)
    _, stats = jax.jit(lambda v, x: calib.apply(v, x, mutable=["quant_stats"]))(
        variables, jnp.asarray(images))
    qtree = jax_build_quant_tree(stats["quant_stats"], per_channel_act=True)
    qvars, quant = jax_quantize_weights(variables, qtree)
    qvars["quant"] = quant
    x = (np.random.RandomState(2).rand(2, SIZE, SIZE, 3) * 255).astype(np.float32)
    return x, jax.tree_util.tree_map(np.asarray, qvars)


def _hooked(model):
    """The outputs of every w8a8 conv of ``model`` in a forward, by module
    name, with their inputs."""
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and m.quant == "w8a8":
            m.register_forward_hook(
                lambda mod, args, out, name=name: seen.__setitem__(name, (args[0], out)))
    return seen


def test_latency_graph_matches_jax_and_plain(quantized):
    x, qvars = quantized
    folded = {"params": jfuse.fold_focus_stem(qvars["params"]),
              "quant": jfuse.fold_focus_quant(qvars["quant"])}
    jm = jax_build_model("yolox-p6", fused=True, quant="w8a8", stem6=True, split_cat=True,
                         **ARCH)
    want, state = jm.apply(folded, jnp.asarray(x), capture_intermediates=True,
                           mutable=["intermediates"])
    inter = {k[:-1]: v[0] for k, v in flatten_dict(state["intermediates"]).items()}

    latency = build_model("yolox-p6", fused=True, quant="w8a8", stem6=True, split_cat=True,
                          device="cpu", variables=fold_w8a8_stem(qvars), **ARCH)
    plain = build_model("yolox-p6", fused=True, quant="w8a8", device="cpu", variables=qvars,
                        **ARCH)
    seen = _hooked(latency)
    with torch.no_grad():
        got = latency(torch.from_numpy(x))
        ref = plain(torch.from_numpy(x))

    # every w8a8 conv equals JAX's (the ConvBnAct's output where the conv
    # applies the hard-swish in its epilogue), and a parts conv's s32 sums
    # equal the conv of its concat
    n_parts = 0
    for name, (inp, out) in seen.items():
        path = tuple(name.split("."))
        owner = latency.get_submodule(name[: -len(".conv")])
        key = path[:-1] if getattr(owner, "act_in_conv", False) else path
        np.testing.assert_array_equal(nhwc(out), np.asarray(inter[key], np.float32),
                                      err_msg=name)
        if isinstance(inp, (list, tuple)):
            n_parts += 1
            conv = latency.get_submodule(name)
            _, acc = ic.int8_conv_parts_acc(inp, conv.weight, conv.act_scale, conv.w_scale,
                                            None)
            concat = torch.cat([torch.nn.functional.interpolate(p, scale_factor=2.0)
                                if isinstance(q, tuple) and q[1] else p
                                for q in inp for p in [q[0] if isinstance(q, tuple) else q]],
                               dim=1)
            assert torch.equal(acc, ic.int8_conv_acc_plain(
                ic.quantize_activations(concat, conv.act_scale), conv.weight)), name
    assert n_parts == 24 and ("backbone", "backbone", "stem", "conv") in inter

    for g, r, w in zip(got, ref, want):
        for k in ("reg", "obj", "cls"):
            assert torch.equal(g[k], r[k]), k
            wk = np.asarray(w[k], np.float32)
            np.testing.assert_allclose(g[k].numpy(), wk, rtol=1e-5, atol=1e-5)


def test_latency_graph_bf16_equals_plain(quantized):
    """In bf16 too, the w8a8 latency graph is the plain graph bit for bit
    (its parts sum in s32, before the one epilogue)."""
    x, qvars = quantized
    latency = build_model("yolox-p6", fused=True, quant="w8a8", stem6=True, split_cat=True,
                          device="cpu", variables=fold_w8a8_stem(qvars), dtype=torch.bfloat16,
                          **ARCH)
    plain = build_model("yolox-p6", fused=True, quant="w8a8", device="cpu", variables=qvars,
                        dtype=torch.bfloat16, **ARCH)
    with torch.no_grad():
        got, ref = latency(torch.from_numpy(x)), plain(torch.from_numpy(x))
    for g, r in zip(got, ref):
        for k in ("reg", "obj", "cls"):
            assert g[k].dtype == torch.bfloat16 and torch.equal(g[k], r[k]), k


def test_fold_focus_quant_matches_jax(quantized):
    _, qvars = quantized
    got = flatten_tree(fold_focus_quant(qvars["quant"]))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                               jfuse.fold_focus_quant(qvars["quant"])))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        assert np.shape(got[path]) == np.shape(v), path
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    stem = ("backbone", "backbone", "stem", "conv")
    assert stem + ("act_scale",) in want and stem + ("conv", "act_scale") not in want


def test_per_channel_stem_scale_raises(quantized):
    """A per-channel act_scale on the Focus stem (12 scales, which no
    quantize_model writes) does not fit the 6x6 stem's 3 channels: JAX's
    w8a8 conv fails to broadcast it; the port refuses it at the fold."""
    x, qvars = quantized
    quant = jax.tree_util.tree_map(np.asarray, qvars["quant"])
    quant["backbone"]["backbone"]["stem"]["conv"]["conv"]["act_scale"] = np.full(
        12, 0.2, np.float32)
    folded = {"params": jfuse.fold_focus_stem(qvars["params"]),
              "quant": jfuse.fold_focus_quant(quant)}
    jm = jax_build_model("yolox-p6", fused=True, quant="w8a8", stem6=True, **ARCH)
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        jm.apply(folded, jnp.asarray(x[:1]))
    with pytest.raises(ValueError, match="broadcast"):
        fold_focus_quant(quant)


SLABS = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (6, 2, 2)]


@pytest.mark.parametrize("rows", [(8, 8), (12, 4), (4, 8, 4)], ids=["even", "uneven", "three"])
@pytest.mark.parametrize("k,stride,pad", SLABS, ids=[f"k{k}s{s}" for k, s, _ in SLABS])
def test_slab_matches_whole_map(k, stride, pad, rows):
    """conv2d_w8a8 (its plain version here) on each rank's slab with the
    halo rows Conv2d._halo gathers (zeros past the map's edge) and padding
    (0, pad) writes that rank's output rows of the whole map's conv."""
    c, o = (3, 16) if k == 6 else (16, 24)
    rs = np.random.RandomState(k * 10 + stride)
    h, w = sum(rows), 12
    x = torch.from_numpy((rs.rand(2, c, h, w) * 60 - 20).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    weight = torch.from_numpy(rs.randint(-127, 128, (o, c, k, k)).astype(np.int8)).contiguous(
        memory_format=torch.channels_last)
    act = torch.tensor(0.17)
    w_scale = torch.from_numpy((rs.rand(o) * 1e-2).astype(np.float32))
    bias = torch.from_numpy(rs.rand(o).astype(np.float32))
    whole = ic.conv2d_w8a8(x, weight, act, w_scale, bias, stride, pad, act="hard_swish")
    reach = k - 1
    top, bottom = pad, max(0, reach - pad - stride + 1)
    padded = torch.nn.functional.pad(x, (0, 0, top, bottom))
    outs, start = [], 0
    for r in rows:
        slab = padded[:, :, start:start + r + top + bottom].contiguous(
            memory_format=torch.channels_last)
        outs.append(ic.conv2d_w8a8(slab, weight, act, w_scale, bias, stride, (0, pad),
                                   act="hard_swish"))
        start += r
    assert torch.equal(torch.cat(outs, dim=2), whole)


def test_int8_layers_on_space_ranks():
    """Height-sharded int8 layers on 2 gloo ranks (tests/torch_dist_utils.py::
    quant_layers_rank): every w8a8 route's output on a rank's slab equals
    its rows of the whole map's, bit for bit; a calib conv's act_absmax
    (its parts' too) is the whole map's, its max over the space group."""
    from cocodet_tpu_torch.parallel.launch import run_ranks
    from torch_dist_utils import quant_layers_rank

    results = run_ranks(quant_layers_rank, 2, device="cpu", timeout=300)
    for res in results:
        assert len(res) == 7
        for name, (out_err, absmax_err) in res.items():
            assert out_err == 0.0 and absmax_err == 0.0, (name, out_err, absmax_err)
