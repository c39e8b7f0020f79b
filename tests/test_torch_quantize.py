"""Port parity: int8 PTQ (cocodet_tpu_torch/compress/quantize.py) and the
w8a8 conv (models/blocks.py Conv2d, ops/cuda/int8_conv.py) against
cocodet_tpu's compress/quantize.py and blocks.py:248-283.

Tolerances:
- calibration statistics in f32: rtol = atol = 1e-4 relative to each
  conv's largest absmax. They are maxima of activations, which XLA:CPU and
  oneDNN compute with another summation order (tests/test_torch_model.py);
- the quant tree and the quantized weights, on the same statistics: equal
  bit for bit (both are the same numpy math);
- a w8a8 conv: the quantized inputs, the s32 accumulators and the f32
  outputs equal bit for bit; bf16 outputs within 1 bf16 ulp, since XLA
  may keep excess precision across the ``astype`` before the bias add;
- a w8a8 ConvBnAct with hard-swish (the conv applies it in its epilogue)
  against the JAX module run op by op (``apply``): equal bit for bit in f32
  and in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import build_quant_tree as jax_build_quant_tree
from cocodet_tpu.compress import calibrate as jax_calibrate
from cocodet_tpu.compress import quantization_report as jax_quantization_report
from cocodet_tpu.compress import quantize_weights as jax_quantize_weights
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.models.blocks import Conv2d as JaxConv2d
from cocodet_tpu.models.blocks import ConvBnAct as JaxConvBnAct
from cocodet_tpu.models.blocks import Focus as JaxFocus
from cocodet_tpu_torch.compress import (build_quant_tree, calibrate, quantization_report,
                                        quantize_model, quantize_weights)
from cocodet_tpu_torch.models import build_model
from cocodet_tpu_torch.models.blocks import Conv2d, ConvBnAct, Focus
from cocodet_tpu_torch.ops.cuda import int8_conv as ic
from cocodet_tpu_torch.utils.convert import load_variables, random_variables
from torch_port_utils import SMALL_ARCH, images, shared_variables


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _assert_trees_equal(got, want):
    g, w = _np_tree(got), _np_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        assert np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def calibrated():
    """Calibration of the fused d0.33/w0.25 p6 in f32 on two 64 px images,
    by both packages on the same variables."""
    x = images(64)
    jm = jax_build_model("yolox-p6", fused=True, quant="calib", **SMALL_ARCH)
    tm = build_model("yolox-p6", fused=True, quant="calib", device="cpu", **SMALL_ARCH)
    variables = shared_variables(jm, tm, x, seed=11)  # also checks the quant_stats layout
    want = jax_calibrate(jm, variables, [jnp.asarray(x)])
    got = calibrate(tm, variables, [x[:1], x[1:]])  # max-reduced over two batches
    return variables, got, jax.tree_util.tree_map(np.asarray, want), tm, jm


def _assert_stats_close(got, want):
    g, w = _np_tree(got), _np_tree(want)
    assert g.keys() == w.keys() and len(w) == 97
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == np.float32
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4 * w[k].max())


def test_calibrate_matches_jax(calibrated):
    _, got, want, _, _ = calibrated
    _assert_stats_close(got, want)


def test_calibrate_restarts_from_zero(calibrated):
    """A second calibration of the same model forgets the first one's maxima."""
    variables, got, _, tm, jm = calibrated
    small = images(64, batch=1, seed=5) * 0.5
    again = calibrate(tm, variables, [small])
    _assert_stats_close(again, jax_calibrate(jm, variables, [jnp.asarray(small)]))
    stem = ("backbone", "backbone", "stem", "conv", "conv", "act_absmax")
    assert _np_tree(again)[stem].max() < 0.75 * _np_tree(got)[stem].max()


@pytest.mark.parametrize("per_channel", [False, True])
def test_build_quant_tree_matches_jax(calibrated, per_channel):
    _, _, stats, _, _ = calibrated
    got = build_quant_tree(stats, per_channel_act=per_channel)
    _assert_trees_equal(got, jax_build_quant_tree(stats, per_channel_act=per_channel))
    stem = got["backbone"]["backbone"]["stem"]["conv"]["conv"]["act_scale"]
    assert stem.shape == ()  # the Focus stem stays per-tensor
    lateral = got["backbone"]["lateral1"]["conv"]["act_scale"]
    assert lateral.shape == ((lateral.size,) if per_channel else ())


@pytest.mark.parametrize("bits,per_channel,keep", [
    (8, False, {}), (8, True, {}), (4, False, {}), (4, True, {}),
    (4, True, dict(w8_keep_patterns=("head/",), w8_keep_frac=0.2)),
])
def test_quantize_weights_matches_jax(calibrated, bits, per_channel, keep):
    variables, _, stats, _, _ = calibrated
    qtree = jax_build_quant_tree(stats, per_channel_act=per_channel)
    jvars, jquant = jax_quantize_weights(variables, qtree, bits=bits, **keep)
    tvars, tquant = quantize_weights(variables, jax.tree_util.tree_map(np.asarray, qtree),
                                     bits=bits, **keep)
    _assert_trees_equal(tvars["params"], jvars["params"])
    _assert_trees_equal(tquant, jquant)
    report = quantization_report({**tvars, "quant": tquant}, bits=bits)
    assert report == jax_quantization_report({**jvars, "quant": jquant}, bits=bits)
    assert report["quantized_convs"] == 97


def test_quantize_model_loads_into_w8a8(calibrated):
    variables, _, _, tm, _ = calibrated
    qvars = quantize_model(tm, variables, [images(64)], per_channel_act=True)
    q = build_model("yolox-p6", fused=True, quant="w8a8", device="cpu",
                    variables=qvars, **SMALL_ARCH)
    conv = q.backbone.lateral1.conv
    assert conv.weight.dtype == torch.int8 and conv.act_scale.shape == (conv.weight.shape[1],)
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert q.backbone.backbone.stem.conv.conv.act_scale.shape == ()
    # a w4a8 tree (int8 runtime type; its w_bits leaves say how to pack it) loads too
    q4 = quantize_model(tm, variables, [images(64)], bits=4)
    load_variables(q, q4)
    assert int(q.backbone.lateral1.conv.weight.abs().max()) <= 7
    with pytest.raises(TypeError, match="int8"):  # an int8 kernel needs quant="w8a8"
        build_model("yolox-p6", fused=True, device="cpu",
                    variables={"params": qvars["params"]}, **SMALL_ARCH)


def _conv_case(k, cin, vec, seed):
    rs = np.random.RandomState(seed)
    cout = 48
    return {"params": {"kernel": rs.randint(-127, 128, (k, k, cin, cout)).astype(np.int8),
                       "bias": rs.uniform(-1, 1, (cout,)).astype(np.float32)},
            "quant": {"w_scale": rs.uniform(1e-3, 1e-2, (cout,)).astype(np.float32),
                      "act_scale": (rs.uniform(0.05, 0.4, (cin,)).astype(np.float32) if vec
                                    else np.float32(0.2137))}}


@pytest.mark.parametrize("vec", [False, True], ids=["scalar_act", "vector_act"])
@pytest.mark.parametrize("k,stride,cin,act", [(1, 1, 64, None), (3, 1, 64, None),
                                              (3, 2, 64, None), (3, 1, 12, None),
                                              (3, 1, 64, "hard_swish")],
                         ids=["1x1s1", "3x3s1", "3x3s2", "cin12", "3x3s1_hard_swish"])
def test_w8a8_conv_matches_jax(k, stride, cin, act, vec):
    """The w8a8 conv against JAX's, and with act="hard_swish" against
    jax.nn.hard_swish of it, both run op by op: exact in f32 and, for the
    activation, in bf16 too."""
    variables = _conv_case(k, cin, vec, seed=k * 100 + stride * 10 + cin + vec)
    cout = variables["quant"]["w_scale"].shape[0]
    x = np.random.RandomState(cin).uniform(-20, 60, (2, 13, 11, cin)).astype(np.float32)
    tm = Conv2d(cin, cout, k, stride, use_bias=True, quant="w8a8").to(
        memory_format=torch.channels_last)
    load_variables(tm, variables)
    pad = (k - 1) // 2
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x).astype(jdt)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
        a = jnp.asarray(variables["quant"]["act_scale"])
        xq_want = jnp.clip(jnp.round(xj.astype(jnp.float32) / a), -127, 127)
        acc_want = jax.lax.conv_general_dilated(
            xq_want.astype(jnp.int8), jnp.asarray(variables["params"]["kernel"]),
            (stride, stride), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
        want = JaxConv2d(cout, k, stride, use_bias=True, quant="w8a8", dtype=jdt).apply(
            variables, xj)
        if act:
            want = jax.nn.hard_swish(want)
        xq = ic.quantize_activations(xt, tm.act_scale)
        y, acc = ic.int8_conv_acc(xt, tm.weight, tm.act_scale, tm.w_scale,
                                  tm.bias.detach(), stride, pad, dtype=tdt, act=act)
        with torch.no_grad():
            got = tm(xt, act=act)
        assert got.dtype == tdt and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, y)
        nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float().numpy()  # noqa: E731
        assert np.array_equal(nhwc(xq), np.asarray(xq_want))
        assert np.array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(acc_want))
        g, w = nhwc(got), np.asarray(want.astype(jnp.float32))
        if tdt == torch.float32 or act:
            assert np.array_equal(g, w)
        else:  # 1 bf16 ulp: 2^-7 of the value's binade
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert (np.abs(g - w) <= ulp).all()
        assert np.abs(np.asarray(xq_want)).max() == 127  # the clamp is exercised


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vec", [False, True], ids=["scalar_act", "vector_act"])
@pytest.mark.parametrize("k,stride,cin", [(1, 1, 64), (3, 1, 64), (3, 2, 64), (3, 1, 12)],
                         ids=["1x1s1", "3x3s1", "3x3s2", "cin12"])
def test_w8a8_conv_bn_act_hard_swish_matches_jax(k, stride, cin, vec, dtype):
    """The fused w8a8 ConvBnAct with hard-swish: the port's conv applies the
    activation in its epilogue (no separate pass), and the output equals
    the JAX module's, run op by op, bit for bit."""
    variables = _conv_case(k, cin, vec, seed=k * 100 + stride * 10 + cin + vec)
    cout = variables["params"]["bias"].shape[0]
    x = np.random.RandomState(cin + 1).uniform(-20, 60, (2, 13, 11, cin)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    wrapped = {c: {"conv": v} for c, v in variables.items()}
    xj = jnp.asarray(x).astype(jdt)
    want = JaxConvBnAct(cout, k, stride, act="hard_swish", fused=True, quant="w8a8",
                        dtype=jdt).apply(wrapped, xj)
    tm = ConvBnAct(cin, cout, k, stride, act="hard_swish", fused=True, quant="w8a8").to(
        memory_format=torch.channels_last)
    load_variables(tm, wrapped)
    assert tm.act_in_conv
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(xt)
    assert got.dtype == tdt
    g = got.permute(0, 2, 3, 1).float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape and np.array_equal(g, w)
    assert (w == 0).mean() > 0.1 and (w < 0).any()  # both sides of the bend


def test_bf16_division_by_six_is_a_multiply():
    """The int8 conv's bf16 epilogue computes hard-swish's r / 6 as
    r * f32(1/6): for every bf16 r in [0, 6] (what the clamp leaves) both,
    rounded to bf16, are the same value."""
    r = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    r = torch.from_numpy(r[(r >= 0) & (r <= 6)])
    divided = (r / torch.tensor(6.0)).to(torch.bfloat16)
    multiplied = (r * float(np.float32(1 / 6))).to(torch.bfloat16)
    assert r.numel() == 16578
    assert torch.equal(divided.view(torch.int16), multiplied.view(torch.int16))


def _brute_force_quantized(x_shape, w_shape, stride):
    """Activation elements the kernel quantizes, counted block by block from
    the input positions that its output pixels' taps read."""
    plan = ic.tile_plan(x_shape, w_shape, stride)
    b, c, h, w = x_shape
    o, _, k, _ = w_shape
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    rows, cols = 8 * plan.mb, ic.TILE_W
    total = 0
    for r0 in range(0, ho, rows):
        for c0 in range(0, wo, cols):
            read = {((r0 + i) * stride - pad + dr, (c0 + j) * stride - pad + dc)
                    for i in range(rows) for j in range(cols)
                    for dr in range(k) for dc in range(k)}
            total += len(read) * -(-c // ic.CHUNK) * ic.CHUNK * -(-o // plan.n)
    return b * total


@pytest.mark.parametrize("x_shape,w_shape,stride", [
    ((2, 48, 21, 19), (40, 48, 3, 3), 1), ((1, 12, 17, 30), (32, 12, 3, 3), 2),
    ((3, 96, 9, 10), (200, 96, 1, 1), 1), ((1, 64, 40, 40), (96, 64, 3, 3), 1)])
def test_quantized_elements_matches_brute_force(x_shape, w_shape, stride):
    plan = ic.tile_plan(x_shape, w_shape, stride)
    assert plan.n % 32 == 0 and plan.n <= ic.MAX_N and plan.n * plan.slices >= w_shape[0]
    assert ic.quantized_elements(x_shape, w_shape, stride) == \
        _brute_force_quantized(x_shape, w_shape, stride)


def test_headline_quantizes_each_activation_less_than_twice():
    """Summed over the 127 w8a8 convs of the slim YOLOX-M-P6 at a batch of
    16 640 px images (shapes from a forward at 64 px, scaled by 10), the
    kernel quantizes at most twice the activation elements they read."""
    from cocodet_tpu_torch.compress import load_slim_spec
    from cocodet_tpu_torch.entry import SLIM_SPEC
    from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX

    slim = load_slim_spec(str(SLIM_SPEC))
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75, fused=True, slim=slim)
    model = build_model("yolox-p6", depth=0.67, width=0.75, fused=True, slim=slim,
                        device="cpu", variables=random_variables(shapes, 0))
    convs = []
    for name, m in model.named_modules():
        if isinstance(m, Conv2d) and "_pred" not in name:
            m.register_forward_hook(lambda mod, a, out: convs.append(
                (a[0].shape, mod.weight.shape, mod.stride)))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    assert len(convs) == 127
    quantized = read = 0
    for (_, c, h, w), w_shape, stride in convs:
        x_shape = (16, c, 10 * h, 10 * w)
        quantized += ic.quantized_elements(x_shape, w_shape, stride)
        read += int(np.prod(x_shape))
    assert quantized <= 2 * read, quantized / read


def test_w8a8_conv_rejects_what_the_kernel_cannot_take():
    """The plain version takes any conv; the kernel wrapper refuses, before
    it looks for a card, the convs the kernel does not compute."""
    x = torch.zeros((1, 8, 5, 5)).to(memory_format=torch.channels_last)
    w = torch.zeros((8, 8, 5, 5), dtype=torch.int8).to(memory_format=torch.channels_last)
    one, ws = torch.ones(()), torch.ones(8)
    assert ic.conv2d_w8a8(x, w, one, ws, None, 1, 2).shape == (1, 8, 5, 5)
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        ic._launch(x.to("meta"), w.to("meta"), one, ws, None, 1, 2, 1, 1, torch.float32, False)


def test_w8a8_conv_kernel_refuses_other_acts_and_channels():
    """The kernel takes act None or "hard_swish", and C with C * the element
    size a multiple of 16 (x arrives by TMA) that is a multiple of 16 or at
    most 32: the wrapper refuses the rest before it looks for a card."""
    one = torch.ones(())
    for c, dtype in ((20, torch.bfloat16), (36, torch.float32)):
        cl = torch.channels_last
        x = torch.zeros((1, c, 5, 5), dtype=dtype).to("meta", memory_format=cl)
        w = torch.zeros((8, c, 3, 3), dtype=torch.int8).to("meta", memory_format=cl)
        with pytest.raises(ValueError, match="multiple of 16"):
            ic._launch(x, w, one, torch.ones(8), None, 1, 1, 1, 1, torch.float32, False)
    x = torch.zeros((1, 16, 5, 5)).to("meta", memory_format=torch.channels_last)
    w = torch.zeros((8, 16, 3, 3), dtype=torch.int8).to("meta", memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="hard_swish"):
        ic._launch(x, w, one, torch.ones(8), None, 1, 1, 1, 1, torch.float32, False, act="silu")
    with pytest.raises(ValueError, match="hard_swish"):
        ic.conv2d_w8a8(torch.zeros(1, 16, 5, 5), torch.zeros((8, 16, 3, 3), dtype=torch.int8),
                       one, torch.ones(8), None, 1, 1, act="silu")


def test_focus_stem_quantizes_the_f32_image():
    """A w8a8 Focus stem hands its conv the f32 image, as JAX does: the
    image rounded to bf16 first would quantize differently. A calib stem
    records the absmax of the f32 image."""
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 255, (2, 16, 16, 3)).astype(np.float32)
    variables = _conv_case(3, 12, False, seed=5)
    jf = JaxFocus(48, 3, act="identity", fused=True, quant="w8a8", order="pixel_unshuffle",
                  dtype=jnp.bfloat16)
    want = jf.apply({c: {"conv": {"conv": v}} for c, v in variables.items()}, jnp.asarray(x))
    tf = Focus(3, 48, 3, act="identity", order="pixel_unshuffle", fused=True, quant="w8a8").to(
        memory_format=torch.channels_last)
    load_variables(tf, {c: {"conv": {"conv": v}} for c, v in variables.items()})
    with torch.no_grad():
        got = tf(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    g, w = got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert (np.abs(g - w) <= ulp).all()
    a = torch.tensor(np.float32(0.2137))
    xt = torch.from_numpy(x)
    assert not torch.equal(ic.quantize_activations(xt, a),
                           ic.quantize_activations(xt.to(torch.bfloat16), a))

    calib = Focus(3, 48, 3, order="pixel_unshuffle", fused=True, quant="calib")
    load_variables(calib, {"params": {"conv": {"conv": {
        "kernel": np.zeros((3, 3, 12, 48), np.float32), "bias": np.zeros(48, np.float32)}}}})
    calib.conv.conv.act_absmax.zero_()
    with torch.no_grad():
        calib(torch.from_numpy(x), torch.bfloat16)
    absmax = calib.conv.conv.act_absmax.numpy()
    assert absmax.max() == np.abs(x).max() and absmax.dtype == np.float32
