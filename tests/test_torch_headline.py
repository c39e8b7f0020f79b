"""The port's w8a8 headline slice as a whole (cocodet_tpu_torch/entry.py:
``build_headline``, ``build_w8a8_predictor``) against the recipe of
``bench.py`` in the JAX package (_build_slim_from_spec + _quantize_slim +
the postprocess at the production point), at a small architecture
(depth 0.33, width 0.25) with the channel plan SMALL_SLIM_SPEC.

Tolerances, f32 compute, the same quantized variables: head maps within
1e-5 * (1 + |v|). Every int8 conv is exact and its inputs quantize to the
same integers in both packages (tests/test_torch_quantize.py); what remains
is the float prediction convs, which XLA:CPU and oneDNN sum in another
order (observed: 2e-7 * (1 + |v|)). Detections: the same sets at the
tolerance of tests/test_torch_entry.py. The JAX model runs op by op: under
``jax.jit`` XLA:CPU computes the quantize division ``x / act_scale`` other
than by IEEE division (its results differ from the eager ones), which moves
some quantized inputs by one step.

The port's own calibration differs from JAX's by the f32 summation order
of the float convs it runs (statistics within ~2e-6 relative), so its
scales are compared at 1e-4 relative, as the statistics are in
tests/test_torch_quantize.py, and its int8 kernels may differ by
one step where a folded weight lies at a rounding boundary (observed: 36
of 2.6 M values): at most 1e-4 of them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import build_quant_tree as jax_build_quant_tree
from cocodet_tpu.compress import quantize_weights as jax_quantize_weights
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.ops.postprocess import PostprocessConfig as JaxConfig
from cocodet_tpu.ops.postprocess import postprocess as jax_postprocess
from cocodet_tpu_torch.compress import load_slim_spec
from cocodet_tpu_torch.entry import PRODUCTION_CONFIG, build_headline, build_w8a8_predictor
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.ops.cuda import int8_conv, nms_kernels
from cocodet_tpu_torch.utils.convert import random_variables
from torch_port_utils import (SMALL_ARCH, assert_close, assert_same_detections, head_maps,
                              images, write_small_slim_spec)

STRIDES = (8, 16, 32, 64)
CALIB_IMAGES = (np.random.RandomState(1).rand(2, 256, 256, 3) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small slim plan, fused variables from a numpy seed (prediction
    biases at -2 so that hundreds of detections pass conf 0.001), and the
    JAX package's w8a8 quantization of them (bench.py:218-246: the steps of
    compress.quantize_model, with the calibration forward jitted)."""
    path = write_small_slim_spec(tmp_path_factory.mktemp("spec"))
    spec = load_slim_spec(path)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=spec, **SMALL_ARCH)
    variables = random_variables(shapes, 3)
    for k in range(len(STRIDES)):
        for name in ("obj_pred", "cls_pred"):
            variables["params"]["head"][f"{name}{k}"]["bias"][:] = -2.0
    calib = jax_build_model("yolox-p6", fused=True, slim=spec, quant="calib", **SMALL_ARCH)
    _, stats = jax.jit(lambda v, x: calib.apply(v, x, mutable=["quant_stats"]))(
        variables, jnp.asarray(CALIB_IMAGES))
    qtree = jax_build_quant_tree(stats["quant_stats"], per_channel_act=True)
    qvars, quant = jax_quantize_weights(variables, qtree)
    qvars["quant"] = quant
    return path, spec, variables, jax.tree_util.tree_map(np.asarray, qvars)


def test_headline_small_matches_jax(small):
    _, spec, _, qvars = small
    x = images(128)
    jm = jax_build_model("yolox-p6", fused=True, slim=spec, quant="w8a8", **SMALL_ARCH)
    cfg = JaxConfig(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=1024, max_det=300)
    want_maps = jm.apply(qvars, jnp.asarray(x))  # op by op: see the module docstring
    want = jax.device_get(jax.jit(lambda m: jax_postprocess(m, STRIDES, cfg))(want_maps))

    int8_conv.reset_launch_counts()
    nms_kernels.reset_launch_counts()
    predictor = build_w8a8_predictor(qvars, spec, dtype=torch.float32, device="cpu",
                                     **SMALL_ARCH)
    assert predictor.cfg == PRODUCTION_CONFIG
    with torch.inference_mode():
        got_maps = predictor.model(torch.from_numpy(x))
    got = predictor(x)
    for g, w in zip(head_maps(got_maps), head_maps(want_maps)):
        for key in ("reg", "obj", "cls"):
            assert g[key].shape == w[key].shape
            assert_close(g[key], w[key], rtol=1e-5, atol=1e-5)
    assert got.boxes.shape == (2, 300, 4)
    assert int(want.valid.sum()) > 100
    assert_same_detections(got, want)
    # on the CPU every kernel wrapper takes its plain version
    assert int8_conv.conv2d_w8a8.launches == 0
    assert nms_kernels.overlap_matrix.launches == nms_kernels.greedy_keep.launches == 0


def test_build_headline_small_matches_jax_recipe(small):
    path, _, variables, qvars = small
    predictor = build_headline(path, dtype=torch.float32, device="cpu",
                               variables=variables, **SMALL_ARCH)
    assert set(predictor.seconds) == {"build", "calibrate", "quantize"}
    got, want = flatten_dict(predictor.variables), flatten_dict(qvars)
    assert got.keys() == want.keys()
    n_diff = n_int8 = 0
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1, k
            n_diff += int((g != w).sum())
            n_int8 += w.size
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
    assert n_int8 > 2_000_000 and n_diff <= 1e-4 * n_int8
    # the Focus stem per-tensor, every other conv per input channel
    quant = predictor.variables["quant"]
    stem = quant["backbone"]["backbone"]["stem"]["conv"]["conv"]
    assert np.asarray(stem["act_scale"]).shape == ()
    assert np.asarray(quant["backbone"]["lateral1"]["conv"]["act_scale"]).shape == (128,)
    model = predictor.model
    assert model.quant == "w8a8" and model.dtype == torch.float32
    res = predictor(images(128, batch=1, seed=4))
    assert res.boxes.shape == (1, 300, 4) and torch.isfinite(res.boxes).all()


def test_headline_small_bf16(small):
    """Served in bf16 as on the card: the w8a8 convs write bf16 and the
    prediction convs run in bf16. Against JAX's bf16 w8a8 model at the bf16
    tolerance of tests/test_torch_model.py (elementwise 0.25 * (1 + |v|),
    mean relative 2%): bf16 rounds hard-swish and the residual adds at
    other places in the two packages, so quantized inputs land a step
    apart. The JAX model is jitted here, as bench.py runs it."""
    _, spec, _, qvars = small
    x = images(128)
    jm = jax_build_model("yolox-p6", fused=True, slim=spec, quant="w8a8",
                         dtype=jnp.bfloat16, **SMALL_ARCH)
    want = head_maps(jax.jit(jm.apply)(qvars, jnp.asarray(x)))
    predictor = build_w8a8_predictor(qvars, spec, device="cpu", **SMALL_ARCH)
    assert predictor.model.dtype == torch.bfloat16
    assert predictor.model.backbone.lateral1.conv.w_scale.dtype == torch.float32
    with torch.inference_mode():
        got_maps = predictor.model(torch.from_numpy(x))
    assert got_maps[0]["cls"].dtype == torch.bfloat16
    got = head_maps(got_maps)
    for g, w in zip(got, want):
        for key in ("reg", "obj", "cls"):
            assert_close(g[key], w[key], rtol=0.25, atol=0.25)
    g = np.concatenate([m[k].ravel() for m in got for k in ("reg", "obj", "cls")])
    w = np.concatenate([m[k].ravel() for m in want for k in ("reg", "obj", "cls")])
    assert np.abs(g - w).mean() <= 0.02 * np.abs(w).mean()
