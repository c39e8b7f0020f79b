"""The latency serving graph of the port: ``stem6`` (the Focus stem as one
6x6 stride-2 conv, ``ops/fuse.py::fold_focus_stem``) and ``split_cat``
(the concat-free merges: ``models/blocks.py::Conv2d`` parts, the SPP's and
the CSP layers' last convs, the PAFPN's merges), against the JAX package's
(cocodet_tpu/ops/fuse.py:86-135, models/blocks.py:192-214 and 325-336,
darknet.py:115-176, pafpn.py:80-166, yolox.py:74-111), and the harness on
``harness/config/yolox_m_p6_latency.json`` against harness/main.py.

The models: fused YOLOX-M-P6 at depth 0.33, width 0.25, 128 px, B=2, the
weights drawn from numpy seed 3 (the Focus form; the stem6 models take
them folded). Tolerances, those of tests/test_torch_model.py: f32 maps
within 1e-4 * (1 + |v|), bf16 maps within 0.25 * (1 + |v|) with a mean
relative error of at most 2% (the parts' sums round once more in bf16,
in JAX as here). ``fold_focus_stem`` is exact, both channel orders. The
port's rewrites against its own plain graph: f32 within 1e-5 * (1 + |v|)
(the convs sum in another order). The harness: the latency config at
depth 0.33, width 0.125, 128 px, B=1, in f32 (``half`` off: in bf16 the
two harnesses' records part beyond ``_assert_records_match``), conf 0.3,
on one msgpack of numpy seed 1 fused weights JAX writes, at
tests/test_torch_harness.py's tolerances.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.ops import fuse as jfuse
from cocodet_tpu_torch import harness
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.models.blocks import Conv2d
from cocodet_tpu_torch.ops.fuse import fold_focus_stem
from cocodet_tpu_torch.utils.convert import (export_variables, flatten_tree, jax_layout,
                                             random_variables)
from test_torch_harness import _assert_records_match
from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-4)
SIZE = 128


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's harness letterboxes through its native library: this module's
    process builds its own (tests/torch_port_utils.py)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _maps(outputs):
    return [{k: np.asarray(v.detach().float().numpy() if isinstance(v, torch.Tensor) else v,
                           np.float32) for k, v in o.items()} for o in outputs]


def _assert_maps(got, want, rtol, atol, mean_rel=None):
    for g, w in zip(_maps(got), _maps(want)):
        for key in ("reg", "obj", "cls"):
            assert g[key].shape == w[key].shape, key
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=atol)
            if mean_rel is not None:
                rel = np.abs(g[key] - w[key]) / (1 + np.abs(w[key]))
                assert rel.mean() <= mean_rel, (key, rel.mean())


@pytest.fixture(scope="module")
def weights():
    """(NHWC images, the Focus-form fused variables of numpy seed 3)."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.25, fused=True)
    x = np.random.RandomState(0).uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    return x, random_variables(shapes, 3)


@pytest.mark.parametrize("order", ["pixel_unshuffle", "slice_cat"])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_fold_focus_stem_matches_jax(order, dtype):
    rs = np.random.RandomState(1)
    k = (rs.randn(3, 3, 12, 8) * 50).astype(dtype)
    params = {"backbone": {"backbone": {"stem": {"conv": {"conv": {
        "kernel": k, "bias": rs.randn(8).astype(np.float32)}}}, "dark2_down": {
        "conv": {"kernel": rs.randn(3, 3, 8, 16).astype(np.float32)}}}}}
    got = flatten_tree(fold_focus_stem(params, order=order))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                               jfuse.fold_focus_stem(params, order=order)))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        assert got[path].dtype == v.dtype and got[path].shape == v.shape, path
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    assert got[("backbone", "backbone", "stem", "conv", "kernel")].shape == (6, 6, 3, 8)


def test_stem6_tree_converts_both_ways(weights):
    """utils/convert.py carries a stem6 + split_cat model's tree both ways:
    its flax layout is the JAX model's (the 6x6 kernel at backbone/backbone/
    stem/conv/kernel), and the folded tree loads and exports unchanged."""
    x, variables = weights
    folded = {"params": fold_focus_stem(variables["params"])}
    jm = jax_build_model("yolox-p6", depth=0.33, width=0.25, fused=True, stem6=True,
                         split_cat=True)
    want = {k: tuple(v.shape) for k, v in flatten_tree(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1])).items()}
    model = build_model("yolox-p6", depth=0.33, width=0.25, fused=True, device="cpu",
                        variables=folded, stem6=True, split_cat=True)
    assert jax_layout(model) == want
    assert want[("params", "backbone", "backbone", "stem", "conv", "kernel")][:3] == (6, 6, 3)
    got = flatten_tree(export_variables(model))
    for path, v in flatten_tree(folded).items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


def _port(variables, dtype, **flags):
    if flags.get("stem6"):
        variables = {"params": fold_focus_stem(variables["params"])}
    return build_model("yolox-p6", depth=0.33, width=0.25, fused=True, device="cpu",
                       dtype=dtype, variables=variables, **flags)


def _jax(x, variables, dtype, **flags):
    if flags.get("stem6"):
        variables = {"params": jfuse.fold_focus_stem(variables["params"])}
    m = jax_build_model("yolox-p6", depth=0.33, width=0.25, fused=True, dtype=dtype, **flags)
    return jax.jit(m.apply)(variables, jnp.asarray(x))


FLAGS = [dict(stem6=True), dict(split_cat=True), dict(stem6=True, split_cat=True)]


@pytest.mark.parametrize("flags", FLAGS, ids=["stem6", "split_cat", "both"])
def test_rewrites_match_jax_f32(weights, flags):
    x, variables = weights
    want = _jax(x, variables, jnp.float32, **flags)
    with torch.no_grad():
        got = _port(variables, torch.float32, **flags)(torch.from_numpy(x))
        plain = _port(variables, torch.float32)(torch.from_numpy(x))
    _assert_maps(got, want, **F32)
    _assert_maps(got, plain, rtol=1e-5, atol=1e-5)


def test_rewrites_match_jax_bf16(weights):
    x, variables = weights
    flags = dict(stem6=True, split_cat=True)
    want = _jax(x, variables, jnp.bfloat16, **flags)
    with torch.no_grad():
        got = _port(variables, torch.bfloat16, **flags)(torch.from_numpy(x))
    assert got[0]["cls"].dtype == torch.bfloat16
    _assert_maps(got, want, rtol=0.25, atol=0.25, mean_rel=0.02)


def test_parts_guards_raise():
    """JAX's guards of a parts conv, with its messages (a w8a8 conv's too);
    a stem6 model without BN fold raises as the port's own."""
    a, b = torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="groups must be 1"):
        Conv2d(8, 8, 1, groups=2)([a, b])
    with pytest.raises(ValueError, match="pointwise commute"):
        Conv2d(8, 8, 3)([(a, True), b])
    with pytest.raises(ValueError, match="pointwise commute"):
        Conv2d(8, 8, 3, quant="w8a8")([(a, True), b])
    with pytest.raises(ValueError, match="deployment-graph"):
        Conv2d(8, 8, 1, quant="qat")([a, b])
    with pytest.raises(ValueError, match="stem6 is a deployment"):
        YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, stem6=True)


@pytest.mark.parametrize("up", [False, True], ids=["parts", "up2x"])
def test_w8a8_parts_conv_matches_concat(up):
    """A w8a8 conv on split-concat parts sums the parts' s32 convs before
    one epilogue (cocodet_tpu/models/blocks.py:258-276): bit for bit the
    same conv on the materialized concat, in f32 and bf16."""
    from cocodet_tpu_torch.models.blocks import upsample2x

    rs = np.random.RandomState(2)
    a = torch.from_numpy((rs.rand(2, 8, 4 if up else 8, 4 if up else 8) * 40 - 10)
                         .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    b = torch.from_numpy((rs.rand(2, 16, 8, 8) * 40 - 10).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    conv = Conv2d(24, 32, 1, use_bias=True, quant="w8a8")
    conv.weight.copy_(torch.from_numpy(rs.randint(-127, 128, (32, 24, 1, 1)).astype(np.int8)))
    conv.w_scale.copy_(torch.from_numpy((rs.rand(32) * 1e-2).astype(np.float32)))
    conv.act_scale = torch.from_numpy((rs.rand(24) * 0.2 + 0.05).astype(np.float32))
    conv.bias.data.copy_(torch.from_numpy(rs.rand(32).astype(np.float32)))
    concat = torch.cat([upsample2x(a) if up else a, b], dim=1)
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            got = conv([(a, up), b], dtype, act="hard_swish")
            want = conv(concat, dtype, act="hard_swish")
        assert got.dtype == dtype and torch.equal(got, want)


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_harness_main", os.path.join(REPO, "harness", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _latency_config(root, ckpt):
    with open(os.path.join(REPO, "harness", "config", "yolox_m_p6_latency.json")) as f:
        cfg = json.load(f)
    assert cfg["stem6"] and cfg["split_cat"] and cfg["dataloader"]["batch_size"] == 1
    cfg.update(img_size=SIZE, half=False, data_dir=os.path.join(root, "val2017"),
               annotation=None, ckpt=ckpt, slim_spec=None)
    cfg["model"].update(depth=0.33, width=0.125)
    cfg["postprocess"].update(conf_threshold=0.3)
    return cfg


def test_latency_config_matches_jax(tmp_path):
    """The latency config (stem6 + split_cat, B=1) served by both harnesses
    from one JAX-written msgpack of Focus-form fused weights, which each
    folds: JAX's records; and the port's records equal to its own with
    both flags off on the same file, at the same tolerances."""
    from cocodet_tpu.utils.checkpoint import save_checkpoint

    root = make_synthetic_coco(str(tmp_path / "coco"), n_train=0, n_val=4,
                               size_range=(SIZE, SIZE), seed=4)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    ckpt = save_checkpoint({"model": random_variables(shapes, 1)}, False, str(tmp_path),
                           "deploy")
    cfg = _latency_config(root, ckpt)
    want = _jax_harness().run(cfg, str(tmp_path / "jax.json"), challenge=True)
    got = harness.run(cfg, str(tmp_path / "port.json"), challenge=True, device="cpu")
    assert _assert_records_match(got, want) < len(got) - 1  # some detections
    plain = harness.run(dict(cfg, stem6=False, split_cat=False), str(tmp_path / "plain.json"),
                        challenge=True, device="cpu")
    _assert_records_match(got, plain)


def test_pth_stem6_keeps_the_reference_init(tmp_path, monkeypatch):
    """A fault of the reference (ROADMAP Queue 3): harness/main.py's ``.pth``
    branch lays the imported params over the init with ``load_matched`` and
    no ``fold_focus_stem`` (:88-95), so under ``stem6`` the imported Focus
    kernel (``stem/conv/conv``) matches no leaf of the 6x6 stem
    (``stem/conv``), which keeps JAX's random init. The port folds the
    imported stem: its 6x6 kernel is the file's Focus kernel folded."""
    from cocodet_tpu_torch.utils.torch_import import export_state_dict

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    variables = random_variables(shapes, 2)
    pth = tmp_path / "merged_p6.pth"
    torch.save(export_state_dict(variables), pth)
    cfg = {"model": {"type": "yolox-m-p6-pr", "depth": 0.33, "width": 0.125},
           "ckpt": str(pth), "half": False, "stem6": True}
    stem = ("backbone", "backbone", "stem", "conv", "kernel")
    folded = flatten_tree(fold_focus_stem(variables["params"]))[stem]

    import cocodet_tpu.utils.checkpoint as jck

    inits, load_matched = [], jck.load_matched
    monkeypatch.setattr(jck, "load_matched",  # JAX's init, as its harness lays the file over it
                        lambda target, ckpt: inits.append(target) or load_matched(target, ckpt))
    _, jvars = _jax_harness().build_model_and_vars(cfg)
    jk = np.asarray(flatten_tree(jax.tree_util.tree_map(np.asarray, jvars["params"]))[stem])
    np.testing.assert_array_equal(jk, np.asarray(flatten_tree(inits[0])[stem]))
    assert not np.allclose(jk, folded)
    dark2 = ("backbone", "backbone", "dark2_down", "conv", "kernel")
    np.testing.assert_array_equal(  # the rest of the file did load
        np.asarray(flatten_tree(jvars["params"])[dark2]), flatten_tree(variables["params"])[dark2])

    predictor = harness.build_predictor_from_config(cfg, device="cpu")
    got = predictor.model.backbone.backbone.stem.conv.weight.detach().numpy()
    np.testing.assert_array_equal(got, folded.transpose(3, 2, 0, 1))
