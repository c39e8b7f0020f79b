"""w4a8 checkpoints in the port: ``compress/quantize.py::pack_int4_tree``,
``unpack_int4_tree`` and ``tree_has_int4`` against the JAX package's
(cocodet_tpu/compress/quantize.py:228-310), ``utils/checkpoint.py::
load_checkpoint``'s transparent unpack, and ``tools.quantize_model --bits
4`` (``--w4-keep-frac 0.25``, MSE clip) against tools/quantize_model.py's
w4a8 writer, on one seeded slim fused checkpoint (tests/torch_port_utils.py::
SMALL_SLIM_SPEC, depth 0.33, width 0.25) calibrated on ``--synth`` images,
2 batches of 2 at 128 px.

Exact: the packed trees (every leaf's bytes, dtype and shape), the
corruption errors, the files read by either package's reader, and the
port's int4 kernels and packed bytes on the same activation scales.
A w4a8 file serves through the w8a8 model (the int8 conv) bit for bit as
the same tree unpacked and saved as int8. JAX's harness serves JAX's w4a8
file at conf 0.02 (at 0.3 the random int4 model detects nothing), at the
tolerances of tests/test_torch_quantize_model.py (its jitted quantize
division moves some inputs by a step): 0.5 px + 1%, 5e-3 in score, at
least 80% of the matched pairs of one class.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import cocodet_tpu.compress.quantize as jq
from cocodet_tpu_torch import harness
from cocodet_tpu_torch.compress import (int4_kernel_paths, load_slim_spec, pack_int4_tree,
                                        quantize_weights, tree_has_int4, unpack_int4_tree)
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import quantize_model as tq
from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint, save_tree
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables, unflatten_tree
from cocodet_tpu_torch.utils.msgpack import loads_tree
from torch_port_utils import SMALL_ARCH, private_native_builds, write_small_slim_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's synthetic set and folder loader letterbox through its native
    library: this module's process builds its own."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _raw(path):
    with open(path, "rb") as f:
        return loads_tree(f.read())


def _same(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for path, value in w.items():
        a, b = np.asarray(g[path]), np.asarray(value)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def _tree(seed=0):
    """int8 leaves on the nibble grid (odd and even sizes, an empty one),
    int8 leaves off it, a float leaf."""
    rs = np.random.RandomState(seed)
    return {"a": {"kernel": rs.randint(-8, 8, (3, 3, 5, 7)).astype(np.int8),
                  "bias": rs.randn(7).astype(np.float32)},
            "b": {"kernel": rs.randint(-7, 8, (1, 1, 4, 6)).astype(np.int8)},
            "c": {"kernel": rs.randint(-127, 128, (3, 3, 2, 2)).astype(np.int8)},
            "d": {"kernel": np.zeros((0, 3), np.int8)},
            "e": {"kernel": rs.randint(-8, 8, (5,)).astype(np.int8)}}


@pytest.mark.parametrize("declared", [None, {("a", "kernel"), ("e", "kernel")}])
def test_packed_tree_equals_jax(declared):
    tree = _tree()
    got = pack_int4_tree(tree, kernel_paths=declared)
    _same(got, jq.pack_int4_tree(tree, kernel_paths=declared))
    assert tree_has_int4(got) and jq.tree_has_int4(got)
    _same(unpack_int4_tree(got), tree)
    _same(unpack_int4_tree(got), jq.unpack_int4_tree(got))
    assert not tree_has_int4(tree)


@pytest.mark.parametrize("case", ["orphan shape", "data without shape", "declared off grid"])
def test_corruption_errors_raise(case):
    """Both corruption errors of the reader and the packer's refusal of a
    declared kernel off the nibble grid: a ValueError with JAX's message."""
    data = ("a", "kernel", "__int4_packed__")
    if case == "declared off grid":
        def call(port):
            pack = pack_int4_tree if port else jq.pack_int4_tree
            return pack(_tree(), kernel_paths={("c", "kernel")})
    else:
        drop = data if case == "orphan shape" else data[:2] + ("__int4_shape__",)
        broken = unflatten_tree({p: v for p, v in flatten_tree(pack_int4_tree(_tree())).items()
                                 if p != drop})

        def call(port):
            return (unpack_int4_tree if port else jq.unpack_int4_tree)(broken)
    msgs = []
    for port in (True, False):
        with pytest.raises(ValueError) as err:
            call(port)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and ("corrupt" in msgs[0] or "declared int4" in msgs[0])


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """One slim fused checkpoint through the port's tool with ``--bits 4``,
    and JAX's w4a8 file of it: the port's calibrated activation scales
    through the JAX package's ``quantize_weights(bits=4)``,
    ``pack_int4_tree`` over the kernels its ``w_bits`` name and flax's
    msgpack, the steps of tools/quantize_model.py after its calibration
    (:148-181; its calibration is held in tests/test_torch_quantize_model.py,
    and its jitted bf16 pass takes ~100 s here)."""
    from flax import serialization
    from flax.traverse_util import flatten_dict

    d = tmp_path_factory.mktemp("int4")
    spec_path = write_small_slim_spec(d)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=load_slim_spec(spec_path),
                       **SMALL_ARCH)
    variables = random_variables(shapes, 3)
    ckpt = save_checkpoint({"model": variables}, False, str(d), "slim")
    report = tq.main(["-c", ckpt, "--depth", "0.33", "--width", "0.25", "--slim-spec",
                      spec_path, "--synth", "--img-size", "128", "-b", "2", "--calib-batches",
                      "2", "--bits", "4", "--w4-keep-frac", "0.25", "-o",
                      str(d / "port4.msgpack"), "--device", "cpu"])
    act = unflatten_tree({p: v for p, v in flatten_tree(
        load_checkpoint(str(d / "port4.msgpack"))["quant"]).items() if p[-1] == "act_scale"})
    qvars, quant = jq.quantize_weights({"params": variables["params"]}, act, bits=4,
                                       w8_keep_frac=0.25)
    declared = {p[:-1] + ("kernel",) for p, v in flatten_dict(quant).items()
                if p[-1] == "w_bits" and int(v) == 4}
    packed = jq.pack_int4_tree(jax.tree_util.tree_map(np.asarray, qvars["params"]),
                               kernel_paths=declared)
    state = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(
        {"params": packed, "quant": quant}))
    with open(d / "jax4.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(state))
    return {"d": d, "spec": spec_path, "params": variables["params"], "report": report}


def test_files_interoperate(tools):
    """Each package's reader unpacks the other's w4a8 file to the same
    int8 tree; the files are packed (raw), most kernels on the int4 grid."""
    from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load

    d = tools["d"]
    for name in ("jax4", "port4"):
        path = str(d / f"{name}.msgpack")
        assert tree_has_int4(_raw(path))
        got = load_checkpoint(path)
        assert not tree_has_int4(got)
        _same(got, jax_load(path))
    quant = flatten_tree(load_checkpoint(str(d / "port4.msgpack"))["quant"])
    bits = [int(v) for p, v in quant.items() if p[-1] == "w_bits"]
    assert bits.count(4) > 60 and bits.count(8) > 20
    assert tools["report"]["weight_bits"] == 4


def test_packed_kernels_exact_given_jax_scales(tools):
    """On the same activation scales, the port's ``quantize_weights(bits=4,
    w8_keep_frac=0.25)`` and ``pack_int4_tree`` over ``int4_kernel_paths``
    equal JAX's file leaf for leaf, params (packed) and quant; so does the
    port's tool's own file."""
    raw = _raw(str(tools["d"] / "jax4.msgpack"))
    want = unpack_int4_tree(raw)
    act = unflatten_tree({p: v for p, v in flatten_tree(want["quant"]).items()
                          if p[-1] == "act_scale"})
    qvars, quant = quantize_weights({"params": tools["params"]}, act, bits=4,
                                    w8_keep_frac=0.25)
    packed = pack_int4_tree(qvars["params"], kernel_paths=int4_kernel_paths(quant))
    _same(packed, raw["params"])
    _same(quant, want["quant"])
    _same(_raw(str(tools["d"] / "port4.msgpack")), raw)


def _config(tools, ckpt, root, conf=0.3):
    return {"model": {"type": "yolox-p6", **SMALL_ARCH}, "ckpt": ckpt, "quant": "w8a8",
            "slim_spec": tools["spec"], "img_size": 128, "half": False,
            "data_dir": os.path.join(root, "val2017"), "dataloader": {"batch_size": 2},
            "postprocess": {"conf_threshold": conf, "nms_threshold": 0.55,
                            "max_num_nms": 128, "max_num_det": 50}, "input_aug": True}


@pytest.fixture(scope="module")
def val_root(tools):
    return make_synthetic_coco(str(tools["d"] / "coco"), n_train=0, n_val=4,
                               size_range=(128, 128), seed=4)


def test_w4a8_serves_as_its_int8_form(tools, val_root):
    """The port's w4a8 file and the same tree unpacked and saved as int8,
    served by the port's harness through the w8a8 model at conf 0.001:
    equal records. The packed file is the smaller."""
    d = tools["d"]
    unpacked = save_tree(load_checkpoint(str(d / "port4.msgpack")), str(d / "int8.msgpack"))
    assert not tree_has_int4(_raw(unpacked))
    assert os.path.getsize(d / "port4.msgpack") < 0.75 * os.path.getsize(unpacked)
    got = harness.run(_config(tools, str(d / "port4.msgpack"), val_root, 1e-3),
                      str(d / "a.json"), device="cpu")
    want = harness.run(_config(tools, unpacked, val_root, 1e-3), str(d / "b.json"),
                       device="cpu")
    assert got == want and sum(r["score"] > 0 for r in got) > 0


def test_jax_w4a8_file_serves_jax_records(tools, val_root):
    d = tools["d"]
    cfg = _config(tools, str(d / "jax4.msgpack"), val_root, 0.02)
    want = _load(os.path.join(REPO, "harness", "main.py")).run(cfg, str(d / "jax.json"))
    got = harness.run(cfg, str(d / "port.json"), device="cpu")
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert sum(r["score"] > 0 for r in want) > 0
    same_class = 0
    for img in {r["image_id"] for r in want}:
        gr = [r for r in got if r["image_id"] == img]
        wr = [r for r in want if r["image_id"] == img]
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        tol = np.concatenate([0.5 + 1e-2 * np.abs(wb[:, :4]), np.full((len(wb), 1), 5e-3)], 1)
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1)
        assert close.any(1).all() and close.any(0).all(), img
        for i, j in zip(*np.nonzero(close)):
            same_class += gr[i]["category_id"] == wr[j]["category_id"]
    assert same_class >= 0.8 * len(want)
