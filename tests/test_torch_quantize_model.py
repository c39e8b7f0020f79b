"""The port's int8 PTQ CLI (cocodet_tpu_torch/tools/quantize_model.py)
against tools/quantize_model.py of the JAX package, on the same seeded
slim fused checkpoint (tests/torch_port_utils.py::SMALL_SLIM_SPEC, depth
0.33, width 0.25) and the same ``--synth`` images, 2 batches of 2 at 128 px.

The two packages' synthetic generators draw the same scenes but not the
same pixels (0.8-14% of the pixels of a seed-7 image differ), so JAX's tool
is handed the port's generator: both then calibrate on identical batches.

Tolerances. Both tools calibrate with a bf16 forward (JAX's hardcodes it);
XLA:CPU and oneDNN round the bf16 activations otherwise in the last bit
(the first layers' scales differ by one bf16 step, ~0.4%), and the
differences grow through the random network. Measured over the 6,233
activation scales: median 0.46%, 99th percentile 4.4%, largest 18.3%.
Held: median 1%, 99th percentile 10%, largest 25%. The int8 kernels and
``w_scale`` follow from the scales by numpy steps: given JAX's scales, the
port's quantization of the same params equals JAX's tool's output bit for
bit. The biases pass through, exactly. Both harnesses serve the port's
output to the same boxes: under jit, XLA:CPU computes the quantize division
``x / act_scale`` other than by IEEE division, which moves some quantized
inputs by one step (tests/test_torch_headline.py holds the model exact
against JAX run op by op; JAX's harness op by op takes ~4 min here). So the
records are held at 0.5 px + 1% and 5e-3 in score, matched as sets within
an image, and at least 80% of the matched pairs share their class
(measured: 1 of 10 records changed its class; boxes within 0.1 px,
scores within 2e-3).
"""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from cocodet_tpu_torch import harness
from cocodet_tpu_torch.compress import load_slim_spec, quantize_weights
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import quantize_model as tq
from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables, unflatten_tree
from torch_port_utils import SMALL_ARCH, private_native_builds, write_small_slim_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """Both tools' outputs on one checkpoint; (port tree, JAX tree, fused
    params, spec path, dir)."""
    import cocodet_tpu.data.synthetic as jsynth

    d = tmp_path_factory.mktemp("quantize_model")
    spec_path = write_small_slim_spec(d)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=load_slim_spec(spec_path),
                       **SMALL_ARCH)
    variables = random_variables(shapes, 3)
    ckpt = save_checkpoint({"model": variables}, False, str(d), "slim")
    args = ["-c", ckpt, "--depth", "0.33", "--width", "0.25", "--slim-spec", spec_path,
            "--synth", "--img-size", "128", "-b", "2", "--calib-batches", "2"]
    jq = _load(os.path.join(REPO, "tools", "quantize_model.py"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(d))  # JAX's tool caches its set there
        mp.setattr(jsynth, "make_synthetic_coco", make_synthetic_coco)
        mp.setattr(sys, "argv", ["quantize_model"] + args + ["-o", str(d / "jax.msgpack"),
                                                              "--cpu"])
        jq.main()
        report = tq.main(args + ["-o", str(d / "port.msgpack"), "--device", "cpu"])
    assert report["out"] == str(d / "port.msgpack") and report["quantized_convs"] > 90
    return (load_checkpoint(str(d / "port.msgpack")), load_checkpoint(str(d / "jax.msgpack")),
            variables["params"], spec_path, d)


def test_tree_and_scales_match_jax(tools):
    port, want, _, _, d = tools
    assert sorted(port) == sorted(want) == ["params", "quant"]
    g, w = flatten_tree(port), flatten_tree(want)
    assert sorted(g) == sorted(w)
    rel = []
    for path, value in w.items():
        got = np.asarray(g[path])
        assert got.dtype == np.asarray(value).dtype and got.shape == np.shape(value), path
        if path[-1] == "act_scale":
            rel.append((np.abs(got - value) / np.abs(value)).ravel())
        elif path[-1] == "bias":
            np.testing.assert_array_equal(got, value, err_msg=str(path))
    rel = np.concatenate(rel)
    assert np.median(rel) <= 1e-2 and np.percentile(rel, 99) <= 0.1 and rel.max() <= 0.25
    # the port's file is flax's msgpack: JAX's reader gives the same tree
    from cocodet_tpu.utils.checkpoint import load_checkpoint as jax_load

    jt = flatten_tree(jax_load(str(d / "port.msgpack")))
    assert sorted(jt) == sorted(g)
    for path, value in g.items():
        np.testing.assert_array_equal(np.asarray(jt[path]), value)


def test_int8_kernels_exact_given_jax_scales(tools):
    """The port's quantization of the checkpoint's params on JAX's tool's
    activation scales: every int8 kernel and ``w_scale`` equal to JAX's."""
    _, want, params, _, _ = tools
    act = unflatten_tree({p: v for p, v in flatten_tree(want["quant"]).items()
                          if p[-1] == "act_scale"})
    qvars, quant = quantize_weights({"params": params}, act)
    got = flatten_tree({"params": qvars["params"], "quant": quant})
    for path, value in flatten_tree(want).items():
        if path[-1] in ("kernel", "w_scale"):
            assert np.asarray(got[path]).dtype == np.asarray(value).dtype
            np.testing.assert_array_equal(np.asarray(got[path]), value, err_msg=str(path))
    n_int8 = sum(np.asarray(v).dtype == np.int8 for v in flatten_tree(want["params"]).values())
    assert n_int8 > 90


def test_harnesses_serve_the_output_alike(tools):
    """The port's output under ``"quant": "w8a8"`` with its slim spec, served
    by the port's harness and by JAX's (harness/main.py)."""
    _, _, _, spec_path, d = tools
    root = make_synthetic_coco(str(d / "coco"), n_train=0, n_val=4, size_range=(128, 128),
                               seed=4)
    cfg = {"model": {"type": "yolox-p6", **SMALL_ARCH}, "ckpt": str(d / "port.msgpack"),
           "quant": "w8a8", "slim_spec": spec_path, "img_size": 128, "half": False,
           "data_dir": os.path.join(root, "val2017"), "dataloader": {"batch_size": 2},
           "postprocess": {"conf_threshold": 0.3, "nms_threshold": 0.55, "max_num_nms": 128,
                           "max_num_det": 50},
           "input_aug": True}
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


def test_bits_4_raises(tmp_path):
    """Named when ``--bits 4`` raised; it now writes w4a8 checkpoints
    (tests/test_torch_int4.py). What it still refuses is a kernel it
    declares int4 that is off the nibble grid, with JAX's message."""
    from cocodet_tpu.compress.quantize import pack_int4_tree as jax_pack
    from cocodet_tpu_torch.compress import pack_int4_tree

    tree = {"c": {"kernel": np.full((3, 3, 2, 2), 9, np.int8)}}
    msgs = []
    for pack in (pack_int4_tree, jax_pack):
        with pytest.raises(ValueError, match="declared int4") as err:
            pack(tree, kernel_paths={("c", "kernel")})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_eval_harness_ckpt_scores_the_output(tools, capsys):
    """tools/eval_harness_ckpt.py on the port's int8 output: the harness's
    detections written beside it and scored; the mAP and AP50 it prints
    equal JAX's score_detections_json of the same file."""
    import json

    from cocodet_tpu.evaluators.coco_metric import score_detections_json
    from cocodet_tpu_torch.tools import eval_harness_ckpt

    _, _, _, spec_path, d = tools
    root = make_synthetic_coco(str(d / "coco_eval"), n_train=0, n_val=3,
                               size_range=(128, 160), seed=5)
    got = eval_harness_ckpt.main(["-c", str(d / "port.msgpack"), "--slim-spec", spec_path,
                                  "--quant", "w8a8", "--data-dir", root, "--depth", "0.33",
                                  "--width", "0.25", "--img-size", "128", "-b", "2",
                                  "--no-half", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    dets = str(d / "port_detections.json")
    want = score_detections_json(os.path.join(root, "annotations", "instances_val2017.json"),
                                 dets)
    assert (got["mAP"], got["AP50"]) == (want["AP"], want["AP50"])
    assert got["quant"] == "w8a8" and len(json.loads(open(dets).read())) > 0
