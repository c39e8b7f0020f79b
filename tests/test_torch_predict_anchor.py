"""The anchor-based predictors of the port (cocodet_tpu_torch/predict_yolov5.py,
predict_yolov4.py) against the JAX package's (harness/predict_yolov5.py,
harness/predict_yolov4.py), on the CPU, with the weights the port draws
from numpy seed 0 handed to JAX's (its ``model.init`` replaced).

YOLOv5m6 at published width over 5 generated JPEGs (a full batch of 4 and
a ragged one) at 128 px, conf 0.001, NMS 0.65, in f32 (JAX's predictor is
bf16; there the two part beyond a record match, as the harnesses' bf16
records do, tests/test_torch_split_cat.py): the answer sheets hold the same
images and categories in the same counts, boxes within 0.01 px + 1e-3
relative and scores within 1e-4, matched as sets within an image (the
tolerances of tests/test_torch_harness.py). The same weights from a
msgpack file (``--ckpt``) give the same sheet bit for bit. YOLOv4-P6 at
JAX's smoke size prints JAX's line: the parameter count, the level shapes
and the decoded boxes' shape.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocodet_tpu.models import anchor_zoo as jaz
from cocodet_tpu_torch import predict_yolov4, predict_yolov5
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models.anchor_zoo import build_anchor_model
from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
from cocodet_tpu_torch.utils.convert import random_variables
from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's folder loader letterboxes through its native library: this
    module's process builds its own (tests/torch_port_utils.py)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "harness", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _seeded(name):
    with torch.device("meta"):
        model, _, _ = build_anchor_model(name)
    return random_variables(model, 0)


def _run_jax(module, argv, variables, monkeypatch, dtype=None):
    """JAX's predictor main() on ``argv`` with ``variables`` as its init
    (and its model computing in ``dtype`` where given)."""
    build = jaz.build_anchor_model
    if dtype is not None:
        monkeypatch.setattr(jaz, "build_anchor_model",
                            lambda name, **kw: build(name, **dict(kw, dtype=dtype)))
    monkeypatch.setattr(jaz.AnchorDetector, "init", lambda self, *a, **k: variables)
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    module.main()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = make_synthetic_coco(str(tmp_path_factory.mktemp("anchor")), n_train=0, n_val=5,
                               size_range=(96, 200), seed=6)
    return os.path.join(root, "val2017")


def _by_image(records):
    out = {}
    for r in records:
        out.setdefault(r["image_id"], []).append(r)
    return out


def test_predict_yolov5_matches_jax(folder, tmp_path, monkeypatch):
    variables = _seeded("yolov5m6")
    argv = ["--data-dir", folder, "--img-size", str(SIZE), "--batch-size", "4"]
    _run_jax(_module("predict_yolov5"), argv + ["--out", str(tmp_path / "jax.json")],
             variables, monkeypatch, dtype=jnp.float32)
    want = json.loads((tmp_path / "jax.json").read_text())
    args = predict_yolov5.parser().parse_args(
        argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    n_img, got = predict_yolov5.run(args, dtype=torch.float32)
    assert n_img == 5 and json.loads((tmp_path / "port.json").read_text()) == got
    g, w = _by_image(got), _by_image(want)
    assert list(g) == list(w) and len(got) == len(want) > 0
    for img, wr in w.items():
        gr = g[img]
        assert sorted(r["category_id"] for r in gr) == sorted(r["category_id"] for r in wr)
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        tol = np.concatenate([0.01 + 1e-3 * np.abs(wb[:, :4]), np.full((len(wb), 1), 1e-4)], 1)
        same_cat = (np.asarray([r["category_id"] for r in gr])[:, None]
                    == np.asarray([r["category_id"] for r in wr])[None])
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1) & same_cat
        assert close.any(1).all() and close.any(0).all(), img

    # the same weights from a flax msgpack tree
    ckpt = save_checkpoint({"model": variables}, False, str(tmp_path), "yolov5m6")
    args.ckpt, args.out = ckpt, str(tmp_path / "ckpt.json")
    assert predict_yolov5.run(args, dtype=torch.float32)[1] == got


def test_predict_yolov5_dummy(capsys):
    predict_yolov5.main(["--dummy", "--device", "cpu", "--img-size", "64", "--batch-size",
                         "2"])
    out = capsys.readouterr().out
    assert "yolov5m6: 35,704,908 params" in out and "dummy forward ok: (2, 300, 4)" in out


def test_predict_yolov4_prints_jax_line(monkeypatch, capsys):
    variables = _seeded("yolov4-p6")
    _run_jax(_module("predict_yolov4"), [], variables, monkeypatch)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    predict_yolov4.main(["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and want.startswith("yolov4-p6: 127,536,048 params; levels [(1, 32,")
