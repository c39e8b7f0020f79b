"""The port's checkpoint CLIs (cocodet_tpu_torch/tools/{check_param,
export_torch,eval_robustness}.py) against the JAX package's tools/, each fed
the same msgpack checkpoint, written by the port's ``save_tree`` (flax's
bytes).

Exact: check_param's printed lines (a small YOLOX trainer's checkpoint and
a bare P6 tree); export_torch's state dicts, tensor for tensor, for a
trainer's checkpoint of YOLOv3 (EMA and ``--raw``) and the bare P6 tree, and the ``.pth`` read back by ``torch_import`` to the tree
it came from. eval_robustness: the two tools are handed one generator's
roots (the port's ``make_synthetic_coco``; JAX's generator draws other
pixels, ROADMAP Queue 3) and one stand-in for their harness, whose
detections each scores with its own package: the table, the printed lines
and the harness configs equal. The port's tool also runs through the
port's harness itself. (JAX's harness compiles its model anew for each of
the six variants, ~15 s each on this CPU: too slow for this file.)
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cocodet_tpu_torch import harness
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import check_param, eval_robustness, export_torch
from cocodet_tpu_torch.utils.checkpoint import save_tree
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables
from cocodet_tpu_torch.utils.torch_import import load_torch_checkpoint
from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """tools/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    return jax_tool(name).main()


def _variables(name, seed, **kw):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS[name], **kw)
    return random_variables(shapes, seed)


@pytest.fixture(scope="module")
def trainer_ckpt(tmp_path_factory):
    """A YOLOv3 checkpoint as the trainer writes it: the EMA ``model`` and
    the ``raw_model`` (different draws), with BN statistics."""
    path = str(tmp_path_factory.mktemp("ckpt") / "yolov3_ckpt.msgpack")
    save_tree({"start_epoch": 1, "model": _variables("yolov3", 1),
               "raw_model": _variables("yolov3", 2), "best_ap": 0.0}, path)
    return path


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """A trainer's checkpoint of a small YOLOX (depth 0.33, width 0.125)."""
    path = str(tmp_path_factory.mktemp("small") / "yolox_ckpt.msgpack")
    save_tree({"start_epoch": 1, "model": _variables("yolox", 4, depth=0.33, width=0.125)},
              path)
    return path


@pytest.fixture(scope="module")
def p6_tree(tmp_path_factory):
    """A bare fused yolox-p6 params tree at eval_robustness's defaults."""
    path = str(tmp_path_factory.mktemp("p6") / "p6_fused.msgpack")
    save_tree(_variables("yolox-p6", 3, depth=0.33, width=0.25, fused=True)["params"], path)
    return path


@pytest.mark.parametrize("argv", [[], ["--threshold", "0.05", "--bins", "7"]],
                         ids=["defaults", "cut"])
def test_check_param_prints_jax_lines(monkeypatch, capsys, small_ckpt, p6_tree, argv):
    for ckpt in (small_ckpt, p6_tree):
        run_jax(monkeypatch, "check_param", ["-c", ckpt] + argv)
        want = capsys.readouterr().out
        lines = check_param.main(["-c", ckpt] + argv)
        got = capsys.readouterr().out
        assert got == want and got.splitlines() == lines
        assert len(lines) == 2 + (int(argv[-1]) if argv else 20)


@pytest.mark.parametrize("case", ["ema", "raw", "p6"])
def test_export_torch_equals_jax(monkeypatch, tmp_path, trainer_ckpt, p6_tree, case):
    args = {"ema": ["-c", trainer_ckpt, "--variant", "standard", "--num-levels", "3"],
            "raw": ["-c", trainer_ckpt, "--variant", "standard", "--num-levels", "3", "--raw"],
            "p6": ["-c", p6_tree]}[case]
    run_jax(monkeypatch, "export_torch", args + ["-o", str(tmp_path / "jax.pth")])
    sd = export_torch.main(args + ["-o", str(tmp_path / "port.pth")])
    want = torch.load(tmp_path / "jax.pth", weights_only=True)["model"]
    got = torch.load(tmp_path / "port.pth", weights_only=True)["model"]
    assert list(got) == list(want) == list(sd)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32
        assert torch.equal(got[k], v), k
    # the file reads back to the tree it came from
    if case == "p6":
        tree = {"params": _variables("yolox-p6", 3, depth=0.33, width=0.25, fused=True)["params"]}
        back = load_torch_checkpoint(str(tmp_path / "port.pth"))
    else:
        tree = _variables("yolov3", 2 if case == "raw" else 1)
        back = load_torch_checkpoint(str(tmp_path / "port.pth"), "standard", 3)
    flat, want_flat = flatten_tree(back), flatten_tree(tree)
    assert sorted(flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(flat[k], v)


def _roots(tmp_path):
    roots = {}

    def variant_root(variant, n_val, size, seed):
        if variant not in roots:
            roots[variant] = make_synthetic_coco(str(tmp_path / variant), n_train=0,
                                                 n_val=n_val, size_range=(size, size * 2),
                                                 seed=seed, variant=variant)
        return roots[variant]

    return variant_root


def _fake_run(cfgs):
    """A harness ``run`` that records its config and writes the val set's
    boxes, jittered by a seed of the image, with scores from the same seed
    and one false positive an image, in place of a model's detections."""

    def run(cfg, out_path, **kw):
        cfgs.append(dict(cfg, postprocess=dict(cfg["postprocess"]), run_kw=kw))
        root = os.path.dirname(cfg["data_dir"])
        with open(os.path.join(root, "annotations", "instances_val2017.json")) as f:
            gt = json.load(f)
        records = []
        for a in gt["annotations"]:
            rs = np.random.RandomState(a["id"])
            x, y, w, h = a["bbox"]
            records.append({"image_id": a["image_id"], "category_id": a["category_id"],
                            "bbox": [x + rs.normal(0, 2), y + rs.normal(0, 2), w, h],
                            "score": float(rs.uniform(0.2, 1))})
        for im in gt["images"]:
            records.append({"image_id": im["id"], "category_id": 1,
                            "bbox": [1.0, 1.0, 9.0, 9.0], "score": 0.5})
        with open(out_path, "w") as f:
            json.dump(records, f)
        return records

    return run


def test_eval_robustness_table_equals_jax(monkeypatch, capsys, tmp_path, p6_tree):
    """Both tools' orchestration on one harness stand-in: the variants in
    order, the config each hands its harness (JAX's also names its
    ``use_pallas`` switch, which the port's postprocess has not), each
    package's own scoring of the same detections; the tables equal exactly
    (the harnesses themselves are held to each other in
    tests/test_torch_harness.py)."""
    variant_root = _roots(tmp_path)
    argv = ["-c", p6_tree, "--img-size", "64", "-b", "2", "--n-val", "3", "--cpu"]
    jax_cfgs, port_cfgs = [], []
    monkeypatch.setattr(eval_robustness, "variant_root", variant_root)
    monkeypatch.setattr(harness, "run", _fake_run(port_cfgs))
    monkeypatch.setitem(sys.modules, "main", types.SimpleNamespace(run=_fake_run(jax_cfgs)))
    os.makedirs(tmp_path / "native")
    with private_native_builds(tmp_path / "native", coco_eval=True):
        jmod = jax_tool("eval_robustness")
        monkeypatch.setattr(jmod, "variant_root", variant_root)
        monkeypatch.setattr(sys, "argv", ["eval_robustness"] + argv
                            + ["-o", str(tmp_path / "jax.json")])
        jmod.main()
        want_out = capsys.readouterr().out
        got = eval_robustness.main(argv + ["-o", str(tmp_path / "port.json")])
        got_out = capsys.readouterr().out
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert got == want
    assert list(got) == list(eval_robustness.VARIANTS)
    assert all(0.1 < v["AP50"] < 1.0 for v in got.values())
    assert got_out == want_out
    for j, p in zip(jax_cfgs, port_cfgs):
        assert j["postprocess"].pop("use_pallas") is False
        assert p.pop("run_kw") == {"device": "cpu"} and j.pop("run_kw") == {}
        assert p == j


def test_eval_robustness_runs_the_port_harness(tmp_path, p6_tree):
    """The port's tool through the port's harness itself, on the CPU: 2 val
    images a variant at 64 px, bf16, random weights."""
    import cocodet_tpu_torch.tools.eval_robustness as er

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(er, "variant_root", _roots(tmp_path))
        table = er.main(["-c", p6_tree, "--img-size", "64", "-b", "2", "--n-val", "2",
                         "--cpu", "-o", str(tmp_path / "table.json")])
    assert list(table) == list(er.VARIANTS)
    for variant in er.VARIANTS:
        with open(tmp_path / variant / "detections.json") as f:
            assert len(json.load(f)) > 0
        assert 0.0 <= table[variant]["AP"] <= table[variant]["AP50"] <= 1.0
