"""The port's evaluation CLI (cocodet_tpu_torch/tools/eval.py) against
tools/eval.py of the JAX package on a synthetic COCO set (6 val JPEGs of
96-160 px, evaluated at 128 px, f32), through a ``.msgpack`` and a
reference ``.pth`` checkpoint, with ``--fuse`` and with ``--slim-spec``.

The weights are numpy-seeded; the head's objectness biases are set to 3,
its class biases to 3 for the synthetic set's classes and -6 for the rest,
and its box convs scaled by 0.05 (boxes of about e strides around each
anchor), so that every anchor proposes a box of one of the set's classes
and the AP of these random boxes is not 0.
The evaluated records (JAX's through its evaluator's ``output_json``) are
the same sets an image: the same count and classes, boxes within 0.01 px +
1e-3 relative and scores within 1e-4 (the convs sum in another order,
tests/test_torch_entry.py); the AP and AP50 the CLIs print (4 decimals)
agree within one printed step, 1e-4 (these random boxes score an AP50 of
about 1e-4). The legacy ValTransform's dataset items equal JAX's exactly.
"""

import importlib.util
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cocodet_tpu_torch.compress import load_slim_spec
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import eval as teval
from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
from cocodet_tpu_torch.utils.convert import random_variables
from cocodet_tpu_torch.utils.torch_import import export_state_dict
from torch_port_utils import SMALL_ARCH, private_native_builds, write_small_slim_spec

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ARCH = ["depth", "0.33", "width", "0.125", "compute_dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    with private_native_builds(tmp_path_factory.mktemp("jax_native"), coco_eval=True) as p:
        yield p


def _biased(variables):
    """The head's obj biases at 3, its cls biases at 3 for the synthetic
    classes and -6 for the others."""
    from cocodet_tpu_torch.data.synthetic import SYNTH_CLASSES

    head = variables["params"]["head"]
    for name, leaf in head.items():
        if name.startswith("obj_pred"):
            leaf["bias"] = np.full_like(leaf["bias"], 3.0)
        elif name.startswith("reg_pred"):  # boxes of a few strides around the anchors
            leaf["kernel"] = leaf["kernel"] * 0.05
            leaf["bias"] = np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
        elif name.startswith("cls_pred"):
            bias = np.full_like(leaf["bias"], -6.0)
            bias[:len(SYNTH_CLASSES)] = 3.0
            leaf["bias"] = bias
    return variables


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The COCO set and the checkpoints: unfused (msgpack and .pth, numpy
    seed 5) and fused slim (msgpack, seed 6, SMALL_SLIM_SPEC)."""
    d = tmp_path_factory.mktemp("eval_cli")
    root = make_synthetic_coco(str(d / "coco"), n_train=0, n_val=6, size_range=(96, 160),
                               seed=3)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    variables = _biased(random_variables(shapes, 5))
    msgpack = save_checkpoint({"model": variables}, False, str(d), "unfused")
    pth = str(d / "unfused.pth")
    torch.save({"model": export_state_dict(variables), "start_epoch": 1}, pth)
    spec = write_small_slim_spec(d)
    with torch.device("meta"):
        slim_shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=load_slim_spec(spec),
                            **SMALL_ARCH)
    slim = save_checkpoint({"model": _biased(random_variables(slim_shapes, 9))}, False, str(d),
                           "slim")
    return {"root": root, "msgpack": msgpack, "pth": pth, "slim": slim, "spec": spec}


def _jax_eval(argv, capsys, records_json):
    """JAX's tools/eval.py main: (AP, AP50) as printed, and its records."""
    from cocodet_tpu.evaluators.coco_evaluator import COCOEvaluator

    spec = importlib.util.spec_from_file_location("jax_eval", os.path.join(REPO, "tools",
                                                                          "eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    evaluate = COCOEvaluator.evaluate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["eval"] + argv)
        mp.setattr(COCOEvaluator, "evaluate", lambda self, *a, **k: evaluate(
            self, *a, **dict(k, output_json=records_json)))
        capsys.readouterr()
        module.main()
    out = capsys.readouterr().out
    ap, ap50 = re.search(r"AP50:95 = ([0-9.]+)\s+AP50 = ([0-9.]+)", out).groups()
    with open(records_json) as f:
        return float(ap), float(ap50), json.load(f)


def _assert_same_records(got, want):
    assert len(got) == len(want) > 100
    for img in {r["image_id"] for r in want}:
        gr = [r for r in got if r["image_id"] == img]
        wr = [r for r in want if r["image_id"] == img]
        assert sorted(r["category_id"] for r in gr) == sorted(r["category_id"] for r in wr)
        gb = np.asarray([r["bbox"] + [r["score"], r["category_id"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"], r["category_id"]] for r in wr])
        tol = np.concatenate([0.01 + 1e-3 * np.abs(wb[:, :4]), np.full((len(wb), 1), 1e-4),
                              np.zeros((len(wb), 1))], 1)
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1)
        assert close.any(1).all() and close.any(0).all(), img


CASES = {
    "msgpack": ("msgpack", []),
    "msgpack_fuse": ("msgpack", ["--fuse"]),
    "pth_fuse": ("pth", ["--fuse"]),
    "slim": ("slim", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_matches_jax(data, capsys, tmp_path, case):
    ckpt, flags = CASES[case]
    arch = ARCH
    if flags is None:  # the slim plan is drawn at width 0.25
        flags, arch = ["--slim-spec", data["spec"]], ["depth", "0.33", "width", "0.25",
                                                     "compute_dtype", "float32"]
    common = ["-c", data[ckpt], "-b", "4", "--tsize", "128", "--conf", "0.001", *flags]
    opts = ["data_dir", data["root"], *arch]
    *want, records = _jax_eval(["-f", os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"),
                                *common, *opts], capsys, str(tmp_path / "jax.json"))
    got = teval.main(["-f", os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                         "yolox_m_p6.py"), *common, "--device", "cpu", *opts])
    printed = capsys.readouterr().out
    assert f"AP50:95 = {got['ap']:.4f}  AP50 = {got['ap50']:.4f}" in printed
    _assert_same_records(got["records"], records)
    np.testing.assert_allclose([got["ap"], got["ap50"]], want, atol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(data, tmp_path):
    """``--dist-coordinator/--num-processes/--process-id``: two processes on
    one ``tcp://`` rendezvous, each evaluating half the set; the AP they
    print equals the one-process AP."""
    argv = ["-f", os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py"),
            "-c", data["msgpack"], "-b", "2", "--tsize", "128", "--device", "cpu",
            "data_dir", data["root"], *ARCH]
    one = teval.main(argv)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    logs = [tmp_path / f"p{i}.log" for i in range(2)]
    procs = []
    for i, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cocodet_tpu_torch.tools.eval", *argv[:-len(ARCH) - 2],
                 "--dist-coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(i), "data_dir", data["root"], *ARCH],
                env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT))
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        assert p.returncode == 0, log.read_text()[-4000:]
        assert f"AP50:95 = {one['ap']:.4f}  AP50 = {one['ap50']:.4f}" in log.read_text()


def test_speed_on_cpu(data, capsys):
    out = teval.main(["-f", os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                         "yolox_m_p6.py"), "-b", "2", "--tsize", "64",
                      "--speed", "--device", "cpu", *ARCH])
    assert out["device"] == "cpu" and out["img_s"] > 0
    assert "img/s" in capsys.readouterr().out


def test_legacy_val_transform_matches_jax(data):
    """exp.get_eval_dataset(legacy=True): BGR -> RGB, /255, the ImageNet mean
    and std, on the letterboxed image, item for item as JAX's."""
    from cocodet_tpu.exp import get_exp as jax_get_exp
    from cocodet_tpu_torch.exp import get_exp

    items = []
    for get, path in ((get_exp, os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                              "yolox_m_p6.py")),
                      (jax_get_exp, os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"))):
        exp = get(path, None)
        exp.merge(["data_dir", data["root"]])
        exp.test_size = (128, 128)
        ds = exp.get_eval_dataset(legacy=True)
        items.append([ds[i] for i in range(len(ds))])
    for g, w in zip(*items):
        img, want_img = np.asarray(g[0]), np.asarray(w[0])
        assert img.dtype == want_img.dtype == np.float32
        np.testing.assert_array_equal(img, want_img)
        assert -3 < img.min() < img.max() < 3  # normalised, not 0-255
        np.testing.assert_array_equal(np.asarray(g[2]), np.asarray(w[2]))
        assert int(g[3]) == int(w[3])
