"""The port's harness on several ranks (cocodet_tpu_torch/harness.py:
``data_parallel``, ``spatial_partition``, both) against its one-process run
and against JAX's harness/main.py on its 8 virtual CPU devices
(tests/conftest.py), as tests/test_harness_dp.py runs it.

The ranks are gloo processes on the CPU, spawned by ``harness.serve``
(``parallel/launch.py::run_ranks``). The folder holds 10 images served at
192 px in batches of 8: a full batch and a ragged tail, buckets 192, 128
and 64 rows high, so the space ranks split a batch evenly (128: one deepest
row each), unevenly (192: two and one) and not at all (64: one row for two
ranks, the batch runs whole on each). Records: the same count, image ids
and categories in the same order; boxes and scores at the tolerances of
tests/test_torch_harness.py::test_run_matches_jax (0.02 px + 1e-3
relative, 1e-4 + 1e-5: a rank's convs run on its own rows, and oneDNN may
sum them in another order), matched as sets within an image.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cocodet_tpu_torch import harness
from cocodet_tpu_torch.data.image_io import write_image
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
from cocodet_tpu_torch.utils.convert import random_variables
from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 192
# (h, w) of the images: 192-, 128- and 64-row buckets after the resize
SHAPES = [(192, 192), (180, 170), (150, 192), (192, 100), (120, 192), (100, 190),
          (60, 192), (50, 180), (192, 192), (128, 192)]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_harness_main", os.path.join(REPO, "harness", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The folder and a fused deployment checkpoint (numpy seed 1)."""
    root = tmp_path_factory.mktemp("ranks")
    folder = root / "images"
    folder.mkdir()
    rs = np.random.RandomState(5)
    for i, (h, w) in enumerate(SHAPES):
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img[h // 4: h // 2, w // 4: w // 2] = rs.randint(0, 256, 3)
        write_image(str(folder / f"{i + 1:012d}.png"), img)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    ckpt = save_checkpoint({"model": random_variables(shapes, 1)}, False, str(root), "deploy")
    return str(folder), ckpt


def _cfg(setup, dp=False, sp=False):
    folder, ckpt = setup
    return {"model": {"type": "yolox-p6", "depth": 0.33, "width": 0.125}, "ckpt": ckpt,
            "img_size": SIZE, "half": False, "data_dir": folder,
            "dataloader": {"batch_size": 8},
            "postprocess": {"conf_threshold": 0.3, "nms_threshold": 0.65,
                            "max_num_nms": 128, "max_num_det": 16},
            "input_aug": True, "data_parallel": dp, "spatial_partition": sp}


def _by_image(records):
    out = {}
    for r in records:
        out.setdefault(r["image_id"], []).append(r)
    return out


def _assert_records_match(got, want):
    """Same images in the same order, the same count and categories an
    image, boxes and scores within the module's tolerances."""
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    g, w = _by_image(got), _by_image(want)
    for img, wr in w.items():
        gr = g[img]
        assert sorted(r["category_id"] for r in gr) == sorted(r["category_id"] for r in wr)
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        tol = np.concatenate([0.02 + 1e-3 * np.abs(wb[:, :4]),
                              np.full((len(wb), 1), 1e-4 + 1e-5)], 1)
        same_cat = (np.asarray([r["category_id"] for r in gr])[:, None]
                    == np.asarray([r["category_id"] for r in wr])[None])
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1) & same_cat
        assert close.any(1).all() and close.any(0).all(), img


@pytest.fixture(scope="module")
def single(setup, tmp_path_factory):
    """The port's one-process records and JAX's single-device records."""
    out = tmp_path_factory.mktemp("single")
    port = harness.run(_cfg(setup), str(out / "port.json"), device="cpu")
    jax_records = _jax_harness().run(_cfg(setup), str(out / "jax.json"))
    assert len(port) >= len(SHAPES) and sum(r["score"] > 0 for r in port) > 10
    _assert_records_match(port, jax_records)
    return port


@pytest.mark.parametrize("mode,ranks", [("dp", 2), ("sp", 2), ("dp+sp", 4)])
def test_ranks_match_one_process_and_jax(setup, single, tmp_path, mode, ranks):
    """data_parallel on 2 ranks (a ragged tail of 2), spatial_partition 2 on
    2, both on a (2 data x 2 space) mesh of 4; JAX's harness under the same
    config on its 8 devices ((8,), 2 of 8 and a (4, 2) mesh)."""
    dp, sp = {"dp": (True, False), "sp": (False, 2), "dp+sp": (True, 2)}[mode]
    cfg = _cfg(setup, dp, sp)
    out = str(tmp_path / "ranks.json")
    report = harness.serve(cfg, out, ranks, "cpu", timeout=600)
    got = json.loads(open(out).read())
    assert len(report["ranks"]) == ranks and report["images"] == len(SHAPES)
    _assert_records_match(got, single)
    if sp:  # the halos and the head maps went over the space group
        calls = report["ranks"][0]["collectives"]
        assert calls.get("all_gather", 0) > 100
    want = _jax_harness().run(cfg, str(tmp_path / "jax.json"))
    _assert_records_match(got, want)


def test_main_spawns_ranks(setup, single, tmp_path, capsys):
    """The CLI's ``-d``: data_parallel on 2 ranks (with ``--profile``, rank 0
    prints every rank's seconds); a config with neither mode runs one rank
    whatever -d says."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_cfg(setup, dp=True)))
    harness.main(["--config", str(path), "-d", "2", "--device", "cpu", "--profile",
                  "--out", str(tmp_path / "dp.json")])
    _assert_records_match(json.loads((tmp_path / "dp.json").read_text()), single)
    assert harness.serving_ranks(_cfg(setup), 4) == 1
    assert harness.serving_ranks(_cfg(setup, sp=2), 4) == 2
    assert harness.serving_ranks(_cfg(setup, dp=True, sp=2), 4) == 4


@pytest.mark.parametrize("over,n", [
    ({"data_parallel": True, "dataloader": {"batch_size": 3}}, 8),
    ({"data_parallel": True, "spatial_partition": True}, 8),
    ({"data_parallel": True, "spatial_partition": 2, "dataloader": {"batch_size": 6}}, 8),
    ({"spatial_partition": 3}, 8),
    ({"spatial_partition": 16}, 8),
    ({"spatial_partition": 2}, 1),
])
def test_validation_errors_are_jax(setup, tmp_path, over, n):
    """Each mode check raises JAX's ValueError with JAX's message, before
    the first batch (JAX on its first n of 8 virtual devices)."""
    import jax

    cfg = {**_cfg(setup), **over}
    jh = _jax_harness()
    devices = jax.devices()[:n]
    # the checks come before JAX's harness touches the model
    jh.build_model_and_vars = lambda cfg: (None, {"params": {}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: devices)
        with pytest.raises(ValueError) as want:
            jh.run(cfg, str(tmp_path / "x.json"))
    with pytest.raises(ValueError) as got:
        harness.serving_modes(cfg, n, 64)
    assert str(got.value) == str(want.value)


def _w8a8_cfg(setup, tmp_path, **over):
    """_cfg with a w8a8 checkpoint: the port's PTQ (per-channel activation
    scales) of numpy seed 1 fused weights, as tools/quantize_model.py
    writes it."""
    from cocodet_tpu_torch.compress import build_quant_tree, calibrate, quantize_weights
    from cocodet_tpu_torch.models import build_model

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    variables = random_variables(shapes, 1)
    calib = build_model("yolox-p6", depth=0.33, width=0.125, fused=True, quant="calib",
                        device="cpu", variables=variables)
    stats = calibrate(calib, variables, [np.random.RandomState(1).rand(2, 128, 128, 3) * 255])
    qvars, quant = quantize_weights(variables, build_quant_tree(stats, per_channel_act=True))
    cfg = _cfg(setup, **over)
    cfg.update(quant="w8a8", ckpt=save_checkpoint({"params": qvars["params"], "quant": quant},
                                                  False, str(tmp_path), "int8"))
    return cfg


def test_w8a8_spatial_raises(setup, tmp_path):
    """A w8a8 model shards its height (it raised before the int8 conv took a
    slab with its halo rows): on 2 space ranks its records equal one
    process's, and the halos went over the space group."""
    cfg = _w8a8_cfg(setup, tmp_path)
    one = harness.run(cfg, str(tmp_path / "one.json"), device="cpu")
    assert sum(r["score"] > 0 for r in one) > 10
    out = str(tmp_path / "ranks.json")
    report = harness.serve(dict(cfg, spatial_partition=2), out, 2, "cpu", timeout=300)
    assert report["ranks"][0]["collectives"].get("all_gather", 0) > 100
    _assert_records_match(json.loads(open(out).read()), one)


def test_w8a8_latency_graph_on_space_ranks(setup, tmp_path):
    """The w8a8 latency graph (stem6 + split_cat: the 6x6 stem and the parts
    convs on slabs) on 2 space ranks: the records of one process of the
    plain w8a8 graph."""
    cfg = _w8a8_cfg(setup, tmp_path)
    one = harness.run(cfg, str(tmp_path / "one.json"), device="cpu")
    out = str(tmp_path / "ranks.json")
    harness.serve(dict(cfg, spatial_partition=2, stem6=True, split_cat=True), out, 2, "cpu",
                  timeout=300)
    _assert_records_match(json.loads(open(out).read()), one)
