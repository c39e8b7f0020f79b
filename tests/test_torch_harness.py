"""The port's submission harness (cocodet_tpu_torch/harness.py) against
harness/main.py::run of the JAX package.

Both run a depth 0.33 / width 0.125 YOLOX-M-P6 at 128 px in f32 on images
whose long side is 128, where the resize is a copy in both. JAX's harness
serves the variables the port draws from numpy seed 0 when it has no
checkpoint (its own PRNGKey(0) init scores every anchor below conf 0.001,
so every record would be a dummy); the port is handed them with
``variables=`` and must also draw them itself.
The records match: the same count, image ids (ints from digit names,
strings otherwise), categories and dummy records for images without
detections; boxes and scores agree at tests/test_torch_entry.py's
tolerances (0.01 px + 1e-3 relative, 1e-4: the convs sum in another
order) plus one step of the harness's rounding (0.01 px, 1e-5), matched as
sets within an image (of the 39 records here, 38 are equal field for
field). The resized case is held by
tests/test_torch_eval_data.py, exactly.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocodet_tpu_torch import harness
from cocodet_tpu_torch.data.image_io import write_image
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.utils.convert import random_variables
from torch_port_utils import private_native_builds


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native letterbox, built for this process before any JAX
    reference runs (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_harness_main", os.path.join(REPO, "harness", "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """5 synthetic 128 x 128 images with annotations, and two more whose
    long side is 128: one with a non-digit name, one blank."""
    root = str(tmp_path_factory.mktemp("harness"))
    make_synthetic_coco(root, n_train=0, n_val=5, size_range=(SIZE, SIZE), seed=4)
    rs = np.random.RandomState(0)
    write_image(os.path.join(root, "val2017", "extra_a.png"),
                rs.randint(0, 256, (SIZE, 80, 3)).astype(np.uint8))
    write_image(os.path.join(root, "val2017", "000000000099.png"),
                np.full((64, SIZE, 3), 114, np.uint8))
    return root


def _config(root, **over):
    with open(os.path.join(REPO, "harness", "config", "yolox_m_p6.json")) as f:
        cfg = json.load(f)
    cfg.update(img_size=SIZE, half=False, data_dir=os.path.join(root, "val2017"),
               annotation=os.path.join(root, "annotations", "instances_val2017.json"),
               ckpt=os.path.join(root, "no_such_checkpoint.msgpack"))
    cfg["model"].update(depth=0.33, width=0.125)
    cfg["dataloader"]["batch_size"] = 2
    cfg["postprocess"].update(over)
    return cfg


def _by_image(records):
    out = {}
    for r in records:
        out.setdefault(r["image_id"], []).append(r)
    return out


def test_run_matches_jax(folder, tmp_path):
    """At conf 0.5, so that some images keep detections and one gets the
    dummy record. JAX's harness runs without the annotation file: its
    self-evaluation sorts the file-name id "extra_a.png" among ints and
    raises (the port's maps it through the annotations' file names)."""
    jh = _jax_harness()
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    variables = random_variables(shapes, 0)
    build = jh.build_model_and_vars

    def serve_numpy_seed(cfg, rng_seed=0):
        model, _ = build(cfg, rng_seed)
        return model, jax.tree_util.tree_map(jnp.asarray, variables)

    jh.build_model_and_vars = serve_numpy_seed
    cfg = _config(folder, conf_threshold=0.5)
    cfg["annotation"] = None
    want = jh.run(cfg, str(tmp_path / "jax.json"), challenge=True)
    report = {}
    got = harness.run(_config(folder, conf_threshold=0.5), str(tmp_path / "port.json"),
                      profile=True, challenge=True, variables=variables,
                      device="cpu", report=report)
    assert got == harness.run(_config(folder, conf_threshold=0.5), str(tmp_path / "seed.json"),
                              challenge=True, device="cpu")
    assert got == json.loads((tmp_path / "port.json").read_text())
    g = _by_image(got[1:])
    assert "extra_a.png" in g and 99 in g
    assert all(r["segmentation"] == [] for r in got[1:])
    dummies = _assert_records_match(got, want)
    assert 0 < dummies < len(got) - 1  # some images have detections, some a dummy
    assert report["images"] == 7 and report["stats"] is not None
    assert sorted(report["phases"]) == ["convert", "forward+nms", "h2d", "json", "setup",
                                        "warmup"]
    assert sorted(set(report["shapes"])) == [(2, 128, 128, 3)]


def _assert_records_match(got, want):
    """The records of test_run_matches_jax's comparison, at its tolerances;
    returns the number of dummy records."""
    assert got[0]["parameters"] == want[0]["parameters"]
    g, w = _by_image(got[1:]), _by_image(want[1:])
    assert list(g) == list(w)
    dummies = 0
    for img, wr in w.items():
        gr = g[img]
        assert len(gr) == len(wr), img
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        tol = np.concatenate([0.02 + 1e-3 * np.abs(wb[:, :4]),
                              np.full((len(wb), 1), 1e-4 + 1e-5)], 1)
        same_cat = (np.asarray([r["category_id"] for r in gr])[:, None]
                    == np.asarray([r["category_id"] for r in wr])[None])
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1) & same_cat
        assert close.any(1).all() and close.any(0).all(), img
        dummies += sum(r["score"] == 0.0 for r in wr)
    return dummies


def test_checkpoint_matches_jax(folder, tmp_path):
    """A fused deployment tree written by JAX's ``save_checkpoint`` (numpy
    seed 1 weights): the port's harness reads it with its own reader and
    gives the records JAX's harness gives from the same file, at
    test_run_matches_jax's tolerances; the records differ from the seed-0
    weights served without a checkpoint."""
    from cocodet_tpu.utils.checkpoint import save_checkpoint

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    variables = random_variables(shapes, 1)
    ckpt = save_checkpoint({"model": variables}, False, str(tmp_path), "deploy")
    cfg = _config(folder, conf_threshold=0.5)
    cfg.update(ckpt=ckpt, annotation=None)
    want = _jax_harness().run(cfg, str(tmp_path / "jax.json"), challenge=True)
    got = harness.run(cfg, str(tmp_path / "port.json"), challenge=True, device="cpu")
    dummies = _assert_records_match(got, want)
    assert 0 < dummies < len(got) - 1
    cfg["ckpt"] = None
    assert harness.run(cfg, str(tmp_path / "seed.json"), challenge=True, device="cpu") != got


def test_checkpoint_on_disk_raises(folder, tmp_path):
    """What the port cannot load raises: a corrupt .pth (``torch.load``'s own
    error), a tree that matches no parameter (never random weights under a
    checkpoint's name), a w8a8 config on a checkpoint without a ``quant``
    collection (JAX's ValueError)."""
    from cocodet_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _config(folder)
    pth = tmp_path / "weights.pth"
    pth.write_bytes(b"\x80")
    with pytest.raises(Exception) as corrupt:
        torch.load(str(pth), map_location="cpu", weights_only=True)
    cfg["ckpt"] = str(pth)
    with pytest.raises(type(corrupt.value)):
        harness.run(cfg, str(tmp_path / "out.json"), device="cpu")
    empty = tmp_path / "weights.msgpack"
    empty.write_bytes(b"\x80")  # msgpack's empty map
    cfg["ckpt"] = str(empty)
    with pytest.raises(ValueError, match="matches no parameter"):
        harness.run(cfg, str(tmp_path / "out.json"), device="cpu")
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    cfg["ckpt"] = save_checkpoint({"model": {"params": random_variables(shapes, 1)["params"]}},
                                  False, str(tmp_path), "float")
    cfg["quant"] = "w8a8"
    with pytest.raises(ValueError, match="no 'quant' collection"):
        harness.run(cfg, str(tmp_path / "out.json"), device="cpu")


def test_pth_matches_jax(folder, tmp_path):
    """A reference ``.pth`` (numpy seed 2 fused weights in the reference's
    naming, the backbone's kernels as sparse COO tensors, as
    03_jh_merge.py stores merged_49.pth): the port's harness gives JAX's
    harness's records on the same file at test_run_matches_jax's
    tolerances, and exactly its own records of the same tree from msgpack."""
    from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
    from cocodet_tpu_torch.utils.torch_import import export_state_dict

    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125, fused=True)
    variables = random_variables(shapes, 2)
    sd = {k: (v.to_sparse() if k.startswith("backbone.backbone.") and v.dim() == 4 else v)
          for k, v in export_state_dict(variables).items()}
    assert sum(v.is_sparse for v in sd.values()) > 20
    pth = tmp_path / "merged_p6.pth"
    torch.save(sd, pth)
    cfg = _config(folder, conf_threshold=0.5)
    cfg.update(ckpt=str(pth), annotation=None)
    want = _jax_harness().run(cfg, str(tmp_path / "jax.json"), challenge=True)
    got = harness.run(cfg, str(tmp_path / "port.json"), challenge=True, device="cpu")
    assert _assert_records_match(got, want) < len(got) - 1  # some detections
    cfg["ckpt"] = save_checkpoint({"model": variables}, False, str(tmp_path), "same")
    assert harness.run(cfg, str(tmp_path / "msgpack.json"), challenge=True, device="cpu") == got


@pytest.mark.parametrize("slim", [False, True])
def test_w8a8_checkpoint_matches_jax(folder, tmp_path, slim):
    """A w8a8 checkpoint (params with int8 kernels and the ``quant``
    collection, as tools/quantize_model.py writes it; the port's PTQ of
    numpy seed 3 fused weights) with and without a slim spec on disk: the
    port's harness and JAX's serve it to the same records. JAX's jitted
    step quantizes activations with XLA's division, which moves some
    quantized inputs by one step (tests/test_torch_headline.py), so boxes
    are held at 0.5 px + 1% and scores at 1e-3, matched as sets within an
    image."""
    from cocodet_tpu_torch.compress import calibrate, build_quant_tree, quantize_weights
    from cocodet_tpu_torch.compress import load_slim_spec
    from cocodet_tpu_torch.models import build_model
    from cocodet_tpu_torch.utils.checkpoint import save_checkpoint
    from torch_port_utils import SMALL_ARCH, write_small_slim_spec

    arch = SMALL_ARCH if slim else dict(depth=0.33, width=0.125)
    spec_path = write_small_slim_spec(tmp_path) if slim else None
    spec = load_slim_spec(spec_path) if slim else None
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=spec, **arch)
    variables = random_variables(shapes, 3)
    calib = build_model("yolox-p6", fused=True, slim=spec, quant="calib", device="cpu",
                        variables=variables, **arch)
    stats = calibrate(calib, variables, [np.random.RandomState(1).rand(2, 128, 128, 3) * 255])
    qvars, quant = quantize_weights(variables, build_quant_tree(stats, per_channel_act=True))
    ckpt = save_checkpoint({"params": qvars["params"], "quant": quant}, False, str(tmp_path),
                           "int8")
    cfg = _config(folder, conf_threshold=0.3)
    cfg["model"].update(arch)
    cfg.update(ckpt=ckpt, quant="w8a8", slim_spec=spec_path, annotation=None)
    want = _jax_harness().run(cfg, str(tmp_path / "jax.json"), challenge=True)
    got = harness.run(cfg, str(tmp_path / "port.json"), challenge=True, device="cpu")
    assert got[0]["parameters"] == want[0]["parameters"]
    g, w = _by_image(got[1:]), _by_image(want[1:])
    assert list(g) == list(w)
    n_det = 0
    for img, wr in w.items():
        gr = g[img]
        assert len(gr) == len(wr), img
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        tol = np.concatenate([0.5 + 1e-2 * np.abs(wb[:, :4]), np.full((len(wb), 1), 1e-3)], 1)
        same_cat = (np.asarray([r["category_id"] for r in gr])[:, None]
                    == np.asarray([r["category_id"] for r in wr])[None])
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1) & same_cat
        assert close.any(1).all() and close.any(0).all(), img
        n_det += sum(r["score"] > 0 for r in wr)
    assert n_det > 0


@pytest.mark.parametrize("over", [{"stem6": True}, {"split_cat": True}])
def test_unported_options_raise(folder, tmp_path, over):
    """The float latency graph serves (tests/test_torch_split_cat.py); a
    w8a8 model with either rewrite still raises (ROADMAP Queue 1 item 3)."""
    cfg = _config(folder)
    cfg.update(over, quant="w8a8")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        harness.run(cfg, str(tmp_path / "out.json"), device="cpu")


def test_jpeg_input_raises(tmp_path):
    import cv2

    d = tmp_path / "imgs"
    d.mkdir()
    # the port reads baseline JPEG (the folder fixture's images are JPEG); a
    # progressive one is refused by name
    cv2.imwrite(str(d / "000000000001.jpg"), np.zeros((SIZE, SIZE, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cfg = _config(str(tmp_path))
    cfg["data_dir"] = str(d)
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        harness.run(cfg, str(tmp_path / "out.json"), device="cpu")


def test_main_dummy_on_cpu(folder, tmp_path, capsys):
    """The CLI, its overrides and --dummy; no checkpoint: random weights
    from numpy seed 0 and the JAX harness's warning."""
    cfg = _config(folder)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    harness.main(["--config", str(path), "--dummy", "--device", "cpu", "--img-size", "64",
                  "--batch-size", "3", "--out", str(tmp_path / "out.json")])
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint" in out
    assert "dummy forward ok: (3, 300, 4)" in out
