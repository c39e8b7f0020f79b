"""The one-command chain of the port (cocodet_tpu_torch/tools/run_pipeline.py)
against JAX's (tools/run_pipeline.py), on the CPU. All exact:

- ``STAGES``, and ``follow_chain_ckpt`` on the directory trees of
  tests/test_pipeline_resume.py (a direct hit, one and two levels of
  ``chain_src.txt`` lineage, a dead end, a cycle): the same answers;
- ``_tiny_overrides`` and ``_synth_overrides`` on each stage's exp (the
  port's exp files against JAX's): every attribute equal;
- ``make_fake_coco`` (the ``--tiny`` data): the JPEG bytes and the JSON of
  JAX's tests/synthetic.py, which draws with cv2;
- one ``--tiny`` chain of the port on the CPU (~30 s): ``pipeline_results.json``
  with the keys JAX's chain writes, parameter counts that are the trees',
  and a slim spec that ``entry.build_headline`` loads and serves.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from cocodet_tpu.exp import get_exp as jax_get_exp
from cocodet_tpu_torch.data.synthetic import make_fake_coco
from cocodet_tpu_torch.entry import build_headline
from cocodet_tpu_torch.exp import get_exp
from cocodet_tpu_torch.tools import run_pipeline as rp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from synthetic import make_fake_coco as jax_make_fake_coco  # noqa: E402

_spec = importlib.util.spec_from_file_location("jax_run_pipeline",
                                               os.path.join(REPO, "tools", "run_pipeline.py"))
jrp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jrp)

# the keys JAX's chain writes in --tiny (tools/run_pipeline.py:250-411), every
# stage run and evaluated, the pruned model slimmed
JAX_KEYS = [f"{s}_{k}" for s in ("phase1", "phase2", "prune", "tune")
            for k in ("loss", "AP50", "AP")] + [
    "deploy_stage", "slim_layers", "params_dense", "params_slim", "param_ratio", "mAP", "AP50"]


def test_stages_equal_jax():
    assert rp.STAGES == jrp.STAGES


def _ckpt(root, name):
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(os.path.join(d, "latest_ckpt.msgpack"), "wb") as f:
        f.write(b"x")


def _tree(tmp, case):
    """tests/test_pipeline_resume.py's trees; returns the directory to
    resolve from."""
    dirs = {n: os.path.join(tmp, n) for n in ("full", "prune_rerun", "tune_rerun", "a", "b")}
    for d in dirs.values():
        os.makedirs(d)

    def link(src, dst):
        with open(os.path.join(dirs[src], "chain_src.txt"), "w") as f:
            f.write(dirs[dst])

    if case == "direct":
        _ckpt(dirs["full"], "pipe_phase2")
        return dirs["full"]
    if case == "one_level":
        _ckpt(dirs["full"], "pipe_phase2")
        link("prune_rerun", "full")
        return dirs["prune_rerun"]
    if case == "two_level":
        _ckpt(dirs["full"], "pipe_phase2")
        _ckpt(dirs["prune_rerun"], "pipe_prune")
        link("prune_rerun", "full")
        link("tune_rerun", "prune_rerun")
        return dirs["tune_rerun"]
    if case == "dead_end":
        return dirs["tune_rerun"]
    link("a", "b")
    link("b", "a")
    return dirs["a"]


@pytest.mark.parametrize("case", ["direct", "one_level", "two_level", "dead_end", "cycle"])
def test_follow_chain_ckpt_equals_jax(tmp_path, case):
    base = _tree(str(tmp_path), case)
    for name in ("pipe_phase2", "pipe_prune"):
        assert rp.follow_chain_ckpt(base, name) == jrp.follow_chain_ckpt(base, name)
    if case == "two_level":
        assert rp.follow_chain_ckpt(base, "pipe_phase2") == os.path.join(
            str(tmp_path), "full", "pipe_phase2", "latest_ckpt.msgpack")


def _attributes(exp):
    return {k: getattr(exp, k) for k in dir(exp)
            if not k.startswith("_") and not callable(getattr(exp, k))}


@pytest.mark.parametrize("mode", ["tiny", "synth", "as_shipped"])
@pytest.mark.parametrize("stage", ["phase1", "phase2", "prune", "tune"])
def test_stage_exps_and_overrides_equal_jax(stage, mode):
    port = get_exp(exp_file=os.path.join(rp.PACKAGE, "exps", rp.EXPS[stage]))
    jax_exp = jax_get_exp(exp_file=os.path.join(REPO, "exps", rp.EXPS[stage]))
    for mod, exp in ((rp, port), (jrp, jax_exp)):
        if mode == "tiny":
            mod._tiny_overrides(exp, "/data/coco", max_epoch=2, lr=2e-4)
        elif mode == "synth":
            mod._synth_overrides(exp, "/data/coco", size=320, max_epoch=6, lr=2.5e-5)
    assert _attributes(port) == _attributes(jax_exp)


def test_phase2_exp_sizes():
    """The phase-2 exp trains at 896 with GIoU; its multiscale (-1, 1) at
    step 64 draws 832-960, which the 4-level model takes (stride 64)."""
    exp = get_exp(exp_file=os.path.join(rp.PACKAGE, "exps", rp.EXPS["phase2"]))
    assert exp.input_size == (896, 896) and exp.iou_type == "giou"
    assert exp.bn_momentum == 0.01 and exp.exp_name == "yolox_m_p6_tune_tune"
    assert exp.multiscale_sizes() == [(832, 832), (896, 896), (960, 960)]
    assert all(s % max(exp.strides) == 0 for s, _ in exp.multiscale_sizes())


def test_make_fake_coco_equals_jax(tmp_path):
    a = jax_make_fake_coco(str(tmp_path / "jax"), n_images=5)
    b = make_fake_coco(str(tmp_path / "port"), n_images=5)
    for d in ("train2017", "val2017", "annotations"):
        names = sorted(os.listdir(os.path.join(a, d)))
        assert names == sorted(os.listdir(os.path.join(b, d))) and names
        for n in names:
            with open(os.path.join(a, d, n), "rb") as f1, open(os.path.join(b, d, n), "rb") as f2:
                assert f1.read() == f2.read(), (d, n)


def test_tiny_chain_on_the_cpu(tmp_path):
    out = str(tmp_path / "pipe")
    stats = {}
    results = rp.main(["--tiny", "--cpu", "--out", out], stats)
    with open(os.path.join(out, "pipeline_results.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(results))
    assert list(written) == JAX_KEYS
    assert written["deploy_stage"] == "tune" and written["slim_layers"] > 0
    assert written["params_slim"] <= written["params_dense"] > 0
    assert all(np.isfinite(written[f"{s}_loss"]) for s in ("phase1", "phase2", "prune", "tune"))
    seconds = stats["seconds"]
    assert set(seconds) == {"phase1", "phase2", "prune", "tune", "compress", "harness"}
    headline = build_headline(os.path.join(out, "pipe_slim_spec.json"), depth=0.33,
                              width=0.125, dtype=torch.float32, device="cpu")
    res = headline(np.random.RandomState(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32))
    assert res.boxes.shape[0] == 1
