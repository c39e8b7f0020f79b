"""The ``--synth`` recipe's lr from random weights, in JAX's Trainer and the
port's: a witness that the reference's training grows the stem's weights
and BN's running variance as the port's does.

At full width on the card (``chip_smoke.py`` phase m3, YOLOX-M-P6 at depth
0.67 width 0.75, 640 px, B=16) ``run_pipeline --synth``'s lr of 2.5e-4 an
image takes BN's largest running variance to ~4e15 within the chain's first
stages, and the Pruner's eval-mode score step then sees NaN; phase m3 cuts
the lr. The full width does not run on this CPU. Here both Trainers run the
phase-1 exp under their own ``_synth_overrides`` (1 epoch of 4 iterations,
all of it warmup, no aug), at depth 0.67 width 0.5, 128 px, B=16, f32,
from one init checkpoint (the port's ``random_variables``, seed 0, which
the port's Trainer draws itself) on one synthetic JPEG set with one loader
worker. What is held:

- the first batch, images and labels: exact;
- after the first step (lr 0 at the warmup's start) the stem kernel's
  largest |w| within 1e-6 and BN's largest running variance within 1e-5
  relative: the same model saw the same batch;
- after the fourth, in each framework, the stem's largest |w| at least 4x
  its initial value and the largest running variance at least 20x its
  value after the first step (measured with this file on the CPU: JAX
  5.9x and 34.7x, the port 8.2x and 60.3x), and the two running variances
  within a factor 4 of each other.

The f32 runs part after the first step: on this batch JAX's f32 SimOTA
assigns 77 foregrounds where the port's f32 step and both frameworks'
f64 steps assign 78 (num_fg_per_gt 1.0267 against 1.04), so the losses
already differ by up to 2.6% (l1). ``test_first_step_assignment_matches_
jax_f64`` (slow) holds that first step in f64, where the two agree, and
the port's f32 foreground count to f64's.
"""

import os

import jax
import numpy as np
import pytest
import torch

import cocodet_tpu.core.trainer as jtr
import torch_train_utils as ttu
from cocodet_tpu.exp import get_exp_by_file as jax_exp
from cocodet_tpu_torch.core import trainer as ptr
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.exp import get_exp_by_file as port_exp
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.tools import run_pipeline as rp
from cocodet_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree, random_variables
from test_torch_run_pipeline import jrp
from test_torch_trainer import jax_setup
from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, WIDTH, SIZE, BATCH = 0.67, 0.5, 128, 16
STEM = ("backbone", "backbone", "stem", "conv", "conv", "kernel")
PARTS = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss")


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's Trainer letterboxes its batches through its native library
    (cocodet_tpu/data/transforms.py::letterbox), and takes cv2's resize
    without a word where that library did not load, as when another test
    process rebuilds it in place: then the first batches differ. This
    module's process builds its own and asserts that it loads
    (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


def _watch(params, stats):
    """(the stem kernel's largest |w|, BN's largest running variance)."""
    var = max(float(np.abs(v).max()) for k, v in flatten_tree(stats).items() if k[-1] == "var")
    return float(np.abs(flatten_tree(params)[STEM]).max()), var


def _initial_stem(runs):
    return float(np.abs(flatten_tree(load_checkpoint(runs["init"])["model"]["params"])[STEM]).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("synth_lr"))
    root = make_synthetic_coco(os.path.join(tmp, "coco"), n_train=4 * BATCH, n_val=4,
                               size_range=(256, 512), seed=2)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=DEPTH, width=WIDTH)
    init = save_checkpoint({"model": random_variables(shapes, 0, prior_prob=0.01)}, False, tmp,
                           "init")
    mp = pytest.MonkeyPatch()
    out = {"init": init}
    try:
        jax_setup(mp, init)
        for name, factory, overrides, path, module in (
                ("jax", jax_exp, jrp._synth_overrides,
                 os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"), jtr),
                ("port", port_exp, rp._synth_overrides,
                 os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py"), ptr)):
            exp = overrides(factory(path), root, size=SIZE, max_epoch=1)
            exp.merge(["depth", str(DEPTH), "width", str(WIDTH), "compute_dtype", "float32",
                       "data_num_workers", "1", "output_dir", os.path.join(tmp, name)])
            exp.init_ckpt = init
            args = rp.Args()
            args.batch_size = BATCH
            t = module.Trainer(exp, args, **({"device": "cpu"} if name == "port" else {}))
            t.evaluate_and_save_model = lambda: None
            t.before_train()
            real, log, first = t.train_step, [], []
            if name == "jax":
                def step(state, images, labels, real=real, log=log, first=first, **kw):
                    first.append((np.asarray(images), np.asarray(labels)))
                    state, m = real(state, images, labels, **kw)
                    log.append(({k: float(m[k]) for k in PARTS},
                                _watch(*jax.device_get((state.params, state.batch_stats)))))
                    return state, m
            else:
                def step(images, labels, real=real, log=log, first=first, t=t, **kw):
                    first.append((images.numpy().copy(), labels.numpy().copy()))
                    m = real(images, labels, **kw)
                    v = export_variables(t.model)
                    log.append(({k: float(m[k]) for k in PARTS},
                                _watch(v["params"], v["batch_stats"])))
                    return m
            t.train_step = step
            for t.epoch in range(t.start_epoch, t.max_epoch):  # Trainer.train, no evaluation
                t.before_epoch()
                t.train_in_iter()
                t.after_epoch()
            if name == "port":
                t.after_train()
            out[name] = {"log": log, "first": first[0]}
        yield out
    finally:
        mp.undo()


def test_both_trainers_see_the_same_first_batch(runs):
    (ji, jl), (pi, pl) = runs["jax"]["first"], runs["port"]["first"]
    assert pi.shape == ji.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)


def test_first_step_state_matches_jax(runs):
    (_, (jw, jv)), (_, (pw, pv)) = runs["jax"]["log"][0], runs["port"]["log"][0]
    stem0 = _initial_stem(runs)
    assert abs(jw - stem0) <= 1e-6 and abs(pw - stem0) <= 1e-6
    assert abs(pv - jv) <= 1e-5 * jv


def test_synth_lr_grows_the_stem_in_jax_as_in_the_port(runs):
    stem0 = _initial_stem(runs)
    grown = {}
    for name in ("jax", "port"):
        log = runs[name]["log"]
        assert len(log) == 4 and all(np.isfinite(list(parts.values())).all() for parts, _ in log)
        (w1, v1), (w4, v4) = log[0][1], log[-1][1]
        grown[name] = (w4 / stem0, v4 / v1, v4)
        assert w4 >= 4 * stem0 and v4 >= 20 * v1, (name, grown[name])
    print(f"stem |w| x, running variance x, running variance after 4 steps: {grown}")
    ratio = grown["port"][2] / grown["jax"][2]
    assert 0.25 <= ratio <= 4, grown


@pytest.mark.slow
def test_first_step_assignment_matches_jax_f64(runs):
    """The first step of each framework on the Trainers' first batch and the
    init weights, through ``torch_train_utils``' steps (the exp's SGD, a
    schedule whose first lr is not 0): in f64 the foreground count equal
    and the losses within 1e-6 relative; the port's f32 count equal to
    f64's. Slow: JAX compiles the f64 step of this model (~60 s here, ~2
    min with the fixture)."""
    images, labels = runs["jax"]["first"]
    variables = load_checkpoint(runs["init"])["model"]
    saved = ttu.DEPTH, ttu.WIDTH
    ttu.DEPTH, ttu.WIDTH = DEPTH, WIDTH
    try:
        with jax.enable_x64(True):
            want = ttu.jax_steps(variables, images, labels, np.float64, steps=1)[0][0]
        got = ttu.port_steps(variables, images, labels, torch.float64, steps=1)[0][0]
        got32 = ttu.port_steps(variables, images, labels, torch.float32, steps=1)[0][0]
    finally:
        ttu.DEPTH, ttu.WIDTH = saved
    assert float(want["num_fg_per_gt"]) == got["num_fg_per_gt"] == got32["num_fg_per_gt"]
    for k in PARTS:
        assert abs(got[k] - float(want[k])) <= 1e-6 * abs(float(want[k])), k
