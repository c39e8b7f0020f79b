"""The port's slice as a whole: cocodet_tpu_torch/entry.py against the
``__graft_entry__.entry()`` program of the JAX package (fused YOLOX-P6 +
the single postprocess at the production point), and the port's import
boundary.

Tolerance of the whole slice in f32 at small width: the same detections
(count, classes); boxes within 0.01 px + 1e-3 relative and scores within
1e-4. The head maps agree to 1e-4 * (1 + |v|) (tests/test_torch_model.py:
XLA:CPU and oneDNN sum each conv in another order); exp() turns a box-size
logit error into a relative size error, and x - w/2 cancels, so boxes get
an absolute floor (observed worst: 2e-4 px, scores 1e-5). Detections are
matched as sets, since such a difference may swap two candidates of nearly
equal score.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.ops.fuse import fuse_batchnorm as jax_fuse_batchnorm
from cocodet_tpu.ops.postprocess import PostprocessConfig as JaxConfig
from cocodet_tpu.ops.postprocess import postprocess as jax_postprocess
from cocodet_tpu_torch.entry import PRODUCTION_CONFIG, build_predictor, entry
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.ops.cuda import nms_kernels as tk
from cocodet_tpu_torch.utils.convert import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_detections(got, want):
    for b in range(want.valid.shape[0]):
        n = int(want.valid[b].sum())
        assert int(got.valid[b].sum()) == n
        assert got.valid[b, :n].all()
        g = np.concatenate([got.boxes[b, :n].numpy(), got.scores[b, :n, None].numpy()], 1)
        w = np.concatenate([np.asarray(want.boxes[b, :n]),
                            np.asarray(want.scores[b, :n, None])], 1)
        tol = np.concatenate([1e-2 + 1e-3 * np.abs(w[:, :4]), np.full((n, 1), 1e-4)], 1)
        close = (np.abs(g[:, None, :] - w[None, :, :]) <= tol[None]).all(-1)
        same_class = got.classes[b, :n].numpy()[:, None] == np.asarray(want.classes[b, :n])[None]
        match = close & same_class
        assert match.any(1).all() and match.any(0).all()


def test_entry_small_width_matches_jax():
    depth, width = 0.33, 0.25
    images = np.random.RandomState(0).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width)
    variables = random_variables(shapes, seed=5)

    jm = jax_build_model("yolox-p6", depth=depth, width=width, fused=True)
    cfg = JaxConfig(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=1024, max_det=300)
    fused = jax_fuse_batchnorm(variables)
    want = jax.device_get(jax.jit(
        lambda x: jax_postprocess(jm.apply(fused, x), (8, 16, 32, 64), cfg))(
            jnp.asarray(images)))

    tk.reset_launch_counts()
    predictor = build_predictor(variables, depth=depth, width=width,
                                dtype=torch.float32, device="cpu")
    got = predictor(images)  # numpy in: the Predictor moves it to the model's device
    assert predictor.cfg == PRODUCTION_CONFIG
    assert got.boxes.shape == (2, 300, 4) and got.classes.dtype == torch.int32
    assert int(want.valid.sum()) > 100
    _assert_same_detections(got, want)
    assert tk.overlap_matrix.launches == 0 and tk.greedy_keep.launches == 0


def test_entry_full_width_on_cpu():
    """entry() builds the fused bf16 YOLOX-M-P6; on the CPU it runs the
    plain versions of the kernels."""
    fn, (x,) = entry(device="cpu")
    model = fn.model
    assert model.fused and model.dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) > 43_000_000
    res = fn(x)
    assert res.boxes.shape == (1, 300, 4) and res.boxes.dtype == torch.float32
    assert torch.isfinite(res.boxes).all() and torch.isfinite(res.scores).all()


def test_port_imports_no_jax():
    """Importing every module of the port (64 or more, the evaluation
    family's, the training runtime's and the compression family's among
    them), and chip_smoke.py, loads no jax,
    flax, cocodet_tpu, cv2, PIL or msgpack (the port writes and reads
    checkpoints with its own codec)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import cocodet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            cocodet_tpu_torch.__path__, "cocodet_tpu_torch.")]
        assert len(names) >= 64, names
        assert {"cocodet_tpu_torch.core.trainer", "cocodet_tpu_torch.tools.train",
                "cocodet_tpu_torch.exps.p6.yolox_m_p6", "cocodet_tpu_torch.utils.msgpack",
                "cocodet_tpu_torch.ops.cuda.train_aug", "cocodet_tpu_torch.compress.qat",
                "cocodet_tpu_torch.core.trainer_synflow", "cocodet_tpu_torch.tools.qat_tune",
                "cocodet_tpu_torch.tools.train_synflow", "cocodet_tpu_torch.tools.run_pipeline",
                "cocodet_tpu_torch.exps.synflow.yolox_m_synflow",
                "cocodet_tpu_torch.exps.p6.yolox_m_p6_tune",
                "cocodet_tpu_torch.ops.cuda.fake_quant"} <= set(names), names
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "cocodet_tpu", "cv2",
                                                 "PIL", "msgpack"))
        assert not bad, bad
        print("ok", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
