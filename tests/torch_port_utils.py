"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both the
JAX function and its port; arrays cross between the frameworks as numpy.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from cocodet_tpu_torch.utils.convert import jax_layout, random_variables

# One intra-op thread for torch in a test process. The tier-1 run spreads
# the test files over several xdist workers, each of which imports this
# module while it collects; torch's default pool (a thread a core in every
# worker, beside XLA's own) oversubscribed the machine's cores many times
# over. The spawned ranks of tests/torch_dist_utils.py do the same.
torch.set_num_threads(1)


@contextlib.contextmanager
def private_native_builds(tmp_dir, coco_eval: bool = False):
    """Point the JAX package's native letterbox (``cocodet_tpu/layers/
    fast_preproc``) and, with ``coco_eval``, its native COCO matcher
    (``layers/fast_coco_eval``) at libraries of this process's own, built
    into ``tmp_dir``, and assert that they load. Yields {name: path}.

    The JAX package builds each library in place, into its source
    directory, and gives up on it for the rest of the process after one
    failed load. Two test processes that build it at once can leave one of
    them with a half-written library, and the JAX reference then takes its
    cv2 path (the letterbox) or its Python matcher without a word. A private
    build takes the race away, and a reference that cannot build fails here,
    naming the library. Only module state of the test process changes; it
    is restored on exit."""
    from cocodet_tpu.layers import fast_coco_eval, fast_preproc

    mods = {"_preproc.so": fast_preproc} | ({"_cocoeval.so": fast_coco_eval} if coco_eval else {})
    paths = {name: os.path.join(str(tmp_dir), name) for name in mods}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in mods.items():
            mp.setattr(mod, "_SO", paths[name])
            mp.setattr(mod, "_lib", None)
            if hasattr(mod, "_tried"):
                mp.setattr(mod, "_tried", False)
        assert fast_preproc.available(), \
            f"the JAX native letterbox did not build or load at {paths['_preproc.so']}"
        if coco_eval:
            assert fast_coco_eval._load() is not None, \
                f"the JAX native COCO matcher did not build or load at {paths['_cocoeval.so']}"
        yield paths


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW torch in channels-last memory (a view)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def shared_variables(jax_module, torch_module, x_nhwc: np.ndarray, seed: int = 0):
    """Numpy-drawn variables for both models. Checks first that the port's
    flax layout equals the JAX module's own variable tree, names and shapes."""
    ref = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), x_nhwc)
    ref_layout = {k: tuple(v.shape) for k, v in flatten_dict(ref).items()}
    assert jax_layout(torch_module) == ref_layout
    return random_variables(torch_module, seed)


def assert_close(got: np.ndarray, want: np.ndarray, rtol: float, atol: float):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


# A channel-slim plan for yolox-p6 at depth 0.33, width 0.25 in the format of
# artifacts/mp6_chain_slim_spec.json (json keys; compress.load_slim_spec
# restores the int keys). It pins every kind of width the full plan pins:
# the stem, down and lateral/bu convs, residual streams ("res"),
# non-residual (hidden, out) pairs, bypasses ("c2"), the SPP and the head.
SMALL_SLIM_SPEC = {
    "stem": 8,
    "dark2_down": 24, "dark2_csp": {"0": [8, None], "res": 8, "c2": 8},
    "dark3_down": 48,
    "dark3_csp": {"0": [8, None], "1": [16, None], "2": [8, None], "res": 24, "c2": 16},
    "dark4_down": 96,
    "dark4_csp": {"0": [32, None], "1": [32, None], "2": [16, None], "res": 48, "c2": 40},
    "dark5_down": 160, "dark5_csp": {"0": [64, 80], "c2": 64},
    "dark6_down": 200, "dark6_spp": {"hidden": 96, "out": 160},
    "dark6_csp": {"0": [64, 96], "c2": 72},
    "lateral3": 160, "td_csp3": {"0": [64, 80], "c2": 112},
    "lateral2": 96, "td_csp2": {"0": [48, 64], "c2": 80},
    "lateral1": 48, "td_csp1": {"0": [32, 32], "c2": 40},
    "bu_conv1": 40, "bu_csp1": {"0": [48, 64], "c2": 40},
    "bu_conv2": 96, "bu_csp2": {"0": [64, 80], "c2": 88},
    "bu_conv3": 144, "bu_csp3": {"0": [96, 112], "c2": 120},
    "head": {"stem0": 48, "cls_conv0_0": 40, "cls_conv0_1": 56, "reg_conv0_0": 64,
             "reg_conv0_1": 32, "stem1": 64, "cls_conv1_1": 48, "stem2": 40,
             "reg_conv2_0": 56, "stem3": 32, "cls_conv3_0": 24},
}
SMALL_ARCH = dict(depth=0.33, width=0.25)


def write_small_slim_spec(tmp_dir) -> str:
    """SMALL_SLIM_SPEC as a json file in ``tmp_dir``; returns its path."""
    import json
    import os

    path = os.path.join(str(tmp_dir), "small_slim_spec.json")
    with open(path, "w") as f:
        json.dump(SMALL_SLIM_SPEC, f)
    return path


def images(size: int, batch: int = 2, seed: int = 0) -> np.ndarray:
    """(batch, size, size, 3) f32 images, U(0, 255) from numpy ``seed``."""
    rs = np.random.RandomState(seed)
    return rs.uniform(0.0, 255.0, (batch, size, size, 3)).astype(np.float32)


def head_maps(outputs):
    """Per-level {"reg","obj","cls"} maps of either framework as f32 numpy."""
    return [{k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v, np.float32)) for k, v in o.items()} for o in outputs]


def assert_same_detections(got, want, box_tol=(1e-2, 1e-3), score_tol=1e-4):
    """Each image's detections of the port (``got``, torch NMSResult) and of
    JAX (``want``) are the same set: equal counts, and a one-to-one cover
    of same-class pairs with boxes within ``box_tol`` (absolute px,
    relative) and scores within ``score_tol``."""
    for b in range(want.valid.shape[0]):
        n = int(want.valid[b].sum())
        assert int(got.valid[b].sum()) == n
        assert got.valid[b, :n].all()
        g = np.concatenate([got.boxes[b, :n].numpy(), got.scores[b, :n, None].numpy()], 1)
        w = np.concatenate([np.asarray(want.boxes[b, :n]),
                            np.asarray(want.scores[b, :n, None])], 1)
        tol = np.concatenate([box_tol[0] + box_tol[1] * np.abs(w[:, :4]),
                              np.full((n, 1), score_tol)], 1)
        close = (np.abs(g[:, None, :] - w[None, :, :]) <= tol[None]).all(-1)
        same_class = got.classes[b, :n].numpy()[:, None] == np.asarray(want.classes[b, :n])[None]
        match = close & same_class
        assert match.any(1).all() and match.any(0).all()


_FP_PROBE = r"""
unsigned get_mxcsr(void) { return __builtin_ia32_stmxcsr(); }
unsigned short get_x87cw(void) {
    unsigned short cw;
    __asm__ volatile("fnstcw %0" : "=m"(cw));
    return cw;
}
"""


def fp_state() -> dict:
    """The process state that elementwise float math can depend on, for a
    failing comparison to report: torch's thread counts and vector
    capability, the SSE control/status register (MXCSR: flush-to-zero,
    denormals-are-zero, rounding mode, sticky flags; 0x1f80 and flags as
    the process starts) and the x87 control word (0x37f), read through a
    probe built with gcc for this call, the xdist worker and test, and the
    shared libraries mapped into the process that are not Python's, numpy's
    or torch's own."""
    import ctypes
    import subprocess
    import tempfile

    state = {"worker": os.environ.get("PYTEST_XDIST_WORKER"),
             "test": os.environ.get("PYTEST_CURRENT_TEST"),
             "torch_threads": torch.get_num_threads(),
             "torch_interop_threads": torch.get_num_interop_threads(),
             "cpu_capability": torch.backends.cpu.get_cpu_capability()}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src, lib = os.path.join(tmp, "probe.c"), os.path.join(tmp, "probe.so")
            with open(src, "w") as f:
                f.write(_FP_PROBE)
            subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-o", lib], check=True,
                           capture_output=True, timeout=60)
            probe = ctypes.CDLL(lib)
            state["mxcsr"] = hex(probe.get_mxcsr())
            state["x87_cw"] = hex(probe.get_x87cw())
    except Exception as e:  # the report must not hide the failure it explains
        state["probe"] = f"unavailable: {e!r}"
    try:
        with open("/proc/self/maps") as f:
            libs = {line.split()[-1] for line in f if ".so" in line}
        state["libraries"] = sorted(os.path.basename(p) for p in libs
                                    if not any(s in p for s in ("/torch/", "/numpy", "python3",
                                                                "/lib-dynload/")))
    except OSError:
        pass
    return state
