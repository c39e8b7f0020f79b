"""Port parity: the channel-slimmed YOLOX-P6 of cocodet_tpu_torch against
cocodet_tpu's (models built with ``slim=``, compress/merge.py's spec
reader and parameter count).

Tolerance of the small-arch forward in f32: rtol = atol = 1e-4, that of
tests/test_torch_model.py (XLA:CPU and oneDNN sum each conv in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import count_effective_params as jax_count_effective_params
from cocodet_tpu.compress import load_slim_spec as jax_load_slim_spec
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu_torch.compress import count_effective_params, load_slim_spec
from cocodet_tpu_torch.entry import SLIM_SPEC
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils.convert import jax_layout, load_variables, random_variables
from torch_port_utils import (SMALL_ARCH, assert_close, head_maps, images,
                              shared_variables, write_small_slim_spec)

FULL = dict(depth=0.67, width=0.75)


@pytest.fixture(scope="module")
def full_spec():
    spec = load_slim_spec(str(SLIM_SPEC))
    assert spec == jax_load_slim_spec(str(SLIM_SPEC))
    return spec


@pytest.fixture(scope="module")
def jax_full_calib_layout(full_spec):
    """Flax layout of the JAX slim YOLOX-M-P6 built with quant="calib":
    its params (those of the float fused model) and its quant_stats (one
    (cin,) leaf for each quantizable conv)."""
    jm = jax_build_model("yolox-p6", fused=True, slim=full_spec, quant="calib", **FULL)
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    return {k: tuple(v.shape) for k, v in flatten_dict(ref).items()}


def _port_layout(spec, quant):
    with torch.device("meta"):
        tm = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=spec, quant=quant, **FULL)
    return jax_layout(tm)


@pytest.mark.parametrize("quant", [None, "calib", "w8a8"])
def test_full_width_slim_layout(full_spec, jax_full_calib_layout, quant):
    """Every flax path and shape of the slim model, float, calib and w8a8.
    JAX creates a w8a8 conv's quant variables only when its kernel is
    already int8, so its init has none: they are one w_scale (cout,) and a
    scalar act_scale for each conv that calibration records."""
    ref = jax_full_calib_layout
    params = {k: s for k, s in ref.items() if k[0] == "params"}
    stats = {k: s for k, s in ref.items() if k[0] == "quant_stats"}
    assert len(stats) == 127
    if quant is None:
        want = params
    elif quant == "calib":
        want = ref
    else:
        want = dict(params)
        for path in stats:
            scope = path[1:-1]
            want[("quant", *scope, "w_scale")] = params[("params", *scope, "kernel")][-1:]
            want[("quant", *scope, "act_scale")] = ()
    assert _port_layout(full_spec, quant) == want


def test_full_width_slim_param_count(full_spec):
    with torch.device("meta"):
        tm = YOLOX(MODEL_SPECS["yolox-p6"], fused=True, slim=full_spec, **FULL)
    variables = random_variables(tm, 0)
    assert count_effective_params(variables) == (17_913_396, 17_913_396)
    assert jax_count_effective_params(variables) == (17_913_396, 17_913_396)
    convs = [m for m in tm.modules() if type(m).__name__ == "Conv2d"]
    assert len(convs) == 139


def test_count_effective_params_with_masks():
    params = {"a": {"conv": {"kernel": np.ones((3, 3, 2, 2), np.float32)}},
              "b": {"kernel": np.array([0.0, 1.0, 2.0], np.float32)}}
    masks = {"a": {"conv": {"conv_mask": (np.arange(36).reshape(3, 3, 2, 2) % 3 == 0)
                            .astype(np.float32)}}}
    got = count_effective_params({"params": params}, masks)
    assert got == jax_count_effective_params({"params": params}, masks)
    assert got == (12 + 2, 39)


def test_small_slim_spec_roundtrip(tmp_path):
    path = write_small_slim_spec(tmp_path)
    spec = load_slim_spec(path)
    assert spec == jax_load_slim_spec(path)
    assert spec["dark5_csp"][0] == (64, 80) and spec["dark3_csp"]["res"] == 24


@pytest.mark.parametrize("fused", [False, True])
def test_small_slim_forward_matches_jax(tmp_path, fused):
    spec = load_slim_spec(write_small_slim_spec(tmp_path))
    x = images(128)
    jm = jax_build_model("yolox-p6", fused=fused, slim=spec, **SMALL_ARCH)
    tm = build_model("yolox-p6", fused=fused, slim=spec, device="cpu", **SMALL_ARCH)
    variables = shared_variables(jm, tm, x, seed=7)
    load_variables(tm, variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(head_maps(got), head_maps(want)):
        for key in ("reg", "obj", "cls"):
            assert g[key].shape == w[key].shape
            assert_close(g[key], w[key], rtol=1e-4, atol=1e-4)
    assert [m["cls"].shape[1] for m in head_maps(got)] == [16, 8, 4, 2]
