"""Channel slimming of the port (cocodet_tpu_torch/compress/merge.py::
slim_channels) against JAX's (cocodet_tpu/compress/merge.py:76-442), on
YOLOX-P6 at depth 0.33, width 0.25 with seeded variables and ChannelMask
gates that a prune selection closed (``apply_channel_prune`` on random
importance: residual groups closed together, offsets ``bn.bias`` on the
closed channels, so not zero).

- The spec: exact, for round_to 1, 8 and 32 (the default).
- Given the same fused tree, the slimmed arrays are equal (both are numpy;
  the constants act(offset) go through each package's hard-swish, bit-equal
  on the CPU). Through each package's own merge: rtol 2e-6, atol 1e-6 (the
  folds' rsqrt; tests/test_torch_magnitude.py).
- The slimmed model of each package built from its spec and tree: head
  maps within rtol = atol = 1e-4, and the same detections through each
  postprocess (tests/torch_port_utils.py::assert_same_detections).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import merge as jmerge
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu.ops.postprocess import PostprocessConfig as JaxConfig
from cocodet_tpu.ops.postprocess import postprocess as jax_postprocess
from cocodet_tpu_torch.compress import load_slim_spec, merge_for_deployment, slim_channels
from cocodet_tpu_torch.core.pruner import apply_channel_prune
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.ops.postprocess import PostprocessConfig, postprocess
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables
from torch_port_utils import assert_close, assert_same_detections, head_maps

ARCH = dict(depth=0.33, width=0.25)
STRIDES = (8, 16, 32, 64)


def pruned_variables(seed=0, prune_frac=0.45):
    """Seeded variables of the masked model with a prune selection applied
    (random importance)."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], use_mask=True, **ARCH)
    variables = random_variables(shapes, seed)
    rs = np.random.RandomState(seed + 1)
    flat = flatten_tree(variables["masks"])
    importance = {k[:-2]: rs.uniform(0, 1, v.shape[0]).astype(np.float32)
                  for k, v in flat.items() if k[-1] == "scale"}
    total = sum(v.shape[0] for v in importance.values())
    pruned, n = apply_channel_prune(variables, importance, int(prune_frac * total))
    assert n > 0.3 * total
    return pruned


@pytest.fixture(scope="module")
def chain():
    variables = pruned_variables()
    return variables, jmerge.merge_for_deployment(variables)


def _json(spec):
    return json.loads(json.dumps(spec))


@pytest.mark.parametrize("round_to", [1, 8, 32])
def test_spec_and_arrays_match_jax(chain, round_to):
    variables, jax_fused = chain
    fused = jax.tree_util.tree_map(np.asarray, jax_fused)
    want_vars, want_spec = jmerge.slim_channels(fused, variables["masks"], round_to=round_to)
    got_vars, got_spec = slim_channels(fused, variables["masks"], round_to=round_to)
    assert got_spec == want_spec
    assert _json(got_spec) == _json(want_spec)
    g = flatten_tree(got_vars)
    w = flatten_dict(jax.tree_util.tree_map(np.asarray, want_vars))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
    if round_to == 1:  # every kind of site was slimmed
        assert {"res", "c2"} <= set(got_spec["dark3_csp"])
        default_res = {"dark2_csp": 16, "dark3_csp": 32, "dark4_csp": 64}
        assert sum(v - got_spec[k]["res"] for k, v in default_res.items()) > 0
        assert any(v[0] is not None and v[0] < 32 for k, v in got_spec["td_csp1"].items()
                   if isinstance(k, int))
        assert got_spec["head"]["stem0"] < 64 and got_spec["lateral1"] < 64


def test_each_package_chain_matches(chain):
    """merge then slim in each package: the same spec, arrays within the
    merge's tolerance."""
    variables, jax_fused = chain
    want_vars, want_spec = jmerge.slim_channels(jax.tree_util.tree_map(np.asarray, jax_fused),
                                                variables["masks"], round_to=1)
    got_vars, got_spec = slim_channels(merge_for_deployment(variables), variables["masks"],
                                       round_to=1)
    assert got_spec == want_spec
    w = flatten_dict(jax.tree_util.tree_map(np.asarray, want_vars))
    for k, v in flatten_tree(got_vars).items():
        assert_close(v, w[k], rtol=2e-6, atol=1e-6)


def test_slimmed_model_detections_match_jax(chain, tmp_path):
    variables, jax_fused = chain
    fused = jax.tree_util.tree_map(np.asarray, jax_fused)
    slimmed, spec = slim_channels(fused, variables["masks"], round_to=1)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    spec = load_slim_spec(str(path))
    assert spec == jmerge.load_slim_spec(str(path))
    x = np.random.RandomState(3).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    jm = jax_build("yolox-p6", fused=True, slim=spec, **ARCH)
    want = jm.apply(slimmed, jnp.asarray(x))
    pm = build_model("yolox-p6", fused=True, slim=spec, device="cpu", variables=slimmed,
                     **ARCH)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w in zip(head_maps(got), head_maps(want)):
        for key in g:
            assert_close(g[key], w[key], rtol=1e-4, atol=1e-4)
    cfg = dict(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=1024, max_det=300)
    want_det = jax_postprocess(want, STRIDES, JaxConfig(**cfg))
    got_det = postprocess(got, STRIDES, PostprocessConfig(**cfg))
    assert int(np.asarray(want_det.valid).sum()) > 0
    assert_same_detections(got_det, want_det)
