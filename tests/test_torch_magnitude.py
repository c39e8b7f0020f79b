"""The magnitude chain and the merge of the port (cocodet_tpu_torch/compress/
magnitude.py, merge.py::merge_for_deployment, ops/fuse.py) against JAX's
(cocodet_tpu/compress/magnitude.py, merge.py:58, ops/fuse.py:28-80), on the
variables of YOLOX-P6 at depth 0.33, width 0.125 drawn from a numpy seed,
with some ChannelMask gates closed (non-zero offsets).

Exact: the masks, the global threshold (JAX logs it), the injected tree,
the sparsity report and the effective-parameter counts. The merged tree:
rtol 2e-6, atol 1e-6 per leaf (JAX folds with XLA's rsqrt, the port with
torch's; they may differ in the last bit). The merged tree served by the
fused model, port against JAX: rtol = atol = 1e-4 on the head maps
(tests/test_torch_model.py's tolerance).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.compress import magnitude as jmag
from cocodet_tpu.compress import merge as jmerge
from cocodet_tpu.models import build_model as jax_build
from cocodet_tpu_torch.compress import (count_effective_params, generate_magnitude_masks,
                                        inject_masks, magnitude_threshold, merge_for_deployment,
                                        sparsity_report)
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables
from test_torch_channel_mask import close_some
from torch_port_utils import assert_close, head_maps

ARCH = dict(depth=0.33, width=0.125)


@pytest.fixture(scope="module")
def masked_variables():
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], use_mask=True, **ARCH)
    return close_some(random_variables(shapes, 0), 9)


def _jax_threshold(params, ratio):
    """JAX's generate_magnitude_masks and the threshold it logs."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("cocodet_tpu")
    log.addHandler(handler)
    old = log.level
    log.setLevel(logging.INFO)
    try:
        masks = jmag.generate_magnitude_masks(params, prune_ratio=ratio, verbose=False)
    finally:
        log.removeHandler(handler)
        log.setLevel(old)
    return masks, [r.args[-1] for r in records if "threshold" in r.msg][0]


def _same_tree(got, want):
    g, w = flatten_tree(got), flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=str(k))


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.49, 0.9])
def test_masks_and_threshold_match_jax(masked_variables, ratio):
    params = masked_variables["params"]
    want, want_thresh = _jax_threshold(params, ratio)
    got = generate_magnitude_masks(params, prune_ratio=ratio, verbose=False)
    _same_tree(got, want)
    thresh = magnitude_threshold(params, ratio)
    assert thresh == want_thresh or (np.isinf(thresh) and np.isinf(want_thresh))
    assert not any(k[0] == "head" for k in flatten_tree(got))
    kept = sum(float(m.sum()) for m in flatten_tree(got).values())
    total = sum(m.size for m in flatten_tree(got).values())
    assert abs(kept / total - (1 - ratio)) < 1e-3


def test_inject_sparsity_and_counts_match_jax(masked_variables):
    masks = generate_magnitude_masks(masked_variables["params"], 0.49, verbose=False)
    got = inject_masks(masked_variables, masks)
    want = jmag.inject_masks(masked_variables, masks)
    _same_tree(got, want)
    # the ChannelMask gates stay beside the conv masks
    assert any(k[-1] == "offset" for k in flatten_tree(got["masks"]))
    assert sparsity_report(got) == jmag.sparsity_report(want)
    assert count_effective_params(got, got["masks"]) == jmerge.count_effective_params(
        want, want["masks"])


@pytest.fixture(scope="module")
def merged(masked_variables):
    variables = inject_masks(masked_variables, generate_magnitude_masks(
        masked_variables["params"], 0.49, verbose=False))
    return variables, merge_for_deployment(variables), jmerge.merge_for_deployment(variables)


def test_merge_matches_jax(merged):
    _, got, want = merged
    g = flatten_tree(got)
    w = flatten_dict(jax.tree_util.tree_map(np.asarray, want))
    assert g.keys() == w.keys() and "masks" not in got
    for k in w:
        assert_close(g[k], w[k], rtol=2e-6, atol=1e-6)
    assert count_effective_params(got) == jmerge.count_effective_params(want)
    # the magnitude masks zeroed about half of the folded conv weights
    eff, total = count_effective_params(got)
    assert eff < 0.7 * total


def test_merged_tree_serves_as_jax(merged):
    """The fused model built from each merged tree: the same head maps."""
    _, got, want = merged
    x = np.random.RandomState(1).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jm = jax_build("yolox-p6", fused=True, **ARCH)
    want_maps = jm.apply(want, jnp.asarray(x))
    pm = build_model("yolox-p6", fused=True, device="cpu", variables=got, **ARCH)
    with torch.no_grad():
        got_maps = pm(torch.from_numpy(x))
    for g, w in zip(head_maps(got_maps), head_maps(want_maps)):
        for key in g:
            assert_close(g[key], w[key], rtol=1e-4, atol=1e-4)
