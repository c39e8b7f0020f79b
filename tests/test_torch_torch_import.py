"""The port's reference-checkpoint import (cocodet_tpu_torch/utils/
torch_import.py) against cocodet_tpu/utils/torch_import.py, exactly.

Every key of a P6 (4-level) and a standard (3-level) YOLOX, unfused, with BN
statistics, maps to JAX's flax path and back; state dicts written by JAX's
``export_state_dict`` from numpy-seeded variables, with the backbone's
kernels stored as sparse COO tensors (as ``03_jh_merge.py`` stores them),
convert to JAX's tree leaf for leaf, bit for bit; the port's export equals
JAX's tensor for tensor.

The 3-level case holds a fault of the reference: JAX's harness and eval CLI
call ``load_torch_checkpoint`` without ``num_levels``, whose default of 4
maps ``lateral_conv0`` to ``lateral3``, a leaf the 3-level flax PAFPN does
not have (its deepest lateral is ``lateral2``); ``load_matched`` then keeps
that leaf's init. The port's callers pass the model's level count.
"""

import numpy as np
import pytest
import torch

import jax
from flax.traverse_util import flatten_dict

from cocodet_tpu.utils import torch_import as jti
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.utils import torch_import as tti
from cocodet_tpu_torch.utils.convert import flatten_tree, random_variables

CASES = {"p6": ("yolox-p6", 4), "standard": ("yolox", 3)}


def _variables(name, seed=0, fused=False):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS[name], depth=0.33, width=0.125, fused=fused)
    return random_variables(shapes, seed)


def _jax_state_dict(variant, sparse_backbone=False):
    name, levels = CASES[variant]
    sd = jti.export_state_dict(_variables(name), variant, levels)
    if sparse_backbone:
        sd = {k: (v.to_sparse() if k.startswith("backbone.backbone.") and v.dim() == 4 else v)
              for k, v in sd.items()}
    return sd


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_dict(want)
    assert sorted(g) == sorted(w)
    for path, value in w.items():
        assert g[path].dtype == np.asarray(value).dtype, path
        np.testing.assert_array_equal(g[path], np.asarray(value), err_msg=str(path))


@pytest.mark.parametrize("variant", ["p6", "standard"])
def test_keys_map_as_jax_and_back(variant):
    name, levels = CASES[variant]
    variables = _variables(name)
    keys = list(jti.export_state_dict(variables, variant, levels))
    assert len(keys) > 300 and any(k.endswith("running_var") for k in keys)
    for key in keys + [k + ".num_batches_tracked" for k in keys[:3]]:
        want = jti.map_torch_key(key, variant, levels)
        assert tti.map_torch_key(key, variant, levels) == want, key
    for coll in ("params", "batch_stats"):
        for path in flatten_tree(variables[coll]):
            key = tti.map_flax_path(path, coll, variant, levels)
            assert key == jti.map_flax_path(path, coll, variant, levels)
            assert tti.map_torch_key(key, variant, levels) == (path, coll)


@pytest.mark.parametrize("variant", ["p6", "standard"])
@pytest.mark.parametrize("sparse", [False, True])
def test_convert_state_dict_equals_jax(variant, sparse):
    """With ``module.`` prefixes, num_batches_tracked and (sparse) the
    backbone's conv kernels as sparse COO tensors."""
    name, levels = CASES[variant]
    sd = _jax_state_dict(variant, sparse)
    assert any(v.is_sparse for v in sd.values()) == sparse
    sd = {("module." if i % 2 else "") + k: v for i, (k, v) in enumerate(sd.items())}
    sd["module.head.stems.0.bn.num_batches_tracked"] = torch.tensor(7)
    want = jti.convert_state_dict(sd, variant, levels)
    got = tti.convert_state_dict(sd, variant, levels)
    assert sorted(got) == ["batch_stats", "params"]
    _assert_trees_equal(got, want)
    # and it is the tree the state dict was written from
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, _variables(name)))


@pytest.mark.parametrize("variant", ["p6", "standard"])
def test_export_state_dict_equals_jax(variant):
    name, levels = CASES[variant]
    variables = _variables(name, seed=3, fused=True)
    want = jti.export_state_dict(variables, variant, levels)
    got = tti.export_state_dict(variables, variant, levels)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        assert torch.equal(got[k], v), k


def test_load_torch_checkpoint_equals_jax(tmp_path):
    """A reference training checkpoint (its ``model`` entry, beside an epoch
    number and optimizer state) and a bare sparse state dict, through
    ``torch.load(..., weights_only=True)``."""
    sd = _jax_state_dict("p6", sparse_backbone=True)
    train = tmp_path / "epoch_3.pth"
    torch.save({"model": sd, "start_epoch": 3,
                "optimizer": {"state": {}, "param_groups": [{"lr": 0.01}]}}, train)
    bare = tmp_path / "merged_49.pth"
    torch.save(sd, bare)
    for path in (train, bare):
        _assert_trees_equal(tti.load_torch_checkpoint(str(path)),
                            jti.load_torch_checkpoint(str(path)))


class _Arbitrary:
    """An object a weights-only load refuses."""


def test_arbitrary_pickles_raise(tmp_path):
    path = tmp_path / "pickled.pth"
    torch.save({"model": _jax_state_dict("p6"), "extra": _Arbitrary()}, path)
    with pytest.raises(ValueError, match="weights_only=True"):
        tti.load_torch_checkpoint(str(path))


def test_three_level_lateral_conv0():
    """The reference's default of 4 levels sends a 3-level model's
    ``lateral_conv0`` to ``lateral3``, which the 3-level PAFPN does not have;
    with the model's 3 it lands on ``lateral2``."""
    variables = _variables("yolox")
    flax_paths = set(flatten_tree(variables["params"]))
    key = "backbone.lateral_conv0.conv.weight"
    jax_path, _ = jti.map_torch_key(key, "standard")  # what JAX's callers get
    assert jax_path == ("backbone", "lateral3", "conv", "kernel")
    assert jax_path not in flax_paths
    port_path, _ = tti.map_torch_key(key, "standard", num_levels=3)
    assert port_path == ("backbone", "lateral2", "conv", "kernel") and port_path in flax_paths
    # the whole dict: with 4 levels exactly the lateral_conv0 leaves miss
    sd = tti.export_state_dict(variables, "standard", 3)
    wrong = set(flatten_tree(tti.convert_state_dict(sd, "standard")["params"]))
    assert sorted(wrong - flax_paths) == [("backbone", "lateral3", "bn", "bias"),
                                          ("backbone", "lateral3", "bn", "scale"),
                                          ("backbone", "lateral3", "conv", "kernel")]
    right = set(flatten_tree(tti.convert_state_dict(sd, "standard", 3)["params"]))
    assert right == flax_paths
