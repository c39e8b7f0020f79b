"""Port parity: the YOLOX model zoo of cocodet_tpu_torch against
cocodet_tpu's, with the same numpy-drawn weights carried through
cocodet_tpu_torch/utils/convert.py.

Tolerances. f32 per-level head maps: rtol = atol = 1e-4, so |d| <=
1e-4 * (1 + |v|) (XLA:CPU and oneDNN sum each conv in another order; the
observed worst case is 1.2e-5 * (1 + |v|) on maps up to |v| ~ 14). bf16
maps: elementwise rtol = atol = 0.25 and a mean relative error of at most
2%: bf16 keeps 8 bits and flax and PyTorch round BN, bias and activations at
different places; the JAX bf16 maps themselves differ from the JAX f32 maps
by up to 0.19 * (1 + |v|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.ops.fuse import fuse_batchnorm as jax_fuse_batchnorm
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.ops.fuse import fuse_batchnorm, fuse_model
from cocodet_tpu_torch.utils.convert import jax_layout, load_variables
from torch_port_utils import assert_close, shared_variables

F32 = dict(rtol=1e-4, atol=1e-4)


def _images(size, batch=2, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(0.0, 255.0, (batch, size, size, 3)).astype(np.float32)


def _maps(outputs):
    return [{k: np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
             else v.detach().float().numpy() for k, v in o.items()} for o in outputs]


def _assert_maps(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(_maps(got), _maps(want)):
        assert set(g) == {"reg", "obj", "cls"} == set(w)
        for key in g:
            assert g[key].shape == w[key].shape, key
            assert_close(g[key], w[key], **tol)


@pytest.fixture(scope="module")
def p6_small():
    """d0.33/w0.25 p6 at 128 px: JAX model, port model, shared variables."""
    x = _images(128)
    jm = jax_build_model("yolox-p6", depth=0.33, width=0.25)
    tm = build_model("yolox-p6", depth=0.33, width=0.25, device="cpu")
    variables = shared_variables(jm, tm, x, seed=3)
    load_variables(tm, variables)
    return x, jm, tm, variables


def test_p6_small_f32_unfused(p6_small):
    x, jm, tm, variables = p6_small
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _assert_maps(got, want, **F32)
    assert [o["cls"].shape[1] for o in got] == [16, 8, 4, 2]


def test_p6_small_f32_fused(p6_small):
    x, jm, tm, variables = p6_small
    jf = jax_build_model("yolox-p6", depth=0.33, width=0.25, fused=True)
    want = jf.apply(jax_fuse_batchnorm(variables), jnp.asarray(x))
    tf = fuse_model(tm)
    assert tf.fused and not any(".bn." in n for n in tf.state_dict())
    with torch.no_grad():
        got = tf(torch.from_numpy(x))
        unfused = tm(torch.from_numpy(x))
    _assert_maps(got, want, **F32)
    _assert_maps(got, unfused, **F32)


def test_fuse_batchnorm_matches_jax_tree(p6_small):
    """The folded tensors themselves equal the JAX fold (rsqrt may differ by
    an ulp between the libraries)."""
    _, _, tm, variables = p6_small
    fused_sd = fuse_batchnorm(tm.state_dict())
    jflat = flatten_dict(jax_fuse_batchnorm(variables)["params"])
    assert len(fused_sd) == len(jflat)
    for path, v in jflat.items():
        name = ".".join(path[:-1]) + (".weight" if path[-1] == "kernel" else ".bias")
        t = fused_sd[name].numpy()
        v = np.asarray(v)
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(t, v, rtol=1e-6, atol=1e-7)


def test_p6_small_bf16(p6_small):
    x, _, tm, variables = p6_small
    jm = jax_build_model("yolox-p6", depth=0.33, width=0.25, dtype=jnp.bfloat16)
    want = jm.apply(variables, jnp.asarray(x))
    tb = build_model("yolox-p6", depth=0.33, width=0.25, dtype=torch.bfloat16,
                     device="cpu")
    load_variables(tb, variables)
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    assert got[0]["cls"].dtype == torch.bfloat16
    _assert_maps(got, want, rtol=0.25, atol=0.25)
    g = np.concatenate([m[k].ravel() for m in _maps(got) for k in m])
    w = np.concatenate([m[k].ravel() for m in _maps(want) for k in m])
    assert np.abs(g - w).mean() <= 0.02 * np.abs(w).mean()


@pytest.mark.parametrize("name,size", [("yolox", 64), ("yolox-custom", 64),
                                       ("yolox-dw", 64), ("yolox-p6v2", 128)])
def test_other_variants_f32(name, size):
    x = _images(size, batch=1, seed=1)
    jm = jax_build_model(name, depth=0.33, width=0.125)
    tm = build_model(name, depth=0.33, width=0.125, device="cpu")
    variables = shared_variables(jm, tm, x, seed=4)
    load_variables(tm, variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _assert_maps(got, want, **F32)


def test_full_width_layout():
    """YOLOX-M-P6 (d0.67/w0.75): every flax variable has its port
    counterpart with the same shape, without running either model."""
    jm = jax_build_model("yolox-p6", depth=0.67, width=0.75)
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    ref_layout = {k: tuple(v.shape) for k, v in flatten_dict(ref).items()}
    with torch.device("meta"):
        tm = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75)
    assert jax_layout(tm) == ref_layout
    n_params = sum(int(np.prod(s)) for k, s in ref_layout.items() if k[0] == "params")
    assert n_params == sum(p.numel() for p in tm.parameters()) == 43_723_828


def test_load_variables_rejects_mismatch(p6_small):
    _, _, tm, variables = p6_small
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["head"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_variables(tm, bad)
    del bad["params"]["head"]["extra"]
    del bad["batch_stats"]["head"]["stem0"]
    with pytest.raises(KeyError, match="missing"):
        load_variables(tm, bad)
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["head"]["cls_pred0"]["bias"] = np.zeros((81,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_variables(tm, bad)


def test_yolov3_not_ported():
    """Until the Darknet-53 + YOLOFPN model was ported, ``build_model("yolov3")``
    raised. It builds now (tests/test_torch_yolov3.py holds it against JAX);
    what stays refused are the options JAX's yolov3 branch does not take."""
    with pytest.raises(ValueError, match="slim"):
        build_model("yolov3", device="meta", slim={"stem": 8})
