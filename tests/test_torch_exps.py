"""The port's copies of the JAX package's exp files (cocodet_tpu_torch/
exps/ against exps/): every attribute equal, for each file the port
ships, and the parameter count of ``get_model`` equal to JAX's
``jax.eval_shape`` of its model's init for each model family no other test
counts (P6v2, which its exp sets to silu and no ``get_model`` reads, in
JAX as here; the 3-level custom YOLOX-L; the depthwise Nano), at the exps'
own depth and width (and YOLOv3's Darknet-53 + YOLOFPN). All exact. No
file waits: exps/default/yolov3.py and exps/example/ (VOC) are ported."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cocodet_tpu import exp as jexp
from cocodet_tpu_torch import exp as pexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = sorted(os.path.relpath(os.path.join(d, f), os.path.join(REPO, "cocodet_tpu_torch", "exps"))
                for d, _, fs in os.walk(os.path.join(REPO, "cocodet_tpu_torch", "exps"))
                for f in fs if f.endswith(".py") and f != "__init__.py")


def attributes(exp):
    return {k: getattr(exp, k) for k in dir(exp)
            if not k.startswith("_") and not callable(getattr(exp, k))}


def both(rel):
    return (pexp.get_exp_by_file(os.path.join(REPO, "cocodet_tpu_torch", "exps", rel)),
            jexp.get_exp_by_file(os.path.join(REPO, "exps", rel)))


def test_every_jax_exp_but_the_waiting_ones_is_ported():
    jax_files = sorted(os.path.relpath(os.path.join(d, f), os.path.join(REPO, "exps"))
                       for d, _, fs in os.walk(os.path.join(REPO, "exps"))
                       for f in fs if f.endswith(".py"))
    waiting = set()
    assert sorted(set(jax_files) - waiting) == PORTED


@pytest.mark.parametrize("rel", PORTED)
def test_exp_attributes_equal_jax(rel):
    port, jax_exp = both(rel)
    assert attributes(port) == attributes(jax_exp)
    assert type(port).__mro__[1].__name__ == type(jax_exp).__mro__[1].__name__


@pytest.mark.parametrize("rel", ["p6/yolox_m_p6_v2.py", "custom/yolox_l_custom.py",
                                 "default/nano.py", "default/yolov3.py"])
def test_model_parameter_count_equals_jax(rel):
    port, jax_exp = both(rel)
    model = port.get_model(device="cpu")
    n_port = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: jax_exp.get_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_port == n_jax
    assert model.strides == tuple(jax_exp.strides)
