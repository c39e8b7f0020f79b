"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both the
JAX function and its port; arrays cross between the frameworks as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
from flax.traverse_util import flatten_dict

from cocodet_tpu_torch.utils.convert import jax_layout, random_variables


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
