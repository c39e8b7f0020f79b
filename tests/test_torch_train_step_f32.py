"""Port parity: the train step in f32, the dtype of the JAX package's own
train step, on the model and inputs of tests/torch_train_utils.py (the
``dryrun_multichip`` model at 64 px, B=2), against JAX's f32
``make_train_step``. Why f32 allows no more at this size:
tests/test_torch_train_step.py's docstring.

After one step each leaf is held by JAX's update of it, not by its value:
over the leaves, |port - JAX| is a median 0.13 and a 90th percentile 0.43
of the update for the parameters, 4.5e-4 and 8.7e-3 for the BN statistics
and 0.057 and 0.37 for the EMA shadow (this model and these inputs on the
CPU); a step that updated nothing would give 1. After the second step the
two runs assign an anchor differently (num_fg_per_gt 1.2 against 1.0), and
three steps are held by the direction and size of each leaf's change: the
median cosine between the port's and JAX's change 0.64 for the parameters
and 0.95 for the BN statistics, the median ratio of their norms 1.03 and
1.02.
"""

import numpy as np
import pytest

from torch_train_utils import METRICS, STEPS, compare_directions, compare_updates, run


@pytest.fixture(scope="module")
def f32_runs():
    return run("float32")


def test_train_step_one_step_matches_jax_f32(f32_runs):
    p0, want, got = f32_runs
    compare_updates(p0, want[0], got[0], metrics_rtol=1e-2,
                    limits={"params": (0.3, 0.8), "batch_stats": (1e-2, 0.1),
                            "ema": (0.2, 0.8)})


def test_train_step_three_steps_f32(f32_runs):
    """Three steps: finite losses of JAX's size (within a factor of 2), and
    each leaf moved from the initial state in JAX's direction, by JAX's
    amount (module docstring)."""
    p0, want, got = f32_runs
    for i in range(STEPS):
        for k in METRICS:
            assert np.isfinite(got[i][0][k])
            np.testing.assert_allclose(got[i][0][k], float(want[i][0][k]), rtol=0.5, err_msg=k)
    compare_directions(p0, want[STEPS - 1], got[STEPS - 1],
                       cos_min={"params": 0.4, "batch_stats": 0.8}, ratio_max=1.25)
