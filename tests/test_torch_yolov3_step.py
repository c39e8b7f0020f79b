"""Port parity: one training step of YOLOv3 (Darknet-53 + YOLOFPN, lrelu
after every BN, cocodet_tpu_torch/models/) against JAX's ``make_train_step``
at full width, 64 px, B=2, from the same numpy-drawn variables (head
biases at the prior 0.01), under tests/torch_train_utils.py's optimizer and
schedule, in f64 (``jax.enable_x64``): ``compare_tight`` holds each
parameter to 1e-5 of its update, each BN statistic to 1e-9 and each EMA
leaf to 1e-5 of its update. The model's forward parity is in
tests/test_torch_yolov3.py.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from cocodet_tpu.core.train_state import create_train_state as jax_create_state
from cocodet_tpu.core.train_state import make_train_step as jax_make_step
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.utils import lr_scheduler as jlr
from cocodet_tpu_torch.core import train_state as ts
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, build_model
from cocodet_tpu_torch.utils import lr_scheduler as tlr
from cocodet_tpu_torch.utils.convert import export_variables, flatten_tree, random_variables
from torch_train_utils import SCHEDULE, compare_tight, inputs

STRIDES = (8, 16, 32)


def test_train_step_matches_jax_f64():
    """One step of the full-width model at 64 px, B=2, in f64 (lrelu after
    every BN, so the gradient at 0 matters), against JAX's
    ``make_train_step`` from the same init, under torch_train_utils'
    optimizer and schedule."""
    _, images_, labels = inputs()
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolov3"])
    variables = random_variables(shapes, 3, prior_prob=0.01)

    def decay_mask(params):
        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    with jax.enable_x64(True):
        model = jax_build_model("yolov3")
        tx = optax.chain(optax.add_decayed_weights(5e-4, mask=decay_mask),
                         optax.sgd(jlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE),
                                   momentum=0.9, nesterov=True))
        init = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.float64)), variables)
        state = jax_create_state(model, tx, None, None, init_vars=init)
        step = jax_make_step(model, tx, strides=STRIDES, num_classes=80, donate=False)
        state, metrics = step(state, jnp.asarray(images_.astype(np.float64)),
                              jnp.asarray(labels), use_l1=True)
        want = jax.device_get((metrics, {"params": state.params,
                                         "batch_stats": state.batch_stats}, state.ema.shadow))

    tm = build_model("yolov3", device="cpu", variables=variables).to(torch.float64)
    tm.dtype = torch.float64
    tstate = ts.create_train_state(
        tm, ts.build_optimizer(tm, tlr.build_lr_schedule("yoloxwarmcos", **SCHEDULE)))
    metrics = ts.make_train_step(tstate, STRIDES)(
        torch.from_numpy(images_).double(), torch.from_numpy(labels), use_l1=True)
    got = ({k: float(v) for k, v in metrics.items()}, flatten_tree(export_variables(tm)),
           {n: t.clone() for n, t in tstate.ema.shadow.items()})
    assert got[0]["num_fg"] > 0
    compare_tight(flatten_tree(variables), want, got)
