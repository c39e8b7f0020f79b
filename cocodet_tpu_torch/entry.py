"""The port's programs: the counterparts of ``__graft_entry__.entry()``,
of ``bench.py``'s headline and of the train step that
``__graft_entry__.dryrun_multichip`` builds.

``entry``/``build_predictor``: YOLOX-M-P6 (depth 0.67, width 0.75) in bf16
with BN folded. ``build_headline``: the same model slimmed to the committed
channel plan ``artifacts/mp6_chain_slim_spec.json`` and quantized w8a8 with
per-input-channel activation scales (bench.py:163-187, 218-306). Both end in
the single batched postprocess at the production point: conf 0.001, NMS IoU
0.55, pre-NMS top-K 1024, ``max_det`` 300. ``Predictor`` serves batches of
NHWC float images; letterbox resizing stays with the harness, which is not
ported yet. ``build_trainer``: the unfused YOLOX-P6 in train mode with f32
parameters and compute in ``dtype``, and one device's train step (forward,
SimOTA and losses, backward, SGD with nesterov momentum, EMA).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .compress import build_quant_tree, calibrate, load_slim_spec, quantize_weights
from .core.train_state import build_optimizer, create_train_state, make_train_step
from .models.yolox import MODEL_SPECS, YOLOX, build_model
from .ops.fuse import fuse_model
from .ops.nms import NMSResult
from .ops.postprocess import PostprocessConfig, postprocess
from .utils.convert import random_variables

PRODUCTION_CONFIG = PostprocessConfig(conf_threshold=0.001, nms_threshold=0.55,
                                      pre_nms_topk=1024, max_det=300)


class Predictor:
    """Serves requests: a batch of (B, H, W, 3) float images -> one
    ``NMSResult`` of (B, max_det, ...) tensors on the model's device."""

    def __init__(self, model: YOLOX, cfg: PostprocessConfig = PRODUCTION_CONFIG):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def __call__(self, images: Union[torch.Tensor, np.ndarray]) -> NMSResult:
        images = torch.as_tensor(images).to(self.device, torch.float32,
                                            non_blocking=True)
        return postprocess(self.model(images), self.model.strides, self.cfg)


def cast_parameters(model: YOLOX, dtype: torch.dtype) -> YOLOX:
    """Cast the model's parameters (kernels and biases) to ``dtype`` and make
    it the compute dtype. Buffers keep theirs: the int8 kernels and the f32
    scales of a w8a8 model. The same numbers as JAX's casts at each use."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    model.dtype = dtype
    return model


def build_predictor(variables: Mapping[str, Any], depth: float = 0.67,
                    width: float = 0.75, dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cuda",
                    cfg: PostprocessConfig = PRODUCTION_CONFIG) -> Predictor:
    """The serving topology of ``harness/main.py``: a YOLOX-P6 with the given
    (unfused, flax-layout) ``variables`` loaded, BN folded, cast to
    ``dtype``."""
    model = build_model("yolox-p6", depth=depth, width=width, device=device,
                        variables=variables)
    return Predictor(cast_parameters(fuse_model(model), dtype), cfg)


SLIM_SPEC = Path(__file__).resolve().parents[1] / "artifacts" / "mp6_chain_slim_spec.json"


def build_w8a8_predictor(variables: Mapping[str, Any], slim: Mapping[str, Any],
                         depth: float = 0.67, width: float = 0.75,
                         dtype: torch.dtype = torch.bfloat16,
                         device: Union[str, torch.device] = "cuda") -> Predictor:
    """A fused slim YOLOX-P6 built with quant="w8a8", with the quantized
    ``variables`` (compress.quantize_model) loaded, computing in ``dtype``,
    at the production point."""
    model = build_model("yolox-p6", depth=depth, width=width, fused=True,
                        slim=slim, quant="w8a8", device=device, variables=variables)
    return Predictor(cast_parameters(model, dtype))


def build_headline(spec_path: Union[str, Path] = SLIM_SPEC, depth: float = 0.67,
                   width: float = 0.75, dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device] = "cuda",
                   variables: Optional[Mapping[str, Any]] = None) -> Predictor:
    """``bench.py``'s headline: the fused YOLOX-M-P6 slimmed to the channel
    plan at ``spec_path``, with weights drawn from numpy seed 0 (or the
    given fused, slim ``variables``), calibrated in ``dtype`` on
    ``RandomState(1).rand(2, 256, 256, 3) * 255`` (bench.py:238-239),
    quantized w8a8 with per-input-channel activation scales, served in
    ``dtype``. The predictor carries ``variables`` (the quantized tree) and
    ``seconds`` (build, calibration, quantization)."""
    t0 = time.perf_counter()
    slim = load_slim_spec(str(spec_path))
    if variables is None:
        with torch.device("meta"):
            shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width,
                           fused=True, slim=slim)
        variables = random_variables(shapes, 0)
    calib = build_model("yolox-p6", depth=depth, width=width, fused=True, slim=slim,
                        quant="calib", dtype=dtype, device=device, variables=variables)
    t1 = time.perf_counter()
    images = (np.random.RandomState(1).rand(2, 256, 256, 3) * 255).astype(np.float32)
    stats = calibrate(calib, variables, [images])
    t2 = time.perf_counter()
    qvars, quant = quantize_weights(variables, build_quant_tree(stats, per_channel_act=True))
    qvars["quant"] = quant
    t3 = time.perf_counter()
    predictor = build_w8a8_predictor(qvars, slim, depth, width, dtype, device)
    predictor.variables = qvars
    predictor.seconds = {"build": t1 - t0 + time.perf_counter() - t3,
                         "calibrate": t2 - t1, "quantize": t3 - t2}
    return predictor


def entry(device: Union[str, torch.device] = "cuda") -> Tuple[Predictor, Tuple[torch.Tensor]]:
    """(fn, example_args): fused bf16 YOLOX-M-P6 forward + postprocess at
    the production point, with random weights drawn from numpy seed 0."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75)
    fn = build_predictor(random_variables(shapes, 0), device=device)
    return fn, (torch.zeros((1, 256, 256, 3), dtype=torch.float32, device=device),)


def build_trainer(depth: float = 0.67, width: float = 0.75,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device] = "cuda",
                  seed: int = 0) -> Tuple[YOLOX, Callable]:
    """(model, step): the unfused YOLOX-P6 at ``depth``/``width`` in train
    mode, f32 parameters computing in ``dtype``, weights drawn from numpy
    ``seed`` with the head's cls and obj biases at the prior 0.01, and its
    train step (``core/train_state.py::make_train_step``) with the optimizer
    of ``__graft_entry__.dryrun_multichip``: SGD at lr 0.01 with nesterov
    momentum 0.9 and weight decay 5e-4 on the conv kernels, the EMA at
    0.9998, the iou loss, 80 classes, strides (8, 16, 32, 64)."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width)
    model = build_model("yolox-p6", depth=depth, width=width, dtype=dtype, device=device,
                        variables=random_variables(shapes, seed, prior_prob=0.01))
    state = create_train_state(model, build_optimizer(model, 0.01))
    return model, make_train_step(state, model.strides, num_classes=model.num_classes)
