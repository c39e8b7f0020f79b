"""The port's flagship inference program: the counterpart of
``__graft_entry__.entry()``.

YOLOX-M-P6 (depth 0.67, width 0.75) in bf16 with BN folded, then the single
batched postprocess at the production point: conf 0.001, NMS IoU 0.55,
pre-NMS top-K 1024, ``max_det`` 300. ``Predictor`` serves batches of NHWC
float images; letterbox resizing stays with the harness, which is not ported
yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple, Union

import numpy as np
import torch

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


def build_predictor(variables: Mapping[str, Any], depth: float = 0.67,
                    width: float = 0.75, dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cuda",
                    cfg: PostprocessConfig = PRODUCTION_CONFIG) -> Predictor:
    """The serving topology of ``harness/main.py``: a YOLOX-P6 with the given
    (unfused, flax-layout) ``variables`` loaded, BN folded, cast to
    ``dtype``."""
    model = build_model("yolox-p6", depth=depth, width=width, device=device,
                        variables=variables)
    model = fuse_model(model).to(dtype=dtype)
    model.dtype = dtype
    return Predictor(model, cfg)


def entry(device: Union[str, torch.device] = "cuda") -> Tuple[Predictor, Tuple[torch.Tensor]]:
    """(fn, example_args): fused bf16 YOLOX-M-P6 forward + postprocess at
    the production point, with random weights drawn from numpy seed 0."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75)
    fn = build_predictor(random_variables(shapes, 0), device=device)
    return fn, (torch.zeros((1, 256, 256, 3), dtype=torch.float32, device=device),)
