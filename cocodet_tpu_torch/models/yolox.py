"""YOLOX model wrapper + registry (cocodet_tpu/models/yolox.py:30-155).

The wrapper composes PAFPN + head and exposes raw per-level maps; decode and
NMS live in ``cocodet_tpu_torch/ops``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..utils.convert import load_variables, random_variables
from .head import YOLOXHead
from .pafpn import YOLOPAFPN


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of one model family member."""

    variant: str               # pafpn/backbone variant key
    strides: Tuple[int, ...]   # per-level anchor strides
    act: str = "hard_swish"
    depthwise: bool = False


MODEL_SPECS = {
    "yolox": ModelSpec("standard", (8, 16, 32), act="silu"),
    "yolox-dw": ModelSpec("standard", (8, 16, 32), act="silu", depthwise=True),
    "yolox-custom": ModelSpec("custom", (8, 16, 32)),
    "yolox-p6": ModelSpec("p6", (8, 16, 32, 64)),
    "yolox-p6v2": ModelSpec("p6v2", (8, 16, 32, 64)),
    "yolov3": ModelSpec("yolofpn", (8, 16, 32), act="lrelu"),
}


class YOLOX(nn.Module):
    """PAFPN backbone+neck and decoupled head.

    ``forward`` takes NHWC float images (B, H, W, 3) and returns a list over
    levels of ``{"reg","obj","cls"}`` NHWC maps in ``dtype``, the compute
    dtype (the JAX model's ``dtype``). Parameters may stay f32 while the
    compute dtype is bf16, as in flax; cast the model to serve without the
    per-call weight casts. ``use_mask`` builds the ChannelMask model of the
    Pruner and Tuner (cocodet_tpu/models/yolox.py:70-132); ``forward(images,
    return_taps=True)`` returns ``(maps, taps)``, the distillation taps of
    the PAFPN. ``weight_mask`` builds SynFlow's model: the backbone's and
    the PAFPN's CSP convs carry a ``conv_mask`` (yolox.py:71-108).
    ``stem6`` and ``split_cat`` are the deployment rewrites of the fused
    model (yolox.py:74-81, 111; models/pafpn.py): the 6x6 stem and the
    concat-free merges. A ``split_cat`` model takes no remat
    (``core/train_state.py::make_forward`` raises, as yolox.py:81-87).
    """

    def __init__(self, spec: ModelSpec, num_classes: int = 80,
                 depth: float = 1.0, width: float = 1.0, fused: bool = False,
                 dtype: torch.dtype = torch.float32,
                 slim: Optional[Mapping[str, Any]] = None,
                 quant: Optional[str] = None, use_mask: bool = False,
                 weight_mask: bool = False, stem6: bool = False, split_cat: bool = False):
        super().__init__()
        if spec.variant == "yolofpn":
            raise NotImplementedError(
                "the yolov3 Darknet-53 + YOLOFPN model is not ported yet")
        self.spec, self.num_classes = spec, num_classes
        self.depth, self.width, self.fused, self.dtype = depth, width, fused, dtype
        self.slim, self.quant, self.use_mask = slim, quant, use_mask
        self.weight_mask, self.stem6, self.split_cat = weight_mask, stem6, split_cat
        self.backbone = YOLOPAFPN(variant=spec.variant, depth=depth,
                                  width=width, act=spec.act,
                                  depthwise=spec.depthwise, fused=fused,
                                  quant=quant, slim=slim, use_mask=use_mask,
                                  weight_mask=weight_mask, stem6=stem6, split_cat=split_cat)
        self.head = YOLOXHead(self.backbone.widths, num_classes=num_classes,
                              width=width, act=spec.act, fused=fused,
                              quant=quant, slim=(slim or {}).get("head"),
                              use_mask=use_mask)

    @property
    def strides(self) -> Tuple[int, ...]:
        return self.spec.strides

    def forward(self, images: torch.Tensor, return_taps: bool = False):
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got {tuple(images.shape)}")
        if return_taps:
            outs, taps = self.backbone(images, self.dtype, return_taps=True)
            return self.head(outs), taps
        return self.head(self.backbone(images, self.dtype))


def build_model(
    name: str = "yolox-p6",
    num_classes: int = 80,
    depth: float = 1.0,
    width: float = 1.0,
    fused: bool = False,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    variables: Optional[Mapping[str, Any]] = None,
    slim: Optional[Mapping[str, Any]] = None,
    quant: Optional[str] = None,
    use_mask: bool = False,
    weight_mask: bool = False,
    stem6: bool = False,
    split_cat: bool = False,
) -> YOLOX:
    """Model registry. ``name`` keys into MODEL_SPECS.

    The competition model is build_model("yolox-p6", depth=0.67, width=0.75).
    The weights are the JAX model's flax ``variables`` (utils/convert.py), or,
    without them, drawn from numpy seed 0 (``random_variables``). The model
    lives on ``device`` in channels-last memory, in eval mode. ``slim`` is a
    channel-slim map (compress/merge.py::load_slim_spec) and ``quant`` the
    int8 mode of the fused topology (None, "calib", "w8a8" or "qat"), as in
    cocodet_tpu/models/yolox.py:69-75,140-155. ``use_mask`` builds the
    ChannelMask model and ``weight_mask`` SynFlow's; ``variables`` then
    carry their ``masks`` collection, and the random weights have every
    gate open (scale 1, offset 0) and every ``conv_mask`` 1.
    """
    if name not in MODEL_SPECS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_SPECS)}")
    with torch.device("meta"):  # no init: every weight is loaded below
        model = YOLOX(MODEL_SPECS[name], num_classes=num_classes, depth=depth,
                      width=width, fused=fused, dtype=dtype, slim=slim,
                      quant=quant, use_mask=use_mask, weight_mask=weight_mask,
                      stem6=stem6, split_cat=split_cat)
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    load_variables(model, random_variables(model, 0) if variables is None else variables)
    return model.eval()
