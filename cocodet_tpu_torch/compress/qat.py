"""Quantization-aware fine-tuning (cocodet_tpu/compress/qat.py) over the
fused and slim deployment models.

1. calibrate the activation scales as PTQ does (``quantize.calibrate``,
   ``build_quant_tree``);
2. build the model with ``quant="qat"`` (``models/blocks.py::Conv2d``): each
   quantized conv fake-quantizes its input on the frozen act_scale and its
   float kernel per out channel, forward and backward through the
   fake-quant kernel (``csrc/fake_quant.cu``);
3. fine-tune with ``make_qat_step``: the detection loss (GIoU by default),
   SGD with nesterov momentum and no weight decay (optax's ``sgd``), and
   optionally an EMA shadow of the parameters;
4. ``requantize`` snapshots the tuned float kernels to int8 with the
   absmax/127 recipe of ``quantize.quantize_weights``; the result loads into
   a ``quant="w8a8"`` model.

The step runs eagerly on the card, with cuDNN's TF32 off for its forward
and backward: TF32 would blur the int8 grid the step simulates.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.train_state import SGD
from ..models.blocks import no_tf32
from ..ops.losses import yolox_losses
from ..utils.convert import flatten_tree, unflatten_tree
from ..utils.ema import ModelEMA
from .quantize import quantize_weights

METRICS = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss")
EMA_PRESET = 50_000  # tools/qat_tune.py:153-161: the decay ramp skipped


def qat_optimizer(model: nn.Module, lr: float) -> SGD:
    """``optax.sgd(lr, momentum=0.9, nesterov=True)``: no weight decay."""
    return SGD([{"params": list(model.parameters()), "weight_decay": 0.0}], lr, momentum=0.9)


def qat_ema(model: nn.Module, decay: float) -> ModelEMA:
    """The EMA shadow anchored at the model's current (pre-tune) parameters,
    its update count preset past the warmup ramp, so the decay is ``decay``
    from the first step (qat_tune.py:153-161)."""
    ema = ModelEMA(model, decay)
    ema.updates = EMA_PRESET
    return ema


def make_qat_step(model: nn.Module, optimizer: SGD, strides: Sequence[int],
                  num_classes: int = 80, iou_type: str = "giou",
                  ema: Optional[ModelEMA] = None) -> Callable:
    """The QAT fine-tune step of a ``quant="qat"`` fused model
    (qat.py:43-82), updating the model, the optimizer and ``ema`` in place:

        step(images, labels, use_l1=True) -> metrics

    ``images`` (B, H, W, 3) f32 NHWC on the model's device, ``labels`` (B,
    G, 5). Returns JAX's metrics as device tensors."""

    def step(images: torch.Tensor, labels: torch.Tensor, use_l1: bool = True):
        model.train()
        with no_tf32():
            outputs = model(images)
            losses, _ = yolox_losses(outputs, labels, strides=strides, num_classes=num_classes,
                                     use_l1=use_l1, iou_type=iou_type)
            optimizer.zero_grad(set_to_none=True)
            losses.total.backward()
        optimizer.step()
        if ema is not None:
            ema.update()
        terms = torch.stack([losses.total, losses.iou, losses.obj, losses.cls, losses.l1])
        return dict(zip(METRICS, terms.detach()))

    return step


def act_scale_tree(quant: Mapping) -> Dict:
    """A ``quant`` tree stripped to its act_scale leaves (qat.py:85-90)."""
    return unflatten_tree({p: v for p, v in flatten_tree(quant).items()
                           if p[-1] == "act_scale"})


def requantize(params: Mapping, quant: Mapping) -> Tuple[Dict, Dict]:
    """Tuned float params (a flax-layout tree) -> (params with int8 kernels,
    the ``quant`` tree with per-channel ``w_scale`` and the frozen
    ``act_scale``), through ``quantize_weights`` (qat.py:93-108): a (cin,)
    act_scale is folded into its kernel before the per-out-channel scale."""
    qvars, quant_out = quantize_weights({"params": params}, act_scale_tree(quant))
    return qvars["params"], quant_out
