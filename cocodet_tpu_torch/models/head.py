"""Decoupled anchor-free YOLOX head (cocodet_tpu/models/head.py:29-86).

Produces only the raw per-level maps; decode and NMS are plain functions in
``cocodet_tpu_torch/ops``. ``obj_pred`` reads the regression tower.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from .blocks import Conv2d, ConvBnAct


class YOLOXHead(nn.Module):
    """Per-scale stem + cls/reg towers + 1x1 prediction convs.

    ``forward`` takes NCHW maps and returns a list over scales of dicts
    ``{"reg": (B,H,W,4), "obj": (B,H,W,1), "cls": (B,H,W,num_classes)}``:
    NHWC views of the channels-last conv outputs. ``use_mask`` gates the
    stems and towers, not the prediction convs (head.py:44-57).
    """

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80,
                 width: float = 1.0, act: str = "hard_swish", fused: bool = False,
                 quant: Optional[str] = None,
                 slim: Optional[Mapping[str, int]] = None, use_mask: bool = False):
        super().__init__()
        self.num_levels = len(in_channels)
        feat = int(256 * width)
        slim = slim or {}
        kw = dict(act=act, fused=fused, quant=quant, use_mask=use_mask)

        def add(name, cin, k):
            """A stem or tower conv at its slim width (head.py:49-73)."""
            w = int(slim.get(name, feat))
            self.add_module(name, ConvBnAct(cin, w, k, 1, **kw))
            return w

        for k, cin in enumerate(in_channels):
            stem_w = add(f"stem{k}", cin, 1)
            cls_w = add(f"cls_conv{k}_1", add(f"cls_conv{k}_0", stem_w, 3), 3)
            reg_w = add(f"reg_conv{k}_1", add(f"reg_conv{k}_0", stem_w, 3), 3)
            # the prediction convs stay float (compress/quantize.py:21-24)
            self.add_module(f"cls_pred{k}", Conv2d(cls_w, num_classes, 1, use_bias=True))
            self.add_module(f"reg_pred{k}", Conv2d(reg_w, 4, 1, use_bias=True))
            self.add_module(f"obj_pred{k}", Conv2d(reg_w, 1, 1, use_bias=True))

    def forward(self, xin: Sequence[torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        if len(xin) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(xin)}")
        outputs = []
        for k, x in enumerate(xin):
            x = getattr(self, f"stem{k}")(x)
            cls_feat = getattr(self, f"cls_conv{k}_1")(getattr(self, f"cls_conv{k}_0")(x))
            reg_feat = getattr(self, f"reg_conv{k}_1")(getattr(self, f"reg_conv{k}_0")(x))
            nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
            outputs.append({
                "reg": nhwc(getattr(self, f"reg_pred{k}")(reg_feat)),
                "obj": nhwc(getattr(self, f"obj_pred{k}")(reg_feat)),
                "cls": nhwc(getattr(self, f"cls_pred{k}")(cls_feat)),
            })
        return outputs
