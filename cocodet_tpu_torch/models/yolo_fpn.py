"""Legacy YOLOv3 FPN over Darknet-53 (cocodet_tpu/models/yolo_fpn.py:21-56):
an lrelu 1x1 lateral, a 2x upsample and the concat ``[up, x]``, then a
5-conv embedding, for each of the two upper levels. Outputs ``(out_dark3,
out_dark4, dark5)``, 128, 256 and 512 channels, shallowest first. It
ignores the model's depth and width, as JAX's does."""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .blocks import ConvBnAct, upsample2x
from .darknet import Darknet


class YOLOFPN(nn.Module):
    widths = (128, 256, 512)

    def __init__(self, fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        kw = dict(act="lrelu", fused=fused, quant=quant)
        self.backbone = Darknet(fused=fused, quant=quant)
        self.out1_cbl = ConvBnAct(512, 256, 1, 1, **kw)
        self.out2_cbl = ConvBnAct(256, 128, 1, 1, **kw)
        # 1x1/3x3 alternating 5-conv stacks (yolo_fpn.py:37-42)
        for prefix, cin, (w0, w1) in (("out1", 256 + 512, (256, 512)),
                                      ("out2", 128 + 256, (128, 256))):
            for i, (w, k) in enumerate(((w0, 1), (w1, 3), (w0, 1), (w1, 3), (w0, 1))):
                self.add_module(f"{prefix}_{i}", ConvBnAct(cin, w, k, 1, **kw))
                cin = w

    def _embedding(self, x, prefix):
        for i in range(5):
            x = getattr(self, f"{prefix}_{i}")(x)
        return x

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> List[torch.Tensor]:
        feats = self.backbone(x_nhwc, dtype)
        x2, x1, x0 = (feats[f] for f in Darknet.out_features)
        b1 = torch.cat([upsample2x(self.out1_cbl(x0)), x1], dim=1)
        out_dark4 = self._embedding(b1, "out1")
        b2 = torch.cat([upsample2x(self.out2_cbl(out_dark4)), x2], dim=1)
        out_dark3 = self._embedding(b2, "out2")
        return [out_dark3, out_dark4, x0]
