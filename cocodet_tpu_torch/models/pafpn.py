"""PAFPN neck (cocodet_tpu/models/pafpn.py:35-181).

Top-down pass: for level k = L-1 .. 1:
    lat[k]   = 1x1 conv (w[k] -> w[k-1]) at level-k resolution
    carry    = CSP(cat(upsample2x(lat[k]), backbone[k-1])) -> w[k-1]
Bottom-up pass: out[0] = carry; for k = 1 .. L-1:
    out[k]   = CSP(cat(s2-conv(out[k-1]), lat[k])) -> w[k]

Module names follow the flax scopes: lateral{k}, td_csp{k}, bu_conv{k},
bu_csp{k}, and the backbone under ``backbone``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .blocks import ConvBnAct, CSPLayer, upsample2x
from .darknet import CSPBackbone

PAFPN_VARIANTS: Dict[str, Dict[str, Any]] = {
    "standard": dict(
        backbone="standard", custom=False, kernel_size=3, depthwise=False,
        down_kernel=3, in_features=("dark3", "dark4", "dark5"),
        in_channels=(256, 512, 1024),
    ),
    "custom": dict(
        backbone="custom", custom=True, kernel_size=5, depthwise=True,
        down_kernel=4, in_features=("dark3", "dark4", "dark5"),
        in_channels=(256, 512, 768),
    ),
    "p6": dict(
        backbone="p6", custom=True, kernel_size=3, depthwise=False,
        down_kernel=3, in_features=("dark3", "dark4", "dark5", "dark6"),
        in_channels=(256, 512, 768, 1024),
    ),
    "p6v2": dict(
        backbone="p6v2", custom=True, kernel_size=3, depthwise=False,
        down_kernel=4, in_features=("dark3", "dark4", "dark5", "dark6"),
        in_channels=(256, 512, 768, 1024),
    ),
}


class YOLOPAFPN(nn.Module):
    """Parametric PAFPN over a CSPBackbone. ``forward`` returns the pyramid
    outputs shallowest (stride 8) first; ``widths`` gives their channels.
    ``use_mask`` gates every conv but the CSPs' conv3 (pafpn.py:98-106,
    128-157); ``forward(..., return_taps=True)`` also returns the
    distillation taps (pafpn.py:170-181)."""

    def __init__(self, variant: str = "p6", depth: float = 1.0,
                 width: float = 1.0, act: str = "hard_swish",
                 depthwise: bool = False, fused: bool = False,
                 quant: Optional[str] = None,
                 slim: Optional[Dict[str, Any]] = None, use_mask: bool = False):
        super().__init__()
        cfg = PAFPN_VARIANTS[variant]
        self.in_features: Tuple[str, ...] = tuple(cfg["in_features"])
        widths = [int(c * width) for c in cfg["in_channels"]]
        self.widths = widths
        L = self.num_levels = len(widths)
        slim = slim or {}
        kw = dict(act=act, fused=fused, quant=quant)
        csp_kw = dict(n=round(3 * depth), shortcut=False,
                      kernel_size=cfg["kernel_size"],
                      depthwise=cfg["depthwise"] or depthwise,
                      custom=cfg["custom"], use_mask=use_mask, **kw)
        self.backbone = CSPBackbone(variant=cfg["backbone"], depth=depth,
                                    width=width, out_features=self.in_features,
                                    depthwise=depthwise, slim=slim, use_mask=use_mask,
                                    **kw)
        ch = [self.backbone.channels[f] for f in self.in_features]

        # slim pins (cocodet_tpu/models/pafpn.py:115-167): the widths of
        # lateral{k} and bu_conv{k}, the td_csp{k} / bu_csp{k} tables
        lat_w: Dict[int, int] = {}
        carry = ch[L - 1]
        for k in range(L - 1, 0, -1):
            lat_w[k] = int(slim.get(f"lateral{k}", widths[k - 1]))
            self.add_module(f"lateral{k}", ConvBnAct(carry, lat_w[k], 1, 1,
                                                     use_mask=use_mask, **kw))
            self.add_module(f"td_csp{k}", CSPLayer(
                lat_w[k] + ch[k - 1], widths[k - 1],
                slim=slim.get(f"td_csp{k}"), **csp_kw))
            carry = widths[k - 1]
        for k in range(1, L):
            bu_w = int(slim.get(f"bu_conv{k}", widths[k - 1]))
            self.add_module(f"bu_conv{k}", ConvBnAct(
                widths[k - 1], bu_w, cfg["down_kernel"], 2, use_mask=use_mask, **kw))
            self.add_module(f"bu_csp{k}", CSPLayer(
                bu_w + lat_w[k], widths[k], slim=slim.get(f"bu_csp{k}"),
                **csp_kw))

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype, return_taps: bool = False):
        feats = self.backbone(x_nhwc, dtype)
        xs = [feats[f] for f in self.in_features]
        L = self.num_levels

        lats: Dict[int, torch.Tensor] = {}
        td: Dict[int, torch.Tensor] = {}
        carry = xs[L - 1]
        for k in range(L - 1, 0, -1):
            lat = getattr(self, f"lateral{k}")(carry)
            lats[k] = lat
            merged = torch.cat([upsample2x(lat), xs[k - 1]], dim=1)
            carry = getattr(self, f"td_csp{k}")(merged)
            td[k - 1] = carry

        outs = [carry]
        for k in range(1, L):
            p = getattr(self, f"bu_conv{k}")(outs[-1])
            outs.append(getattr(self, f"bu_csp{k}")(torch.cat([p, lats[k]], dim=1)))
        outs = tuple(outs)
        if not return_taps:
            return outs
        # the backbone's features, the top-down intermediates deepest first
        # without level 0 (it is outs[0]), and the outputs (pafpn.py:170-181)
        return outs, {"backbone": tuple(xs),
                      "td": tuple(td[i] for i in sorted(td, reverse=True) if i != 0),
                      "pan": outs}
