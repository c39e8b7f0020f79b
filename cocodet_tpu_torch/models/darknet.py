"""CSPDarknet backbone family (cocodet_tpu/models/darknet.py:95-182).

One parametric ``CSPBackbone`` over stage tables, as in the JAX package. The
legacy Darknet-21/53 of the ``yolov3`` model is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from .blocks import ConvBnAct, CSPLayer, Focus, SPPBottleneck


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One backbone stage: strided conv (+optional SPP) + CSP layer."""

    name: str
    out_mult: int          # out channels = base_channels * out_mult
    n_mult: int            # csp depth = base_depth * n_mult
    shortcut: bool = True
    spp: bool = False      # SPP between downsample conv and CSP
    kernel_size: int = 3   # CSP bottleneck kernel
    depthwise: bool = False


# Channel/depth plans (darknet.py:45-92). base = int(width*64),
# base_depth = max(round(depth*3), 1).
_STANDARD_STAGES = (
    StageSpec("dark2", 2, 1),
    StageSpec("dark3", 4, 3),
    StageSpec("dark4", 8, 3),
    StageSpec("dark5", 16, 1, shortcut=False, spp=True),
)
_CUSTOM_STAGES = (
    StageSpec("dark2", 2, 1),
    StageSpec("dark3", 4, 3),
    StageSpec("dark4", 8, 3),
    StageSpec("dark5", 12, 1, shortcut=False, spp=True, kernel_size=5, depthwise=True),
)
_P6_STAGES = (
    StageSpec("dark2", 2, 1),
    StageSpec("dark3", 4, 3),
    StageSpec("dark4", 8, 3),
    StageSpec("dark5", 12, 1, shortcut=False),
    StageSpec("dark6", 16, 1, shortcut=False, spp=True),
)
_P6V2_STAGES = (
    StageSpec("dark2", 2, 1),
    StageSpec("dark3", 4, 3),
    StageSpec("dark4", 8, 3),
    StageSpec("dark5", 12, 3, shortcut=False),
    StageSpec("dark6", 16, 1, shortcut=False, spp=True),
)

BACKBONE_STAGES = {
    "standard": _STANDARD_STAGES,
    "custom": _CUSTOM_STAGES,
    "p6": _P6_STAGES,
    "p6v2": _P6V2_STAGES,
}

# Downsample-conv kernel size per variant (4x4 s2 in custom/p6v2, else 3x3).
_DOWN_KERNEL = {"standard": 3, "custom": 4, "p6": 3, "p6v2": 4}
# Focus space-to-depth channel order (see blocks.space_to_depth).
_FOCUS_ORDER = {
    "standard": "slice_cat",
    "custom": "pixel_unshuffle",
    "p6": "pixel_unshuffle",
    "p6v2": "pixel_unshuffle",
}


class CSPBackbone(nn.Module):
    """Parametric CSPDarknet: Focus stem + N (conv s2, [SPP], CSP) stages.

    Takes NHWC images, returns ``{stage_name: NCHW map}`` for
    ``out_features``; ``channels`` gives each stage's width. ``slim`` is the
    channel-slim map of compress/merge.py::load_slim_spec: the widths
    ``stem`` and ``darkN_down``, ``darkN_spp`` ``{"hidden", "out"}`` and
    the ``darkN_csp`` tables (cocodet_tpu/models/darknet.py:133-179).
    ``quant`` and ``weight_mask`` go to every conv; ``use_mask`` gates the
    stem, the down convs, the SPP and the CSP layers (ChannelMask,
    blocks.py).

    Deployment rewrites of the fused topology (darknet.py:115-176):
    ``stem6`` builds the stem as the one 6x6 stride-2 conv (padding 2) on
    the images that the Focus stem is (``ops/fuse.py::fold_focus_stem``
    rewrites its weights exactly); ``split_cat`` hands the SPP's and the
    CSP layers' last 1x1 convs their concat's parts (blocks.py).
    """

    def __init__(self, variant: str = "p6", depth: float = 1.0,
                 width: float = 1.0,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5", "dark6"),
                 act: str = "hard_swish", depthwise: bool = False,
                 fused: bool = False, quant: Optional[str] = None,
                 slim: Optional[Dict[str, Any]] = None, use_mask: bool = False,
                 weight_mask: bool = False, stem6: bool = False, split_cat: bool = False):
        super().__init__()
        stages = BACKBONE_STAGES[variant]
        custom = variant != "standard"
        base = int(width * 64)
        base_depth = max(round(depth * 3), 1)
        slim = slim or {}
        kw = dict(act=act, fused=fused, quant=quant, weight_mask=weight_mask)
        self.out_features = tuple(out_features)
        self.stage_names = [s.name for s in stages]
        cin = int(slim.get("stem", base))
        self.stem6 = stem6
        if stem6:
            if not fused:
                raise ValueError("stem6 is a deployment (fused) topology")
            self.stem = ConvBnAct(3, cin, 6, 2, **kw)
        else:
            self.stem = Focus(3, cin, kernel_size=3, order=_FOCUS_ORDER[variant],
                              use_mask=use_mask, **kw)
        self.channels: Dict[str, int] = {"stem": cin}
        for spec in stages:
            feats = base * spec.out_mult
            down_w = int(slim.get(f"{spec.name}_down", feats))
            self.add_module(f"{spec.name}_down", ConvBnAct(
                cin, down_w, _DOWN_KERNEL[variant], 2, use_mask=use_mask, **kw))
            cin = down_w
            if spec.spp:
                spp_slim = slim.get(f"{spec.name}_spp") or {}
                spp = SPPBottleneck(cin, feats, hidden_width=spp_slim.get("hidden"),
                                    out_width=spp_slim.get("out"), use_mask=use_mask,
                                    split_cat=split_cat, **kw)
                self.add_module(f"{spec.name}_spp", spp)
                cin = spp.out_width
            self.add_module(f"{spec.name}_csp", CSPLayer(
                cin, feats, n=base_depth * spec.n_mult,
                shortcut=spec.shortcut,
                depthwise=spec.depthwise or depthwise,
                kernel_size=spec.kernel_size, custom=custom,
                slim=slim.get(f"{spec.name}_csp"), use_mask=use_mask, split_cat=split_cat,
                **kw))
            self.channels[spec.name] = cin = feats

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        if self.stem6:  # the conv takes the images as they come, as Focus's does
            x = self.stem(x_nhwc.permute(0, 3, 1, 2), dtype)
        else:
            x = self.stem(x_nhwc, dtype)
        outputs = {"stem": x}
        for name in self.stage_names:
            x = getattr(self, f"{name}_down")(x)
            spp = getattr(self, f"{name}_spp", None)
            if spp is not None:
                x = spp(x)
            x = getattr(self, f"{name}_csp")(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
