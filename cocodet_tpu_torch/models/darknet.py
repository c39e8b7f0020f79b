"""CSPDarknet backbone family (cocodet_tpu/models/darknet.py:95-182) and the
legacy Darknet-21/53 of the ``yolov3`` model (:185-229).

One parametric ``CSPBackbone`` over stage tables, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from .blocks import ConvBnAct, CSPLayer, Focus, ResLayer, SPPBottleneck


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


class Darknet(nn.Module):
    """Legacy YOLOv3 Darknet-21/53 (darknet.py:185-229): a 3x3 stem conv,
    then stride-2 groups (a 3x3 conv to twice the width and ``ResLayer``s),
    lrelu throughout; dark5 ends in the SPP block (``spp_conv1..4`` around
    an ``SPPBottleneck`` on 1024 channels, hidden 512). Takes NHWC images,
    returns ``{stage: NCHW map}`` for dark3, dark4 and dark5 (the JAX
    module's default ``out_features`` and stem width 32, the only ones any
    model uses)."""

    DEPTH2BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}
    out_features = ("dark3", "dark4", "dark5")

    def __init__(self, depth: int = 53, fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        kw = dict(fused=fused, quant=quant)
        lrelu = dict(act="lrelu", **kw)
        self.num_blocks = self.DEPTH2BLOCKS[depth]
        c = 32
        self.stem_conv = ConvBnAct(3, c, 3, 1, **lrelu)

        def group(cin, n, prefix):
            self.add_module(f"{prefix}_conv", ConvBnAct(cin, cin * 2, 3, 2, **lrelu))
            for i in range(n):
                self.add_module(f"{prefix}_res{i}", ResLayer(cin * 2, **kw))

        group(c, 1, "stem_g")
        cin = c * 2
        for name, n in zip(("dark2", "dark3", "dark4"), self.num_blocks):
            group(cin, n, name)
            cin *= 2
        group(cin, self.num_blocks[3], "dark5")
        self.spp_conv1 = ConvBnAct(cin * 2, cin, 1, 1, **lrelu)
        self.spp_conv2 = ConvBnAct(cin, cin * 2, 3, 1, **lrelu)
        self.spp = SPPBottleneck(cin * 2, cin, **lrelu)
        self.spp_conv3 = ConvBnAct(cin, cin * 2, 3, 1, **lrelu)
        self.spp_conv4 = ConvBnAct(cin * 2, cin, 1, 1, **lrelu)

    def _group(self, x, n, prefix):
        x = getattr(self, f"{prefix}_conv")(x)
        for i in range(n):
            x = getattr(self, f"{prefix}_res{i}")(x)
        return x

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        x = self.stem_conv(x_nhwc.permute(0, 3, 1, 2), dtype)
        x = self._group(x, 1, "stem_g")
        outputs = {"stem": x}
        for name, n in zip(("dark2", "dark3", "dark4", "dark5"), self.num_blocks):
            x = self._group(x, n, name)
            if name == "dark5":
                for spp in ("spp_conv1", "spp_conv2", "spp", "spp_conv3", "spp_conv4"):
                    x = getattr(self, spp)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
