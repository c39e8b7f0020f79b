"""The anchor-based detector family (YOLOv5 / ScaledYOLOv4), spec-driven
(cocodet_tpu/models/anchor_zoo.py).

The reference's multi-model submission predictors: YOLOv5m6 (C3, SPPF,
silu) and ScaledYOLOv4 P5/P6/P7/CSP (BottleneckCSP/CSP2, SPPCSP, the Affine
gate, mish). ``AnchorDetector`` interprets a spec tuple of the yaml's
``(from, number, module, args)`` rows in order, with ultralytics'
parse_model rules: widths ``make_divisible(c * width_multiple)`` (multiples
of 8), depths ``max(round(n * depth_multiple), 1)``. ``fused=True`` is the
BN-folded inference topology the reference ships (conv biases, Affine
gates); ``fused=False`` keeps BN. The raw per-level Detect maps come out,
and ``decode_anchor_outputs`` turns them into (boxes, obj, cls) for
``ops/nms.py::batched_nms``:

    y = sigmoid(p);  xy = (2y - 0.5 + grid) * stride;  wh = (2y)^2 * anchor_px

Modules take and return NCHW maps in channels-last memory, as the rest of
the port; ``AnchorDetector`` takes NHWC images and returns NHWC maps (views,
no copy). Submodules are named after the flax scopes (``l{i}_{module}``,
``ConvBnAct_0`` inside a ``VConv``, ``m{i}``, ``cv{j}``, ``bn``,
``detect_m{k}``), so ``utils/convert.py`` carries a flax tree across with
one rule per leaf. A fused Affine gate's scale is the flax param ``weight``,
held here as ``gain`` (``weight`` is a BN's ``scale``). ``quant`` reaches
the ``VConv`` convs as in JAX (not the plain ``cv2``/``cv3`` convs of the
CSP blocks, nor Detect).

Every module computes in the dtype of its input. The first layer gets the
f32 images and the model's ``dtype``, as the JAX model's first conv casts
(or, quantized, quantizes) them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv2d, ConvBnAct, max_pool_same, upsample2x


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) (anchor_zoo.py:39-40)."""
    return x * torch.tanh(F.softplus(x))


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


# --------------------------------------------------------------------------
# building blocks (NCHW, channels-last)
# --------------------------------------------------------------------------


class VConv(nn.Module):
    """Conv(+BN)+act, the ultralytics Conv (anchor_zoo.py:49-67): a
    ``ConvBnAct`` with BN momentum 0.03 and eps 1e-3 (the port's BN
    constants), in flax's auto-named scope ``ConvBnAct_0``."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1, stride: int = 1,
                 groups: int = 1, act: str = "silu", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        self.ConvBnAct_0 = ConvBnAct(cin, features, kernel_size, stride, groups=groups,
                                     act=act, fused=fused, quant=quant)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.ConvBnAct_0(x, dtype)


class AffineGate(nn.Module):
    """BN over a concat in the trainable topology; its folded per-channel
    affine ``x * weight + bias`` in the fused one (anchor_zoo.py:70-86).
    The flax BatchNorm is auto-named ``BatchNorm_0``."""

    def __init__(self, features: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        if fused:
            self.gain = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return x * self.gain.to(x.dtype).view(1, -1, 1, 1) + \
                self.bias.to(x.dtype).view(1, -1, 1, 1)
        return self.BatchNorm_0(x)


class VBottleneck(nn.Module):
    """1x1 then 3x3 VConv, with the residual where the widths agree
    (anchor_zoo.py:89-105)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "silu", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        hidden = int(features * expansion)
        kw = dict(act=act, fused=fused, quant=quant)
        self.cv1 = VConv(cin, hidden, 1, **kw)
        self.cv2 = VConv(hidden, features, 3, **kw)
        self.add = shortcut and cin == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return y + x if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (anchor_zoo.py:108-130)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "silu", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        hidden = int(features * expansion)
        kw = dict(act=act, fused=fused, quant=quant)
        self.n = n
        self.cv1 = VConv(cin, hidden, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", VBottleneck(hidden, hidden, shortcut, 1.0, **kw))
        self.cv2 = VConv(cin, hidden, 1, **kw)
        self.cv3 = VConv(2 * hidden, features, 1, **kw)

    def forward(self, x):
        x1 = self.cv1(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.cv3(torch.cat([x1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Serial k x k pool pyramid (anchor_zoo.py:133-151)."""

    def __init__(self, cin: int, features: int, k: int = 5, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        kw = dict(act=act, fused=fused, quant=quant)
        self.k = k
        self.cv1 = VConv(cin, cin // 2, 1, **kw)
        self.cv2 = VConv(4 * (cin // 2), features, 1, **kw)

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


def _float_conv(cin: int, features: int) -> Conv2d:
    """The plain 1x1 conv with a bias of the v4 CSP blocks (never quantized)."""
    return Conv2d(cin, features, 1, use_bias=True)


class BottleneckCSP(nn.Module):
    """v4 CSP block (anchor_zoo.py:154-183)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, act: str = "mish", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        hidden = int(features * expansion)
        kw = dict(act=act, fused=fused, quant=quant)
        self.n = n
        self.cv1 = VConv(cin, hidden, 1, **kw)
        self.cv2 = _float_conv(cin, hidden)
        for i in range(n):
            self.add_module(f"m{i}", VBottleneck(hidden, hidden, shortcut, 1.0, **kw))
        self.cv3 = _float_conv(hidden, hidden)
        self.bn = AffineGate(2 * hidden, fused=fused)
        self.cv4 = VConv(2 * hidden, features, 1, **kw)

    def forward(self, x):
        x1 = self.cv1(x)
        x2 = self.cv2(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        x1 = self.cv3(x1)
        return self.cv4(mish(self.bn(torch.cat([x1, x2], dim=1))))


class BottleneckCSP2(nn.Module):
    """v4 head CSP block (anchor_zoo.py:186-212)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False,
                 act: str = "mish", fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        hidden = int(features)
        kw = dict(act=act, fused=fused, quant=quant)
        self.n = n
        self.cv1 = VConv(cin, hidden, 1, **kw)
        for i in range(n):
            self.add_module(f"m{i}", VBottleneck(hidden, hidden, shortcut, 1.0, **kw))
        self.cv2 = _float_conv(hidden, hidden)
        self.bn = AffineGate(2 * hidden, fused=fused)
        self.cv3 = VConv(2 * hidden, features, 1, **kw)

    def forward(self, x):
        x0 = self.cv1(x)
        x1 = x0
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.cv3(mish(self.bn(torch.cat([x1, self.cv2(x0)], dim=1))))


class SPPCSP(nn.Module):
    """v4 SPP-CSP (anchor_zoo.py:215-244)."""

    def __init__(self, cin: int, features: int, kernel_sizes: Sequence[int] = (5, 9, 13),
                 expansion: float = 0.5, act: str = "mish", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        hidden = int(2 * features * expansion)
        kw = dict(act=act, fused=fused, quant=quant)
        self.kernel_sizes = tuple(kernel_sizes)
        self.cv1 = VConv(cin, hidden, 1, **kw)
        self.cv3 = VConv(hidden, hidden, 3, **kw)
        self.cv4 = VConv(hidden, hidden, 1, **kw)
        self.cv5 = VConv(hidden * (len(self.kernel_sizes) + 1), hidden, 1, **kw)
        self.cv6 = VConv(hidden, hidden, 3, **kw)
        self.cv2 = _float_conv(cin, hidden)
        self.bn = AffineGate(2 * hidden, fused=fused)
        self.cv7 = VConv(2 * hidden, features, 1, **kw)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = torch.cat([x1] + [max_pool_same(x1, k) for k in self.kernel_sizes], dim=1)
        y1 = self.cv6(self.cv5(y1))
        y = torch.cat([y1, self.cv2(x)], dim=1)
        return self.cv7(mish(self.bn(y)))


_BLOCKS = {"C3": C3, "SPPF": SPPF, "Bottleneck": VBottleneck, "BottleneckCSP": BottleneckCSP,
           "BottleneckCSP2": BottleneckCSP2, "SPPCSP": SPPCSP}


class AnchorDetector(nn.Module):
    """Interprets a (backbone + head) layer spec like ultralytics
    parse_model (anchor_zoo.py:250-319). ``forward`` takes NHWC images and
    returns the list of raw per-level Detect conv outputs, each NHWC (B, H,
    W, na*(5+nc)) in ``dtype``."""

    def __init__(self, spec: Tuple, num_classes: int = 80, num_anchors: int = 3,
                 depth_multiple: float = 1.0, width_multiple: float = 1.0, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec, self.num_classes, self.num_anchors = spec, num_classes, num_anchors
        self.dtype = dtype
        gd, gw = depth_multiple, width_multiple
        kw = dict(act=act, fused=fused, quant=quant)
        chans: List[int] = []   # each layer's output channels
        self.detect: Optional[Tuple[int, ...]] = None
        for li, (frm, number, module, args) in enumerate(spec):
            n = max(round(number * gd), 1) if number > 1 else number
            cin = [3 if li == 0 else chans[-1] if f == -1 else chans[f]
                   for f in (frm if isinstance(frm, (list, tuple)) else (frm,))]
            name = f"l{li}_{module.replace('.', '_')}"
            if module == "Concat":
                chans.append(sum(cin))
                continue
            if module == "nn.Upsample":
                chans.append(cin[0])
                continue
            if module == "Detect":
                no = num_anchors * (5 + num_classes)
                for k, c in enumerate(cin):
                    self.add_module(f"detect_m{k}", Conv2d(c, no, 1, use_bias=True))
                self.detect = tuple(frm)
                break
            if module not in ("Conv", *_BLOCKS):
                raise ValueError(f"unknown module {module!r}")
            c2 = make_divisible(args[0] * gw)
            if module == "Conv":
                k = args[1] if len(args) > 1 else 1
                s = args[2] if len(args) > 2 else 1
                layer = VConv(cin[0], c2, k, s, **kw)
            elif module == "C3":
                layer = C3(cin[0], c2, n=n, shortcut=args[1] if len(args) > 1 else True, **kw)
            elif module == "SPPF":
                layer = SPPF(cin[0], c2, k=args[1] if len(args) > 1 else 5, **kw)
            elif module == "Bottleneck":
                layer = VBottleneck(cin[0], c2, **kw)
            elif module == "SPPCSP":
                layer = SPPCSP(cin[0], c2, **kw)
            else:
                layer = _BLOCKS[module](cin[0], c2, n=n, **kw)
            self.add_module(name, layer)
            chans.append(c2)
        if self.detect is None:
            raise ValueError("spec has no Detect layer")

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        if images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected NHWC images (B, H, W, 3), got {tuple(images.shape)}")
        x = images.permute(0, 3, 1, 2)
        outputs: List[torch.Tensor] = []
        for li, (frm, _, module, _) in enumerate(self.spec):
            if isinstance(frm, (list, tuple)):
                inp = [x if f == -1 else outputs[f] for f in frm]
            else:
                inp = x if frm == -1 else outputs[frm]
            if module == "Detect":
                return [getattr(self, f"detect_m{k}")(t).permute(0, 2, 3, 1)
                        for k, t in enumerate(inp)]
            if module == "Concat":
                x = torch.cat(list(inp), dim=1)
            elif module == "nn.Upsample":
                x = upsample2x(inp)
            else:
                layer = getattr(self, f"l{li}_{module.replace('.', '_')}")
                if li == 0 and module == "Conv":
                    x = layer(inp, self.dtype)  # the images in f32, the conv in dtype
                else:
                    x = layer(inp.to(self.dtype) if li == 0 else inp)
            outputs.append(x)
        raise ValueError("spec has no Detect layer")


def decode_anchor_outputs(outputs: Sequence[torch.Tensor],
                          anchors_px: Sequence[Sequence[float]],
                          strides: Sequence[int], num_classes: int):
    """Anchor decode (anchor_zoo.py:322-348) of NHWC maps, in f32 ->
    (boxes_xyxy (B, A, 4), obj (B, A, 1), cls (B, A, C) obj-multiplied)."""
    all_boxes, all_obj, all_cls = [], [], []
    for out, anc, s in zip(outputs, anchors_px, strides):
        b, h, w, _ = out.shape
        na = len(anc) // 2
        no = out.shape[-1] // na
        y = torch.sigmoid(out.reshape(b, h, w, na, no).float())
        yv, xv = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=out.device),
                                torch.arange(w, dtype=torch.float32, device=out.device),
                                indexing="ij")
        grid = torch.stack([xv, yv], -1)[None, :, :, None, :]
        anc_arr = torch.tensor(anc, dtype=torch.float32, device=out.device).reshape(
            1, 1, 1, na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(s)
        wh = torch.square(y[..., 2:4] * 2.0) * anc_arr
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        all_boxes.append(boxes.reshape(b, -1, 4))
        all_obj.append(y[..., 4:5].reshape(b, -1, 1))
        all_cls.append((y[..., 5:] * y[..., 4:5]).reshape(b, -1, num_classes))
    return torch.cat(all_boxes, 1), torch.cat(all_obj, 1), torch.cat(all_cls, 1)


# --------------------------------------------------------------------------
# model registry: the specs transcribed from the reference yamls
# --------------------------------------------------------------------------

# ref submit/models/yolov5m6.yaml (v6.0 graph)
YOLOV5_6_SPEC = (
    (-1, 1, "Conv", (64, 6, 2)),
    (-1, 1, "Conv", (128, 3, 2)),
    (-1, 3, "C3", (128,)),
    (-1, 1, "Conv", (256, 3, 2)),
    (-1, 6, "C3", (256,)),
    (-1, 1, "Conv", (512, 3, 2)),
    (-1, 9, "C3", (512,)),
    (-1, 1, "Conv", (768, 3, 2)),
    (-1, 3, "C3", (768,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 3, "C3", (1024,)),
    (-1, 1, "SPPF", (1024, 5)),
    (-1, 1, "Conv", (768, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    ((-1, 8), 1, "Concat", ()),
    (-1, 3, "C3", (768, False)),
    (-1, 1, "Conv", (512, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    ((-1, 6), 1, "Concat", ()),
    (-1, 3, "C3", (512, False)),
    (-1, 1, "Conv", (256, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    ((-1, 4), 1, "Concat", ()),
    (-1, 3, "C3", (256, False)),
    (-1, 1, "Conv", (256, 3, 2)),
    ((-1, 20), 1, "Concat", ()),
    (-1, 3, "C3", (512, False)),
    (-1, 1, "Conv", (512, 3, 2)),
    ((-1, 16), 1, "Concat", ()),
    (-1, 3, "C3", (768, False)),
    (-1, 1, "Conv", (768, 3, 2)),
    ((-1, 12), 1, "Concat", ()),
    (-1, 3, "C3", (1024, False)),
    ((23, 26, 29, 32), 1, "Detect", ()),
)

# anchors in input pixels (ref submit/models/yolov5m6.yaml:7-11)
YOLOV5M6_ANCHORS = (
    (19, 27, 44, 40, 38, 94),
    (96, 68, 86, 152, 180, 137),
    (140, 301, 303, 264, 238, 542),
    (436, 615, 739, 380, 925, 792),
)

# ref submit/yolov4_infer/models/yolov4-p6.yaml
YOLOV4_P6_SPEC = (
    (-1, 1, "Conv", (32, 3, 1)),
    (-1, 1, "Conv", (64, 3, 2)),
    (-1, 1, "BottleneckCSP", (64,)),
    (-1, 1, "Conv", (128, 3, 2)),
    (-1, 3, "BottleneckCSP", (128,)),
    (-1, 1, "Conv", (256, 3, 2)),
    (-1, 15, "BottleneckCSP", (256,)),
    (-1, 1, "Conv", (512, 3, 2)),
    (-1, 15, "BottleneckCSP", (512,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),
    (-1, 1, "SPPCSP", (512,)),                     # 13
    (-1, 1, "Conv", (512, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (10, 1, "Conv", (512, 1, 1)),                  # yaml -6 == abs 10
    ((-1, 15), 1, "Concat", ()),                   # yaml [-1,-2]
    (-1, 3, "BottleneckCSP2", (512,)),             # 18
    (-1, 1, "Conv", (256, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (8, 1, "Conv", (256, 1, 1)),                   # yaml -13 == abs 8
    ((-1, 20), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),             # 23
    (-1, 1, "Conv", (128, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (6, 1, "Conv", (128, 1, 1)),                   # yaml -20 == abs 6
    ((-1, 25), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (128,)),             # 28
    (-1, 1, "Conv", (256, 3, 1)),                  # 29 -> P3 out
    (28, 1, "Conv", (256, 3, 2)),                  # yaml -2
    ((-1, 23), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),             # 32
    (-1, 1, "Conv", (512, 3, 1)),                  # 33 -> P4 out
    (32, 1, "Conv", (512, 3, 2)),                  # yaml -2
    ((-1, 18), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),             # 36
    (-1, 1, "Conv", (1024, 3, 1)),                 # 37 -> P5 out
    (36, 1, "Conv", (512, 3, 2)),                  # yaml -2
    ((-1, 13), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),             # 40
    (-1, 1, "Conv", (1024, 3, 1)),                 # 41 -> P6 out
    ((29, 33, 37, 41), 1, "Detect", ()),
)

YOLOV4_P6_ANCHORS = (
    (13, 17, 31, 25, 24, 51, 61, 45),
    (61, 45, 48, 102, 119, 96, 97, 189),
    (97, 189, 217, 184, 171, 384, 324, 451),
    (324, 451, 545, 357, 616, 618, 1024, 1024),
)

# ref submit/yolov4_infer/models/yolov4-p5.yaml
YOLOV4_P5_SPEC = (
    (-1, 1, "Conv", (32, 3, 1)),
    (-1, 1, "Conv", (64, 3, 2)),
    (-1, 1, "BottleneckCSP", (64,)),
    (-1, 1, "Conv", (128, 3, 2)),
    (-1, 3, "BottleneckCSP", (128,)),
    (-1, 1, "Conv", (256, 3, 2)),
    (-1, 15, "BottleneckCSP", (256,)),
    (-1, 1, "Conv", (512, 3, 2)),
    (-1, 15, "BottleneckCSP", (512,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),
    (-1, 1, "SPPCSP", (512,)),                   # 11
    (-1, 1, "Conv", (256, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (8, 1, "Conv", (256, 1, 1)),
    ((-1, 13), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),           # 16
    (-1, 1, "Conv", (128, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (6, 1, "Conv", (128, 1, 1)),
    ((-1, 18), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (128,)),           # 21
    (-1, 1, "Conv", (256, 3, 1)),                # 22 -> P3
    (21, 1, "Conv", (256, 3, 2)),                # yaml -2
    ((-1, 16), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),           # 25
    (-1, 1, "Conv", (512, 3, 1)),                # 26 -> P4
    (25, 1, "Conv", (512, 3, 2)),                # yaml -2
    ((-1, 11), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 29
    (-1, 1, "Conv", (1024, 3, 1)),               # 30 -> P5
    ((22, 26, 30), 1, "Detect", ()),
)

YOLOV4_P5_ANCHORS = (
    (13, 17, 31, 25, 24, 51, 61, 45),
    (48, 102, 119, 96, 97, 189, 217, 184),
    (171, 384, 324, 451, 616, 618, 800, 800),
)

# ref submit/yolov4_infer/models/yolov4-csp.yaml (3 anchors a level, mish)
YOLOV4_CSP_SPEC = (
    (-1, 1, "Conv", (32, 3, 1)),
    (-1, 1, "Conv", (64, 3, 2)),
    (-1, 1, "Bottleneck", (64,)),
    (-1, 1, "Conv", (128, 3, 2)),
    (-1, 2, "BottleneckCSP", (128,)),
    (-1, 1, "Conv", (256, 3, 2)),
    (-1, 8, "BottleneckCSP", (256,)),
    (-1, 1, "Conv", (512, 3, 2)),
    (-1, 8, "BottleneckCSP", (512,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 4, "BottleneckCSP", (1024,)),
    (-1, 1, "SPPCSP", (512,)),                   # 11
    (-1, 1, "Conv", (256, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (8, 1, "Conv", (256, 1, 1)),
    ((-1, 13), 1, "Concat", ()),
    (-1, 2, "BottleneckCSP2", (256,)),           # 16
    (-1, 1, "Conv", (128, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (6, 1, "Conv", (128, 1, 1)),
    ((-1, 18), 1, "Concat", ()),
    (-1, 2, "BottleneckCSP2", (128,)),           # 21
    (-1, 1, "Conv", (256, 3, 1)),                # 22 -> P3
    (21, 1, "Conv", (256, 3, 2)),
    ((-1, 16), 1, "Concat", ()),
    (-1, 2, "BottleneckCSP2", (256,)),           # 25
    (-1, 1, "Conv", (512, 3, 1)),                # 26 -> P4
    (25, 1, "Conv", (512, 3, 2)),
    ((-1, 11), 1, "Concat", ()),
    (-1, 2, "BottleneckCSP2", (512,)),           # 29
    (-1, 1, "Conv", (1024, 3, 1)),               # 30 -> P5
    ((22, 26, 30), 1, "Detect", ()),
)

YOLOV4_CSP_ANCHORS = (
    (12, 16, 19, 36, 40, 28),
    (36, 75, 76, 55, 72, 146),
    (142, 110, 192, 243, 459, 401),
)

# ref submit/yolov4_infer/models/yolov4-p7.yaml (5 levels, width 1.25)
YOLOV4_P7_SPEC = (
    (-1, 1, "Conv", (32, 3, 1)),
    (-1, 1, "Conv", (64, 3, 2)),
    (-1, 1, "BottleneckCSP", (64,)),
    (-1, 1, "Conv", (128, 3, 2)),
    (-1, 3, "BottleneckCSP", (128,)),
    (-1, 1, "Conv", (256, 3, 2)),
    (-1, 15, "BottleneckCSP", (256,)),
    (-1, 1, "Conv", (512, 3, 2)),
    (-1, 15, "BottleneckCSP", (512,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),
    (-1, 1, "Conv", (1024, 3, 2)),
    (-1, 7, "BottleneckCSP", (1024,)),           # 14
    (-1, 1, "SPPCSP", (512,)),                   # 15
    (-1, 1, "Conv", (512, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (12, 1, "Conv", (512, 1, 1)),                # yaml -6
    ((-1, 17), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 20
    (-1, 1, "Conv", (512, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (10, 1, "Conv", (512, 1, 1)),                # yaml -13
    ((-1, 22), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 25
    (-1, 1, "Conv", (256, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (8, 1, "Conv", (256, 1, 1)),                 # yaml -20
    ((-1, 27), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),           # 30
    (-1, 1, "Conv", (128, 1, 1)),
    (-1, 1, "nn.Upsample", ()),
    (6, 1, "Conv", (128, 1, 1)),                 # yaml -27
    ((-1, 32), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (128,)),           # 35
    (-1, 1, "Conv", (256, 3, 1)),                # 36 -> P3
    (35, 1, "Conv", (256, 3, 2)),
    ((-1, 30), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (256,)),           # 39
    (-1, 1, "Conv", (512, 3, 1)),                # 40 -> P4
    (39, 1, "Conv", (512, 3, 2)),
    ((-1, 25), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 43
    (-1, 1, "Conv", (1024, 3, 1)),               # 44 -> P5
    (43, 1, "Conv", (512, 3, 2)),
    ((-1, 20), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 47
    (-1, 1, "Conv", (1024, 3, 1)),               # 48 -> P6
    (47, 1, "Conv", (512, 3, 2)),
    ((-1, 15), 1, "Concat", ()),
    (-1, 3, "BottleneckCSP2", (512,)),           # 51
    (-1, 1, "Conv", (1024, 3, 1)),               # 52 -> P7
    ((36, 40, 44, 48, 52), 1, "Detect", ()),
)

YOLOV4_P7_ANCHORS = (
    (13, 17, 22, 25, 27, 66, 55, 41),
    (57, 88, 112, 69, 69, 177, 136, 138),
    (136, 138, 287, 114, 134, 275, 268, 248),
    (268, 248, 232, 504, 445, 416, 640, 640),
    (812, 393, 477, 808, 1070, 908, 1408, 1408),
)

ANCHOR_MODELS = {
    "yolov5m6": dict(spec=YOLOV5_6_SPEC, anchors=YOLOV5M6_ANCHORS,
                     strides=(8, 16, 32, 64), depth_multiple=0.67,
                     width_multiple=0.75, act="silu", num_anchors=3),
    "yolov4-p6": dict(spec=YOLOV4_P6_SPEC, anchors=YOLOV4_P6_ANCHORS,
                      strides=(8, 16, 32, 64), depth_multiple=1.0,
                      width_multiple=1.0, act="mish", num_anchors=4),
    "yolov4-p5": dict(spec=YOLOV4_P5_SPEC, anchors=YOLOV4_P5_ANCHORS,
                      strides=(8, 16, 32), depth_multiple=1.0,
                      width_multiple=1.0, act="mish", num_anchors=4),
    "yolov4-csp": dict(spec=YOLOV4_CSP_SPEC, anchors=YOLOV4_CSP_ANCHORS,
                       strides=(8, 16, 32), depth_multiple=1.0,
                       width_multiple=1.0, act="mish", num_anchors=3),
    "yolov4-p7": dict(spec=YOLOV4_P7_SPEC, anchors=YOLOV4_P7_ANCHORS,
                      strides=(8, 16, 32, 64, 128), depth_multiple=1.0,
                      width_multiple=1.25, act="mish", num_anchors=4),
}


def build_anchor_model(name: str, num_classes: int = 80, fused: bool = True,
                       dtype: torch.dtype = torch.float32,
                       width_multiple: Optional[float] = None):
    """(module, anchors, strides) of ``ANCHOR_MODELS[name]`` (anchor_zoo.py:
    623-632), its weights not yet loaded (``utils/convert.py::
    load_variables`` or ``random_variables``). ``width_multiple`` overrides
    the published width (the tests' small models)."""
    cfg = ANCHOR_MODELS[name]
    model = AnchorDetector(
        spec=cfg["spec"], num_classes=num_classes, num_anchors=cfg["num_anchors"],
        depth_multiple=cfg["depth_multiple"],
        width_multiple=cfg["width_multiple"] if width_multiple is None else width_multiple,
        act=cfg["act"], fused=fused, dtype=dtype)
    return model, cfg["anchors"], cfg["strides"]
