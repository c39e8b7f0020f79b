"""Core building blocks of the YOLOX model family, in PyTorch.

Counterpart of ``cocodet_tpu/models/blocks.py``. Modules take and return
NCHW tensors, which the model keeps in ``torch.channels_last`` memory, so a
permute from or to the JAX package's NHWC layout is a view and costs no copy.
Submodules are named after the flax scopes of the JAX modules (``conv``,
``bn``, ``conv1``, ``m0``, ...), so ``utils/convert.py`` maps a flax variable
tree onto a module tree with one rule per leaf.

Every module computes in the dtype of its input: a conv casts its weights to
that dtype (a no-op once the model itself was cast), as the JAX ``Conv2d``
casts its kernel to ``dtype``. The one exception is the Focus stem, which
hands its conv the f32 images and the model's dtype, as JAX does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.int8_conv import conv2d_w8a8


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------


def get_activation(name: str = "silu") -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (cocodet_tpu/models/blocks.py:48-63)."""
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name in ("hsilu", "hswish", "hard_silu", "hard_swish"):
        return F.hardswish
    if name == "relu":
        return F.relu
    if name in ("lrelu", "leaky_relu"):
        return lambda x: F.leaky_relu(x, 0.1)
    if name == "mish":
        return lambda x: x * torch.tanh(F.softplus(x))
    if name in ("identity", "none"):
        return lambda x: x
    raise ValueError(f"Unsupported act type: {name}")


# --------------------------------------------------------------------------
# Conv2d / ConvBnAct
# --------------------------------------------------------------------------


class Conv2d(nn.Module):
    """Plain conv with symmetric padding ``((k-1)*dilation)//2``
    (cocodet_tpu/models/blocks.py:156-344). ``weight`` is OIHW (the flax
    kernel is HWIO).

    ``forward(x, dtype=None)`` computes in ``dtype``, by default the dtype
    of ``x``; the float path casts ``x`` and the weights to it (:339-340).

    ``quant`` is the int8 PTQ mode of the JAX ``Conv2d`` (compress/
    quantize.py):

    - ``None``: float conv (:338-343);
    - ``"calib"``: float conv that max-reduces the per-input-channel absmax
      of its input, taken in f32 before any cast, into the ``act_absmax``
      buffer (cin,), the counterpart of the ``quant_stats`` sow (:235-247);
      ``compress.calibrate`` zeroes it before a run;
    - ``"w8a8"``: ``weight`` is an int8 buffer (OIHW in channels-last
      memory, so physically OHWI, the layout of the CUDA kernel), with the
      buffers ``w_scale`` (cout,) f32 and ``act_scale``, an f32 scalar or a
      (cin,) vector: whichever shape the loaded variables give it. The conv
      is ``ops/cuda/int8_conv.py::conv2d_w8a8`` (:248-283).
    """

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 use_bias: bool = False, quant: Optional[str] = None):
        super().__init__()
        if quant not in (None, "calib", "w8a8"):
            raise ValueError(f"unsupported quant mode {quant!r}")
        self.stride, self.groups, self.dilation = stride, groups, dilation
        self.padding = ((kernel_size - 1) * dilation) // 2
        self.quant = quant
        shape = (features, cin // groups, kernel_size, kernel_size)
        if quant == "w8a8":
            self.register_buffer("weight", torch.empty(shape, dtype=torch.int8))
            self.register_buffer("w_scale", torch.empty(features))
            self.register_buffer("act_scale", torch.empty(()))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        if quant == "calib":
            self.register_buffer("act_absmax", torch.zeros(cin))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        if self.quant == "w8a8":
            return conv2d_w8a8(x, self.weight, self.act_scale, self.w_scale, b,
                               self.stride, self.padding, self.dilation,
                               self.groups, dtype)
        if self.quant == "calib":
            absmax = x.detach().float().abs().amax(dim=(0, 2, 3))
            torch.maximum(self.act_absmax, absmax, out=self.act_absmax)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BN with the JAX package's constants: eps 1e-3 and the torch
    convention momentum 0.03 (blocks.py:371-372). It normalises in f32 and
    casts back to the input dtype, as flax's BatchNorm with ``dtype`` does."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("the port's models run in eval mode only")
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(x.dtype)


class ConvBnAct(nn.Module):
    """Conv -> BN -> activation (blocks.py:347-415). ``fused=True`` is the
    inference topology: the conv carries a bias and there is no BN. ``quant``
    applies to the fused topology only, as in JAX (:397-398)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: str = "silu", fused: bool = False,
                 quant: Optional[str] = None):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, stride, groups,
                           dilation, use_bias=fused,
                           quant=quant if fused else None)
        self.bn = None if fused else BatchNorm(features)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = self.conv(x, dtype)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (blocks.py:418-440)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        kw = dict(act=act, fused=fused, quant=quant)
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, **kw)
        self.pconv = ConvBnAct(cin, features, 1, 1, **kw)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class DWConvNoP(nn.Module):
    """Depthwise conv only (blocks.py:443-465)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        if features != cin:
            raise ValueError(f"DWConvNoP keeps the width: {cin} -> {features}")
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, act=act, fused=fused,
                               quant=quant)

    def forward(self, x):
        return self.dconv(x)


# --------------------------------------------------------------------------
# Bottlenecks / CSP layers
#
# Each module takes its input width ``cin``; one whose output width a
# channel-slim pin can change exposes it as ``out_width``. So a slimmed model
# (compress/merge.py::load_slim_spec) derives every input width from its
# slimmed producer, as flax infers it from the array.
# --------------------------------------------------------------------------


class Bottleneck(nn.Module):
    """1x1 reduce -> kxk conv, optional residual (blocks.py:473-536).
    ``hidden_width`` and ``out_width`` are the channel-slim pins of conv1's
    and conv2's widths (:494-508); a residual block keeps ``features``."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 kernel_size: int = 3, dilation: int = 1, act: str = "silu",
                 is_last: bool = False, custom: bool = False,
                 fused: bool = False, quant: Optional[str] = None,
                 hidden_width: Optional[int] = None,
                 out_width: Optional[int] = None):
        super().__init__()
        hidden = hidden_width if hidden_width is not None else int(features * expansion)
        self.use_add = shortcut and cin == features
        out = features if self.use_add or out_width is None else out_width
        self.out_width = out
        kw = dict(act=act, fused=fused, quant=quant)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        if depthwise and custom and not is_last and not self.use_add:
            self.conv2 = DWConvNoP(hidden, out, kernel_size, 1, dilation, **kw)
        elif depthwise:
            self.conv2 = DWConv(hidden, out, kernel_size, 1, dilation, **kw)
        else:
            self.conv2 = ConvBnAct(hidden, out, kernel_size, 1,
                                   dilation=dilation, **kw)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, symmetric padding with -inf (NCHW)
    (blocks.py:558-568). PyTorch's max pool pads with -inf."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (blocks.py:571-609), with the channel-slim
    pins ``hidden_width`` (default ``cin // 2``) and ``out_width`` (default
    ``features``) of :588-601."""

    def __init__(self, cin: int, features: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None,
                 hidden_width: Optional[int] = None,
                 out_width: Optional[int] = None):
        super().__init__()
        hidden = hidden_width if hidden_width is not None else cin // 2
        self.out_width = out_width if out_width is not None else features
        self.kernel_sizes = tuple(kernel_sizes)
        kw = dict(act=act, fused=fused, quant=quant)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        self.conv2 = ConvBnAct(hidden * (len(self.kernel_sizes) + 1),
                               self.out_width, 1, 1, **kw)

    def forward(self, x):
        x = self.conv1(x)
        xs = [x] + [max_pool_same(x, k) for k in self.kernel_sizes]
        return self.conv2(torch.cat(xs, dim=1))


class CSPLayer(nn.Module):
    """CSP bottleneck with 3 convs (blocks.py:612-709). With ``custom`` the
    bypass conv2 emits ``cin - hidden`` channels, so the concat ``[x1, x2]``
    is exactly ``cin`` wide.

    ``slim`` holds the channel-slim pins (:640-680): ``{i: (hidden, out)}``
    for bottleneck i (None keeps a default), ``"res"`` for the residual
    stream (conv1 and every bottleneck) and ``"c2"`` for the bypass."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, kernel_size: int = 3,
                 dilation: int = 1, act: str = "silu", custom: bool = False,
                 fused: bool = False, quant: Optional[str] = None,
                 slim: Optional[Dict[Any, Any]] = None):
        super().__init__()
        slim = slim or {}
        hidden = slim.get("res", int(features * expansion))
        c2 = slim.get("c2", (cin - hidden) if custom else hidden)
        kw = dict(act=act, fused=fused, quant=quant)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        self.conv2 = ConvBnAct(cin, c2, 1, 1, **kw)
        self.n = n
        width = hidden
        for i in range(n):
            hw, ow = slim.get(i, (None, None))
            block = Bottleneck(
                width, hidden, shortcut=shortcut, expansion=1.0,
                depthwise=depthwise, kernel_size=kernel_size,
                dilation=dilation, is_last=(i == n - 1), custom=custom,
                hidden_width=hw, out_width=ow, **kw)
            self.add_module(f"m{i}", block)
            width = block.out_width
        self.conv3 = ConvBnAct(width + c2, features, 1, 1, **kw)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.conv3(torch.cat([x1, x2], dim=1))


# --------------------------------------------------------------------------
# Focus — space-to-depth stem
# --------------------------------------------------------------------------


def space_to_depth(x: torch.Tensor, order: str = "pixel_unshuffle") -> torch.Tensor:
    """NHWC space-to-depth with a factor of 2 (blocks.py:717-735).

    order="pixel_unshuffle": out channel c*4 + i*2 + j (row offset i, column
    offset j), as ``F.pixel_unshuffle``. order="slice_cat": [tl, bl, tr, br]
    blocks of c channels, the original Focus slice-concat order.
    """
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)  # (b, h2, i, w2, j, c)
    if order == "pixel_unshuffle":
        x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h2, w2, c, i, j)
    elif order == "slice_cat":
        x = x.permute(0, 1, 3, 4, 2, 5)  # (b, h2, w2, j, i, c)
    else:
        raise ValueError(order)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class Focus(nn.Module):
    """Space-to-depth + conv stem (blocks.py:738-760). Takes NHWC images and
    returns an NCHW (channels-last) map in ``dtype``. The conv receives the
    images as they come (f32), as in JAX: the float conv casts them, and a
    ``"calib"`` or ``"w8a8"`` conv takes its absmax or quantizes them
    before any cast."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, act: str = "silu", order: str = "slice_cat",
                 fused: bool = False, quant: Optional[str] = None):
        super().__init__()
        self.order = order
        self.conv = ConvBnAct(4 * cin, features, kernel_size, stride, act=act,
                              fused=fused, quant=quant)

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = space_to_depth(x_nhwc, self.order).permute(0, 3, 1, 2)
        return self.conv(x, dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW) (blocks.py:763-767)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
