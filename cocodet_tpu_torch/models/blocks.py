"""Core building blocks of the YOLOX model family, in PyTorch.

Counterpart of ``cocodet_tpu/models/blocks.py``. Modules take and return
NCHW tensors, which the model keeps in ``torch.channels_last`` memory, so a
permute from or to the JAX package's NHWC layout is a view and costs no copy.
Submodules are named after the flax scopes of the JAX modules (``conv``,
``bn``, ``conv1``, ``m0``, ...), so ``utils/convert.py`` maps a flax variable
tree onto a module tree with one rule per leaf.

Every module computes in the dtype of its input: a conv casts its weights to
that dtype (a no-op once the model itself was cast), as the JAX ``Conv2d``
casts its kernel to ``dtype``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


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
    (cocodet_tpu/models/blocks.py:156-344, float branch :338-343).
    ``weight`` is OIHW (the flax kernel is HWIO)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.stride, self.groups, self.dilation = stride, groups, dilation
        self.padding = ((kernel_size - 1) * dilation) // 2
        self.weight = nn.Parameter(
            torch.empty(features, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)


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
    inference topology: the conv carries a bias and there is no BN."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: str = "silu", fused: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, stride, groups,
                           dilation, use_bias=fused)
        self.bn = None if fused else BatchNorm(features)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (blocks.py:418-440)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False):
        super().__init__()
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, act=act, fused=fused)
        self.pconv = ConvBnAct(cin, features, 1, 1, act=act, fused=fused)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class DWConvNoP(nn.Module):
    """Depthwise conv only (blocks.py:443-465)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False):
        super().__init__()
        if features != cin:
            raise ValueError(f"DWConvNoP keeps the width: {cin} -> {features}")
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, act=act, fused=fused)

    def forward(self, x):
        return self.dconv(x)


# --------------------------------------------------------------------------
# Bottlenecks / CSP layers
# --------------------------------------------------------------------------


class Bottleneck(nn.Module):
    """1x1 reduce -> kxk conv, optional residual (blocks.py:473-536)."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 kernel_size: int = 3, dilation: int = 1, act: str = "silu",
                 is_last: bool = False, custom: bool = False,
                 fused: bool = False):
        super().__init__()
        hidden = int(features * expansion)
        self.use_add = shortcut and cin == features
        kw = dict(act=act, fused=fused)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        if depthwise and custom and not is_last and not self.use_add:
            self.conv2 = DWConvNoP(hidden, features, kernel_size, 1, dilation,
                                   **kw)
        elif depthwise:
            self.conv2 = DWConv(hidden, features, kernel_size, 1, dilation,
                                **kw)
        else:
            self.conv2 = ConvBnAct(hidden, features, kernel_size, 1,
                                   dilation=dilation, **kw)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, symmetric padding with -inf (NCHW)
    (blocks.py:558-568). PyTorch's max pool pads with -inf."""
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (blocks.py:571-609)."""

    def __init__(self, cin: int, features: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 fused: bool = False):
        super().__init__()
        hidden = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, act=act, fused=fused)
        self.conv2 = ConvBnAct(hidden * (len(self.kernel_sizes) + 1), features,
                               1, 1, act=act, fused=fused)

    def forward(self, x):
        x = self.conv1(x)
        xs = [x] + [max_pool_same(x, k) for k in self.kernel_sizes]
        return self.conv2(torch.cat(xs, dim=1))


class CSPLayer(nn.Module):
    """CSP bottleneck with 3 convs (blocks.py:612-709). With ``custom`` the
    bypass conv2 emits ``cin - hidden`` channels, so the concat ``[x1, x2]``
    is exactly ``cin`` wide."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, kernel_size: int = 3,
                 dilation: int = 1, act: str = "silu", custom: bool = False,
                 fused: bool = False):
        super().__init__()
        hidden = int(features * expansion)
        c2 = (cin - hidden) if custom else hidden
        kw = dict(act=act, fused=fused)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        self.conv2 = ConvBnAct(cin, c2, 1, 1, **kw)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(
                hidden, hidden, shortcut=shortcut, expansion=1.0,
                depthwise=depthwise, kernel_size=kernel_size,
                dilation=dilation, is_last=(i == n - 1), custom=custom, **kw))
        self.conv3 = ConvBnAct(hidden + c2, features, 1, 1, **kw)

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
    returns an NCHW (channels-last) map."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, act: str = "silu", order: str = "slice_cat",
                 fused: bool = False):
        super().__init__()
        self.order = order
        self.conv = ConvBnAct(4 * cin, features, kernel_size, stride, act=act,
                              fused=fused)

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = space_to_depth(x_nhwc, self.order).permute(0, 3, 1, 2)
        return self.conv(x.to(dtype))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW) (blocks.py:763-767)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
