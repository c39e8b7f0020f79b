"""The w8a8 convolution: int8 implicit GEMM with the activation quantize
fused on input and the rescale and bias fused on output.

The kernel is ``cocodet_tpu_torch/csrc/int8_conv.cu``, whose header gives
its design. It computes the w8a8 branch of cocodet_tpu/models/blocks.py::
Conv2d (:248-283), which JAX left to XLA:

    xq  = clip(round_half_even(x.float() / act_scale), -127, 127)
    acc = conv(xq, weight)                    s32, exact
    y   = (acc.float() * out_scale).to(dtype) + bias.to(dtype)

``out_scale`` is ``w_scale`` when ``act_scale`` is a (C,) vector (per-channel:
quantize_weights folded it into the kernel) and ``act_scale * w_scale``
when it is a scalar. The division is IEEE (never a multiply by the
reciprocal), and padding is int8 zero: JAX quantizes first, then pads.

Layouts: ``x`` is (B, C, H, W) in channels-last memory, f32 or bf16;
``weight`` is (O, C/groups, k, k) int8 in channels-last memory (physically
OHWI); the output is (B, O, Ho, Wo) in channels-last memory, in ``dtype``.

``conv2d_w8a8_plain`` is the plain version: the conv of the quantized
values in float64, which is exact (the longest reduction of the slim
YOLOX-M-P6, K = 3*3*576 = 5184, sums to at most 5184 * 127^2 < 2^27, far
below 2^53), converted to s32, then the same epilogue. It takes any conv.

``conv2d_w8a8`` takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it launches the kernel or raises; it never falls
back. The kernel takes groups=1, dilation=1, a square kernel of 1 or 3,
stride 1 or 2 and padding (k-1)//2. Launches are counted in
``conv2d_w8a8.launches``; ``int8_conv_acc`` is the debug entry that also
returns the s32 accumulators, and counts its launches there too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

_SOURCE = "int8_conv"
_DTYPES = (torch.float32, torch.bfloat16)


def _bcast(scale: torch.Tensor) -> torch.Tensor:
    """A (C,) per-channel scale as (1, C, 1, 1); a scalar as it is."""
    return scale.view(1, -1, 1, 1) if scale.dim() else scale


def quantize_activations(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(x.float() / act_scale), -127, 127): the int8
    values, held in f32 (blocks.py:278-279)."""
    return torch.clamp(torch.round(x.float() / _bcast(act_scale)), -127, 127)


def int8_conv_acc_plain(xq: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                        padding: int = 0, dilation: int = 1,
                        groups: int = 1) -> torch.Tensor:
    """The s32 accumulators of the conv of the quantized values, computed
    in float64 (exact below 2^53)."""
    acc = F.conv2d(xq.double(), weight.double(), None, stride, padding,
                   dilation, groups)
    return acc.to(torch.int32)


def rescale_plain(acc: torch.Tensor, act_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``(acc.float() * out_scale).to(dtype) + bias.to(dtype)``, rounded at
    the places blocks.py:283 and :343 round; ``out_scale`` is ``w_scale``, or
    the f32 product ``act_scale * w_scale`` for a scalar ``act_scale``
    (blocks.py:282)."""
    out_scale = w_scale if act_scale.dim() else act_scale * w_scale
    y = (acc.float() * _bcast(out_scale)).to(dtype)
    return y if bias is None else y + _bcast(bias.to(dtype))


def conv2d_w8a8_plain(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int = 1, padding: int = 0, dilation: int = 1,
                      groups: int = 1,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of ``conv2d_w8a8``, for any conv."""
    acc = int8_conv_acc_plain(quantize_activations(x, act_scale), weight,
                              stride, padding, dilation, groups)
    return rescale_plain(acc, act_scale, w_scale, bias, dtype or x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_int8_conv.argtypes = [p, i, p, p, i, p, p, p, i, p,
                                      i, i, i, i, i, i, i, i, i, p]
    lib.cocodet_int8_conv.restype = i
    return lib


def _check(name: str, t: torch.Tensor, device, dtypes, shape=None,
           channels_last: bool = False, align: int = 4) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name} must be contiguous in {fmt}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
            w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            padding: int, dilation: int, groups: int, dtype: torch.dtype,
            with_acc: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    o, c_g, kh, kw = weight.shape
    b, c, h, w = x.shape
    if not (groups == 1 and dilation == 1 and kh == kw and kh in (1, 3)
            and stride in (1, 2) and padding == (kh - 1) // 2):
        raise ValueError(
            f"the int8 conv kernel takes groups=1, dilation=1, a 1x1 or 3x3 kernel, "
            f"stride 1 or 2 and padding (k-1)//2; got groups={groups}, dilation="
            f"{dilation}, kernel {kh}x{kw}, stride {stride}, padding {padding}")
    if dtype not in _DTYPES:
        raise TypeError(f"the int8 conv kernel writes f32 or bf16, not {dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on cuda, not {x.device}")
    dev = x.device
    fast = c % 32 == 0  # the kernel's vector path reads 16-byte vectors
    _check("x", x, dev, _DTYPES, channels_last=True, align=16 if fast else 4)
    _check("weight", weight, dev, (torch.int8,), (o, c, kh, kw), channels_last=True,
           align=16 if fast else 1)
    _check("act_scale", act_scale, dev, (torch.float32,),
           (c,) if act_scale.dim() else ())
    _check("w_scale", w_scale, dev, (torch.float32,), (o,))
    if bias is not None:
        _check("bias", bias, dev, (dtype,), (o,))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    y = torch.empty((b, o, ho, wo), dtype=dtype, device=dev,
                    memory_format=torch.channels_last)
    acc = (torch.empty((b, o, ho, wo), dtype=torch.int32, device=dev,
                       memory_format=torch.channels_last) if with_acc else None)
    if y.numel() == 0:
        return y, acc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_int8_conv(
            x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(),
            act_scale.data_ptr(), int(act_scale.dim() == 1), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            int(dtype == torch.bfloat16), None if acc is None else acc.data_ptr(),
            b, h, w, c, o, kh, stride, ho, wo, stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: error {rc}")
    conv2d_w8a8.launches += 1
    return y, acc


def conv2d_w8a8(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding: int = 0, dilation: int = 1,
                groups: int = 1, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The w8a8 conv of ``x`` in ``dtype`` (default: ``x.dtype``); layouts
    and numerics in the module docstring."""
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        return conv2d_w8a8_plain(x, weight, act_scale, w_scale, bias, stride,
                                 padding, dilation, groups, dtype)
    return _launch(x, weight, act_scale, w_scale, bias, stride, padding,
                   dilation, groups, dtype, with_acc=False)[0]


conv2d_w8a8.launches = 0


def int8_conv_acc(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                  w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int = 1, padding: int = 0, dilation: int = 1,
                  groups: int = 1, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, s32 accumulators) of ``conv2d_w8a8``: the kernel's own
    accumulators on the card, the plain version's on the CPU."""
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        acc = int8_conv_acc_plain(quantize_activations(x, act_scale), weight,
                                  stride, padding, dilation, groups)
        return rescale_plain(acc, act_scale, w_scale, bias, dtype), acc
    return _launch(x, weight, act_scale, w_scale, bias, stride, padding,
                   dilation, groups, dtype, with_acc=True)


def reset_launch_counts() -> None:
    conv2d_w8a8.launches = 0
