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
With ``act="hard_swish"`` the output then goes through
``ops/cuda/hard_swish.py::hard_swish_plain`` in ``dtype``, which the kernel
computes in its epilogue with the same ops and roundings.

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
stride 1 or 2, padding (k-1)//2, C with C * x.element_size() a multiple
of 16 (its input arrives by TMA), and C a multiple of 16 or at most 32.
Launches are counted in ``conv2d_w8a8.launches``; ``int8_conv_acc`` is the
debug entry that also returns the s32 accumulators, and counts its
launches there too.

The tile plan (``tile_plan``) is decided here and handed to the kernel: a
block owns a patch of 8, 16 or 32 x TILE_W output pixels of one image and a
slice of at most MAX_N output channels, and quantizes the input halo of its
patch once for each CHUNK of input channels. ``quantized_elements`` counts
what that costs for a conv.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .hard_swish import hard_swish_plain

_SOURCE = "int8_conv"
_DTYPES = (torch.float32, torch.bfloat16)
_ACTS = (None, "hard_swish")

# The kernel's tiling; csrc/int8_conv.cu has the same constants and rules.
TILE_W = 8   # output columns of a block
CHUNK = 32   # input channels quantized and multiplied at a time
MAX_N = 256  # output channels of a block


class TilePlan(NamedTuple):
    n: int         # output channels of a block (a multiple of 32)
    mb: int        # 8-row blocks of output pixels of a block (wgmma M tiles)
    split: int     # 1: the two warpgroups split the M tiles, 0: the n columns
    slices: int    # blocks over the output channels: ceil(O / n)
    tiles: int     # blocks over the output pixels: B * ceil(Ho/(8*mb)) * ceil(Wo/TILE_W)
    chunks: int    # ceil(C / CHUNK)
    patch: int     # input pixels of a block's halo patch, (8*mb-1)*s+k by (TILE_W-1)*s+k


def tile_plan(x_shape, w_shape, stride: int) -> TilePlan:
    """The kernel's tiling of a conv of an input of shape (B, C, H, W) with a
    (O, C, k, k) weight. The output channels are split into as few slices
    of at most MAX_N as will do (each slice quantizes the input again),
    each a multiple of 32 wide. A slice of at most 96 is one block's n,
    which each of its two warpgroups computes whole on half of its M tiles
    (8 x 8 output pixels each); a wider one is rounded up to n = 128, 192
    or 256, which the two split, sharing the M tiles. mb, the block's M
    tiles, is as many as the accumulators leave room for (a thread holds
    48, or 64 for n = 128 and 256); stride 2 halves it (its halo patch is
    twice as tall), and so does an mb that would pad Ho by more than a
    quarter."""
    b, c, h, w = x_shape
    o, _, k, _ = w_shape
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    n = -(-o // (-(-o // MAX_N) * 32)) * 32
    if n <= 96:
        split, low = 1, 2
        mb = max(low, 2 * {1: 2, 2: 1, 3: 1}[n // 32] // stride)
    else:
        split, low = 0, 1
        n = min(width for width in (128, 192, 256) if width >= n)
        mb = max(low, {128: 2, 192: 1, 256: 1}[n] // stride)
    while mb > low and -(-ho // (8 * mb)) * 8 * mb > 1.25 * ho:
        mb //= 2
    tiles = b * -(-ho // (8 * mb)) * -(-wo // TILE_W)
    patch = ((8 * mb - 1) * stride + k) * ((TILE_W - 1) * stride + k)
    return TilePlan(n, mb, split, -(-o // n), tiles, -(-c // CHUNK), patch)


def quantized_elements(x_shape, w_shape, stride: int) -> int:
    """Activation elements the kernel quantizes for this conv: every block
    quantizes its halo patch once for each chunk of CHUNK channels, the
    zero fill outside the image and past C included."""
    p = tile_plan(x_shape, w_shape, stride)
    return p.tiles * p.slices * p.chunks * p.patch * CHUNK


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


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act not in _ACTS:
        raise ValueError(f"the int8 conv applies no activation or hard_swish, not {act!r}")
    if act is None:
        return y
    return hard_swish_plain(y)


def conv2d_w8a8_plain(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: int = 1, padding: int = 0, dilation: int = 1,
                      groups: int = 1, dtype: Optional[torch.dtype] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of ``conv2d_w8a8``, for any conv."""
    acc = int8_conv_acc_plain(quantize_activations(x, act_scale), weight,
                              stride, padding, dilation, groups)
    return apply_act(rescale_plain(acc, act_scale, w_scale, bias, dtype or x.dtype), act)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of ``cocodet_int8_conv`` on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_int8_conv.argtypes = [p, i, p, p, i, p, p, p, i, p,
                                      i, i, i, i, i, i, i, i, i, i, i, i, i, p]
    lib.cocodet_int8_conv.restype = i
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load(_SOURCE))


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
            with_acc: bool, act: Optional[str] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
    if act not in _ACTS:
        raise ValueError(f"the int8 conv kernel applies no activation or hard_swish, not {act!r}")
    if c * x.element_size() % 16 or (c % 16 and c > CHUNK):
        raise ValueError(f"the int8 conv kernel reads x by TMA (C * {x.element_size()} bytes a "
                         f"multiple of 16) and takes C a multiple of 16 or at most {CHUNK}; "
                         f"got C={c}")
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on cuda, not {x.device}")
    dev = x.device
    _check("x", x, dev, _DTYPES, channels_last=True, align=16)
    _check("weight", weight, dev, (torch.int8,), (o, c, kh, kw), channels_last=True,
           align=16 if c % 16 == 0 else 4)
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
    plan = tile_plan(x.shape, weight.shape, stride)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_int8_conv(
            x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(),
            act_scale.data_ptr(), int(act_scale.dim() == 1), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            int(dtype == torch.bfloat16), None if acc is None else acc.data_ptr(),
            b, h, w, c, o, kh, stride, ho, wo, plan.n, plan.mb, plan.split,
            int(act == "hard_swish"), stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: error {rc}")
    conv2d_w8a8.launches += 1
    return y, acc


def conv2d_w8a8(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding: int = 0, dilation: int = 1,
                groups: int = 1, dtype: Optional[torch.dtype] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """The w8a8 conv of ``x`` in ``dtype`` (default: ``x.dtype``), then
    ``act`` (None or "hard_swish"); layouts and numerics in the module
    docstring."""
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        return conv2d_w8a8_plain(x, weight, act_scale, w_scale, bias, stride,
                                 padding, dilation, groups, dtype, act)
    return _launch(x, weight, act_scale, w_scale, bias, stride, padding,
                   dilation, groups, dtype, with_acc=False, act=act)[0]


conv2d_w8a8.launches = 0


def int8_conv_acc(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                  w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int = 1, padding: int = 0, dilation: int = 1,
                  groups: int = 1, dtype: Optional[torch.dtype] = None,
                  act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, s32 accumulators) of ``conv2d_w8a8``: the kernel's own
    accumulators on the card, the plain version's on the CPU."""
    dtype = dtype or x.dtype
    if x.device.type == "cpu":
        acc = int8_conv_acc_plain(quantize_activations(x, act_scale), weight,
                                  stride, padding, dilation, groups)
        return apply_act(rescale_plain(acc, act_scale, w_scale, bias, dtype), act), acc
    return _launch(x, weight, act_scale, w_scale, bias, stride, padding,
                   dilation, groups, dtype, with_acc=True, act=act)


def reset_launch_counts() -> None:
    conv2d_w8a8.launches = 0
