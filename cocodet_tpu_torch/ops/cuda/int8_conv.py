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
OHWI), or a slice of such a tensor along C (a split-concat part's);
the output is (B, O, Ho, Wo) in channels-last memory, in ``dtype``.

``conv2d_w8a8_plain`` is the plain version: the conv of the quantized
values in float64, which is exact (the longest reduction of the slim
YOLOX-M-P6, K = 3*3*576 = 5184, sums to at most 5184 * 127^2 < 2^27, far
below 2^53), converted to s32, then the same epilogue. It takes any conv.

``conv2d_w8a8`` takes the plain version for tensors on the CPU, and only
there. For CUDA tensors it launches the kernel or raises; it never falls
back. The kernel takes groups=1, dilation=1, a square kernel of 1, 3 or 6,
stride 1 or 2, a padding in H and one in W below k (``padding`` an int or
``(pad_h, pad_w)``: a height slab that carries its halo rows is convolved
with ``(0, pad)``), and C with C * x.element_size() a multiple of 16 (its
input arrives by TMA) and C a multiple of 16 or at most 32, or C below 16
with W * C * x.element_size() a multiple of 16 (the 6x6 stem's 3
channels: each patch row arrives packed, no padded copy).

``conv2d_w8a8_parts`` is the split-concat conv (blocks.py:258-276): the
conv of the channel concat of parts, each a map or ``(map, up2x)``, the
``up2x`` ones upsampled 2x (nearest), without the concat. Each part is
quantized with its slice of ``act_scale`` and convolved with its slice of
the kernel into s32 (an ``up2x`` part, into a 1x1 stride-1 conv, at its
own resolution); the s32 sums add up and one epilogue follows. On the card
that is one launch a part: the ``up2x`` parts first, then the others, each
adding the s32 sums of the launches before it (read at ``(h >> 1, w >> 1)``
after the ``up2x`` ones), every launch but the last writing its s32 sums,
the last the output. Integer sums are exact, so the result is bit for bit
the concat graph's.

Launches are counted in ``conv2d_w8a8.launches`` (a parts conv counts one
a part); ``int8_conv_acc`` and ``int8_conv_parts_acc`` are the debug entries
that also return the s32 accumulators, and count their launches there too.

The tile plan (``tile_plan``) is decided here and handed to the kernel: a
block owns a patch of 8, 16 or 32 x TILE_W output pixels of one image and a
slice of at most MAX_N output channels, and quantizes the input halo of its
patch once for each CHUNK of input channels. ``quantized_elements`` counts
what that costs for a conv.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

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


def pads(padding) -> Tuple[int, int]:
    """(pad_h, pad_w) of an int or pair ``padding``."""
    if isinstance(padding, (tuple, list)):
        return int(padding[0]), int(padding[1])
    return int(padding), int(padding)


def tile_plan(x_shape, w_shape, stride: int, padding=None) -> TilePlan:
    """The kernel's tiling of a conv of an input of shape (B, C, H, W) with a
    (O, C, k, k) weight (``padding`` an int or (pad_h, pad_w), by default
    (k-1)//2). The output channels are split into as few slices
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
    pad_h, pad_w = pads((k - 1) // 2 if padding is None else padding)
    ho = (h + 2 * pad_h - k) // stride + 1
    wo = (w + 2 * pad_w - k) // stride + 1
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


def quantized_elements(x_shape, w_shape, stride: int, padding=None) -> int:
    """Activation elements the kernel quantizes for this conv: every block
    quantizes its halo patch once for each chunk of CHUNK channels, the
    zero fill outside the image and past C included."""
    p = tile_plan(x_shape, w_shape, stride, padding)
    return p.tiles * p.slices * p.chunks * p.patch * CHUNK


def _bcast(scale: torch.Tensor) -> torch.Tensor:
    """A (C,) per-channel scale as (1, C, 1, 1); a scalar as it is."""
    return scale.view(1, -1, 1, 1) if scale.dim() else scale


def quantize_activations(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """clip(round_half_even(x.float() / act_scale), -127, 127): the int8
    values, held in f32 (blocks.py:278-279)."""
    return torch.clamp(torch.round(x.float() / _bcast(act_scale)), -127, 127)


def int8_conv_acc_plain(xq: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                        padding=0, dilation: int = 1,
                        groups: int = 1) -> torch.Tensor:
    """The s32 accumulators of the conv of the quantized values, computed
    in float64 (exact below 2^53)."""
    acc = F.conv2d(xq.double(), weight.double(), None, stride, pads(padding),
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
                      stride: int = 1, padding=0, dilation: int = 1,
                      groups: int = 1, dtype: Optional[torch.dtype] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of ``conv2d_w8a8``, for any conv."""
    acc = int8_conv_acc_plain(quantize_activations(x, act_scale), weight,
                              stride, padding, dilation, groups)
    return apply_act(rescale_plain(acc, act_scale, w_scale, bias, dtype or x.dtype), act)


def _up2x(t: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of a (B, C, H, W) tensor of any dtype."""
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def split_parts(parts, weight: torch.Tensor, act_scale: torch.Tensor
                ) -> List[Tuple[torch.Tensor, bool, torch.Tensor, torch.Tensor]]:
    """(map, up2x, kernel slice, act_scale slice) of each part, in the
    parts' order; raises JAX's errors where the parts do not fit the
    kernel."""
    out, off = [], 0
    for part in parts:
        x, up = part if isinstance(part, tuple) else (part, False)
        c = x.shape[1]
        a = act_scale[off:off + c] if act_scale.dim() else act_scale
        out.append((x, bool(up), weight[:, off:off + c], a))
        off += c
    if off != weight.shape[1]:
        raise ValueError(f"split-concat parts of {off} channels into a conv of "
                         f"{weight.shape[1]}")
    if any(up for _, up, _, _ in out) and not (weight.shape[2] == 1 and weight.shape[3] == 1):
        raise ValueError("up2x parts need a 1x1 stride-1 conv (pointwise commute)")
    return out


def int8_conv_parts_acc_plain(parts, weight: torch.Tensor, act_scale: torch.Tensor,
                              stride: int = 1, padding=0) -> torch.Tensor:
    """The s32 sum over the parts of each part's conv with its kernel slice
    (an up2x part's upsampled), in float64 convs (exact)."""
    acc = None
    for x, up, w, a in split_parts(parts, weight, act_scale):
        yp = int8_conv_acc_plain(quantize_activations(x, a), w, stride, padding)
        yp = _up2x(yp) if up else yp
        acc = yp if acc is None else acc + yp
    return acc


def conv2d_w8a8_parts_plain(parts, weight: torch.Tensor, act_scale: torch.Tensor,
                            w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                            stride: int = 1, padding=0, dtype: Optional[torch.dtype] = None,
                            act: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of ``conv2d_w8a8_parts``."""
    first = parts[0][0] if isinstance(parts[0], tuple) else parts[0]
    acc = int8_conv_parts_acc_plain(parts, weight, act_scale, stride, padding)
    return apply_act(rescale_plain(acc, act_scale, w_scale, bias, dtype or first.dtype), act)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of ``cocodet_int8_conv`` on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_int8_conv.argtypes = [p, i, p, i, p, i, p, p, p, i, p, p, i, i,
                                      i, i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
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


def _weight_ld(weight: torch.Tensor, device) -> int:
    """The channels between a tap's rows of an OHWI int8 ``weight``
    (channels-last (O, C, k, k), or its slice along C): C, or the whole
    kernel's for a slice. Raises where the layout is another."""
    o, c, k, _ = weight.shape
    if weight.device != device or weight.dtype != torch.int8:
        raise ValueError(f"weight must be int8 on {device}, got {weight.dtype} on "
                         f"{weight.device}")
    ld = weight.stride(0) // (k * k)
    if ((c > 1 and weight.stride(1) != 1) or weight.stride(0) != k * k * ld or ld < c
            or (k > 1 and (weight.stride(2) != k * ld or weight.stride(3) != ld))):
        raise ValueError(f"weight must be OHWI (channels-last OIHW) or its slice along C, "
                         f"got strides {weight.stride()}")
    if c % 16 == 0 and (ld % 16 or weight.data_ptr() % 16):
        raise ValueError(f"the int8 conv kernel reads a weight of {c} channels by TMA: its "
                         f"taps {ld} channels apart and its address must be 16-byte "
                         f"multiples (a part's channel offset a multiple of 16)")
    return ld


def _launch(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
            w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            padding, dilation: int, groups: int, dtype: torch.dtype,
            with_acc: bool, act: Optional[str] = None,
            acc_in: Optional[torch.Tensor] = None, up: bool = False,
            partial: bool = False) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch: y (None with ``partial``) and, with ``with_acc`` or
    ``partial``, the s32 sums, ``acc_in`` (at half the resolution with
    ``up``) added."""
    o, c_g, kh, kw = weight.shape
    b, c, h, w = x.shape
    pad_h, pad_w = pads(padding)
    if not (groups == 1 and dilation == 1 and kh == kw and kh in (1, 3, 6)
            and stride in (1, 2) and 0 <= pad_h < kh and 0 <= pad_w < kh and c_g == c):
        raise ValueError(
            f"the int8 conv kernel takes groups=1, dilation=1, a 1x1 or 3x3 (or 6x6) kernel, "
            f"stride 1 or 2 and paddings below k; got groups={groups}, dilation="
            f"{dilation}, kernel {kh}x{kw} of {c_g} channels, stride {stride}, padding "
            f"{padding}")
    if dtype not in _DTYPES:
        raise TypeError(f"the int8 conv kernel writes f32 or bf16, not {dtype}")
    if act not in _ACTS:
        raise ValueError(f"the int8 conv kernel applies no activation or hard_swish, not {act!r}")
    es = x.element_size()
    packed = c * es % 16 != 0
    if (c % 16 and c > CHUNK) or (packed and (c >= 16 or w * c * es % 16)):
        raise ValueError(f"the int8 conv kernel reads x by TMA: C * {es} bytes a multiple of "
                         f"16 with C a multiple of 16 or at most {CHUNK}, or C below 16 with "
                         f"W * C * {es} bytes a multiple of 16; got C={c}, W={w}")
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on cuda, not {x.device}")
    dev = x.device
    _check("x", x, dev, _DTYPES, channels_last=True, align=16)
    w_ld = _weight_ld(weight, dev)
    _check("act_scale", act_scale, dev, (torch.float32,),
           (c,) if act_scale.dim() else ())
    _check("w_scale", w_scale, dev, (torch.float32,), (o,))
    if bias is not None:
        _check("bias", bias, dev, (dtype,), (o,))
    ho = (h + 2 * pad_h - kh) // stride + 1
    wo = (w + 2 * pad_w - kw) // stride + 1
    if acc_in is not None:
        shape = (b, o, ho >> up, wo >> up)
        _check("acc_in", acc_in, dev, (torch.int32,), shape, channels_last=True)
        if up and (ho % 2 or wo % 2):
            raise ValueError(f"an up2x part's sums upsample to an even map, not {ho}x{wo}")
    y = None if partial else torch.empty((b, o, ho, wo), dtype=dtype, device=dev,
                                         memory_format=torch.channels_last)
    acc = (torch.empty((b, o, ho, wo), dtype=torch.int32, device=dev,
                       memory_format=torch.channels_last) if with_acc or partial else None)
    if b * o * ho * wo == 0:
        return y, acc
    plan = tile_plan(x.shape, weight.shape, stride, (pad_h, pad_w))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_int8_conv(
            x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(), w_ld,
            act_scale.data_ptr(), int(act_scale.dim() == 1), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), None if y is None else y.data_ptr(),
            int(dtype == torch.bfloat16), None if acc is None else acc.data_ptr(),
            None if acc_in is None else acc_in.data_ptr(), int(up), int(partial),
            b, h, w, c, o, kh, stride, pad_h, pad_w, ho, wo, plan.n, plan.mb, plan.split,
            int(act == "hard_swish"), stream)
    if rc != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: error {rc}")
    conv2d_w8a8.launches += 1
    return y, acc


def conv2d_w8a8(x: torch.Tensor, weight: torch.Tensor, act_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding=0, dilation: int = 1,
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
                  stride: int = 1, padding=0, dilation: int = 1,
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


def _parts_launches(parts, weight, act_scale, w_scale, bias, stride, padding, dtype, act,
                    with_acc):
    """The launches of a parts conv on the card (module docstring)."""
    split = split_parts(parts, weight, act_scale)
    ups = [p for p in split if p[1]]
    order = ups + [p for p in split if not p[1]]
    acc, up, y = None, False, None
    for i, (x, is_up, w, a) in enumerate(order):
        last = i == len(order) - 1
        # after the up2x parts, the first full-resolution part reads their sums upsampled
        read_up = up and not is_up
        y, out = _launch(x, w, a, w_scale, bias, stride, padding, 1, 1, dtype,
                         with_acc=with_acc and last, act=act, acc_in=acc, up=read_up,
                         partial=not last)
        acc, up = out, is_up
    if order[-1][1]:  # every part up2x: the epilogue ran at their resolution
        y = _up2x(y)
        acc = None if acc is None else _up2x(acc)
    return y, acc


def conv2d_w8a8_parts(parts, weight: torch.Tensor, act_scale: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: int = 1,
                      padding=0, dtype: Optional[torch.dtype] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The w8a8 conv of the channel concat of ``parts`` (each a map or
    ``(map, up2x)``) in ``dtype``, then ``act``; module docstring."""
    first = parts[0][0] if isinstance(parts[0], tuple) else parts[0]
    dtype = dtype or first.dtype
    if first.device.type == "cpu":
        return conv2d_w8a8_parts_plain(parts, weight, act_scale, w_scale, bias, stride,
                                       padding, dtype, act)
    return _parts_launches(parts, weight, act_scale, w_scale, bias, stride, padding, dtype,
                           act, with_acc=False)[0]


def int8_conv_parts_acc(parts, weight: torch.Tensor, act_scale: torch.Tensor,
                        w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: int = 1,
                        padding=0, dtype: Optional[torch.dtype] = None,
                        act: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, s32 sums over the parts) of ``conv2d_w8a8_parts``: the last
    launch's sums on the card, the plain version's on the CPU."""
    first = parts[0][0] if isinstance(parts[0], tuple) else parts[0]
    dtype = dtype or first.dtype
    if first.device.type == "cpu":
        acc = int8_conv_parts_acc_plain(parts, weight, act_scale, stride, padding)
        return apply_act(rescale_plain(acc, act_scale, w_scale, bias, dtype), act), acc
    return _parts_launches(parts, weight, act_scale, w_scale, bias, stride, padding, dtype,
                           act, with_acc=True)


def reset_launch_counts() -> None:
    conv2d_w8a8.launches = 0
