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

``weight_mask`` (SynFlow's unstructured pruning) gives every conv of a block
an elementwise ``conv_mask`` buffer multiplied into its kernel at each use;
it is threaded where JAX threads it (blocks.py:353-760, darknet.py:107-174,
pafpn.py:77-130, yolox.py:71-108): the backbone and the PAFPN's CSP layers,
not the PAFPN's lateral and down convs, not the head.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import bn_act as bnk
from ..ops.cuda import fake_quant as fq
from ..ops.cuda import hard_swish as hs
from ..ops.cuda.int8_conv import conv2d_w8a8
from ..parallel.collectives import all_reduce_, halo_exchange
from ..parallel.mesh import active_mesh, space_sizes


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------


HARD_SWISH_NAMES = ("hsilu", "hswish", "hard_silu", "hard_swish")


class _HardSwish(torch.autograd.Function):
    """``jax.nn.hard_swish`` and its VJP through ``ops/cuda/hard_swish.py``:
    the CUDA kernel on the card, the plain versions on the CPU. Saves ``x``
    only; the backward recomputes relu6's mask from it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return hs.hard_swish(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return hs.hard_swish_grad(x, g)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish`` (``x * relu6(x + 3.) / 6.``) with the roundings
    of XLA:CPU under jax 0.9.0, differentiable with JAX's VJP: relu6's
    gradient is 0 at both bounds, so d/dx is 0 at x = -3 and 1 at x = 3
    (autograd through ``clamp`` would give -0.5 and 1.5). The arithmetic is
    in ``ops/cuda/hard_swish.py``."""
    return _HardSwish.apply(x)


def get_activation(name: str = "silu") -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (cocodet_tpu/models/blocks.py:48-63)."""
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name in HARD_SWISH_NAMES:
        return hard_swish
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
# fake-quant (quantization-aware training)
# --------------------------------------------------------------------------


class _FakeQuant(torch.autograd.Function):
    """``fake_quant`` and its VJP through ``ops/cuda/fake_quant.py``: the
    CUDA kernel on the card, the plain versions on the CPU. Saves its input
    and the bound (and divisor); the backward recomputes the clip. No
    gradient reaches the scale, bound or divisor (JAX stops it, or they are
    frozen buffers)."""

    @staticmethod
    def forward(ctx, v, scale, bound, axis, div):
        ctx.save_for_backward(v, bound, div)
        ctx.axis = axis
        return fq.fake_quant(v, scale, bound, axis, div)

    @staticmethod
    def backward(ctx, g):
        v, bound, div = ctx.saved_tensors
        return fq.fake_quant_grad(v, g, bound, ctx.axis, div), None, None, None, None


def fake_quant(v: torch.Tensor, scale: torch.Tensor, bound: torch.Tensor, axis: int = 1,
               div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cocodet_tpu/models/blocks.py::fake_quant (:140-153): ``v`` snapped
    onto the int8 grid ``scale * [-127, 127]`` with the clipped
    straight-through gradient, then divided by ``div`` (one value per index
    of dim 1), differentiable. The scale and bound are 0-d or one per index
    along ``axis``; the arithmetic and JAX's roundings are in
    ``ops/cuda/fake_quant.py``."""
    return _FakeQuant.apply(v, scale, bound, axis, div)


@contextlib.contextmanager
def no_tf32():
    """cuDNN's convolutions in full f32 (no TF32) inside the block, the
    other cuDNN flags as they were."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


# --------------------------------------------------------------------------
# Conv2d / ConvBnAct
# --------------------------------------------------------------------------


class Conv2d(nn.Module):
    """Plain conv with symmetric padding ``((k-1)*dilation)//2``
    (cocodet_tpu/models/blocks.py:156-344). ``weight`` is OIHW (the flax
    kernel is HWIO).

    ``forward(x, dtype=None, act=None)`` computes in ``dtype``, by default
    the dtype of ``x``; the float path casts ``x`` and the weights to it
    (:339-340). ``act="hard_swish"`` (w8a8 only) applies ``hard_swish`` to
    the output in the int8 conv's epilogue.

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
      is ``ops/cuda/int8_conv.py::conv2d_w8a8`` (:248-283);
    - ``"qat"``: quantization-aware training (:284-319): the f32 input
      fake-quantized on the frozen ``act_scale`` buffer (scalar or (cin,)),
      the float kernel fake-quantized per out channel on a scale taken from
      it with no gradient, the conv in f32 through cuDNN with TF32 off. A
      (cin,) act_scale is folded into the kernel first and divided out after
      its fake-quant, the grid the deployed w8a8 conv computes on. A
      split-concat input raises, as in JAX (:285-287).

    ``weight_mask`` adds the f32 ``conv_mask`` buffer (OIHW, the optimizer
    never sees it), multiplied into the kernel at every use before any cast
    (:219-223).

    Split-concat (:192-214, 325-336): ``x`` may be a sequence of parts, each
    a map or ``(map, up2x)``, standing for the channel concat of the parts,
    those with ``up2x`` upsampled 2x (nearest). The float conv then runs one
    conv a kernel slice in the output dtype, upsamples the result of an
    ``up2x`` part (a 1x1 stride-1 conv commutes with it), sums the parts in
    the output dtype and adds the bias: one rounding more than the concat,
    as in JAX (not bit for bit in bf16). A grouped conv, or an ``up2x`` part
    into a conv that is not 1x1 stride 1, raises JAX's ``ValueError``; a
    ``"calib"`` conv concatenates the parts' absmax; a ``"w8a8"`` conv
    raises (its int8 kernel takes one map: ROADMAP Queue 1 item 3).
    """

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 use_bias: bool = False, quant: Optional[str] = None,
                 weight_mask: bool = False):
        super().__init__()
        if quant not in (None, "calib", "w8a8", "qat"):
            raise ValueError(f"unsupported quant mode {quant!r}")
        if weight_mask and quant == "w8a8":
            raise ValueError("a w8a8 conv's kernel is int8: it takes no weight mask")
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
        if quant == "qat":
            self.register_buffer("act_scale", torch.empty(()))
        self.register_buffer("conv_mask", torch.ones(shape) if weight_mask else None)
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        """The float kernel as the conv uses it: ``weight``, times
        ``conv_mask`` where there is one."""
        if self.conv_mask is None:
            return self.weight
        return self.weight * self.conv_mask.to(self.weight.dtype)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                act: Optional[str] = None) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            return self._forward_parts(x, dtype, act)
        dtype = dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dtype)
        mesh = active_mesh()
        if self.quant == "w8a8":
            if mesh is not None and mesh.space is not None:
                raise NotImplementedError(
                    "a height-sharded w8a8 conv is not ported: the int8 conv kernel takes "
                    "whole maps (ROADMAP Queue 1 item 3)")
            return conv2d_w8a8(x, self.weight, self.act_scale, self.w_scale, b,
                               self.stride, self.padding, self.dilation,
                               self.groups, dtype, act)
        if act is not None:
            raise ValueError("only a w8a8 conv applies an activation itself")
        if self.quant == "qat":
            return self._forward_qat(x, dtype)
        if self.quant == "calib":
            absmax = x.detach().float().abs().amax(dim=(0, 2, 3))
            torch.maximum(self.act_absmax, absmax, out=self.act_absmax)
        if mesh is not None and mesh.space is not None:
            return self._forward_sharded(x.to(dtype), b, mesh)
        return F.conv2d(x.to(dtype), self.kernel().to(dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)

    def _forward_parts(self, x, dtype: Optional[torch.dtype],
                       act: Optional[str]) -> torch.Tensor:
        """The conv of the channel concat of ``x``'s parts, one conv a
        kernel slice (blocks.py:192-214, 325-336)."""
        if self.quant == "qat":
            raise ValueError("split-concat is a deployment-graph mode (incompatible with "
                             "quant='qat')")
        parts = [p if isinstance(p, tuple) else (p, False) for p in x]
        if self.groups != 1:
            raise ValueError("split-concat conv: groups must be 1")
        k = self.weight.shape[2]
        if any(up for _, up in parts) and not (k == 1 and self.stride == 1
                                               and self.dilation == 1):
            raise ValueError("up2x parts need a 1x1 stride-1 conv (pointwise commute)")
        if self.quant == "w8a8":
            raise NotImplementedError(
                "a split-concat w8a8 conv is not ported: the int8 conv kernel takes one map, "
                "not s32 partial sums of parts (ROADMAP Queue 1 item 3)")
        if act is not None:
            raise ValueError("only a w8a8 conv applies an activation itself")
        dtype = dtype or parts[0][0].dtype
        if self.quant == "calib":
            absmax = torch.cat([p.detach().float().abs().amax(dim=(0, 2, 3)) for p, _ in parts])
            torch.maximum(self.act_absmax, absmax, out=self.act_absmax)
        mesh = active_mesh()
        sharded = mesh is not None and mesh.space is not None
        kernel = self.kernel().to(dtype)
        y, off = None, 0
        for p, up in parts:
            c = p.shape[1]
            w = kernel[:, off:off + c]
            yp = (self._forward_sharded(p.to(dtype), None, mesh, w) if sharded else
                  F.conv2d(p.to(dtype), w, None, self.stride, self.padding, self.dilation))
            yp = upsample2x(yp) if up else yp
            y = yp if y is None else y + yp
            off += c
        if off != kernel.shape[1]:
            raise ValueError(f"split-concat parts of {off} channels into a conv of "
                             f"{kernel.shape[1]}")
        return y if self.bias is None else y + self.bias.to(dtype).view(1, -1, 1, 1)

    def _forward_qat(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """conv(fake_quant(x, a), fake_quant(kf, w_scale) [/ a]) + bias in
        f32, cast to ``dtype`` (blocks.py:284-319)."""
        a = self.act_scale
        kf = self.kernel().float()
        if a.dim():
            if self.groups != 1:
                raise ValueError("a per-channel act_scale does not fold into a grouped "
                                 "conv's kernel (JAX's fold fails there too)")
            kf = kf * a.view(1, -1, 1, 1)
            w = fake_quant(kf, *fq.weight_scale_bound(kf), axis=0, div=a)
        else:
            w = fake_quant(kf, *fq.weight_scale_bound(kf), axis=0)
        xq = fake_quant(x.float(), a, fq.act_bound(a), axis=1)
        b = None if self.bias is None else self.bias.float()
        with no_tf32():
            y = F.conv2d(xq, w, None, self.stride, self.padding, self.dilation, self.groups)
        y = y.to(dtype)
        return y if b is None else y + b.to(dtype).view(1, -1, 1, 1)

    def _forward_sharded(self, x: torch.Tensor, b: Optional[torch.Tensor],
                         mesh, kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv of a height-sharded map: this rank's rows with halos
        from its space neighbours (zeros past the map's edge, the conv's own
        padding), convolved with no padding in H. Output row o reads input
        rows o*stride - pad .. o*stride - pad + reach, so a rank whose first
        output row is its first input row / stride needs ``pad`` rows from
        above and ``reach - pad - (stride - 1)`` from below."""
        if self.quant is not None:
            raise NotImplementedError(f"a height-sharded {self.quant} conv is not ported: "
                                      "a height-sharded conv is a float conv "
                                      "(ROADMAP Queue 1 item 3)")
        h = x.shape[2]
        if h % self.stride:
            raise ValueError(f"a height-sharded conv of stride {self.stride} needs a local "
                             f"height it divides, got {h}")
        reach = self.dilation * (self.weight.shape[2] - 1)
        x = halo_exchange(x, self.padding, max(0, reach - self.padding - self.stride + 1),
                          mesh.space, sizes=space_sizes(h))
        kernel = self.kernel() if kernel is None else kernel
        return F.conv2d(x, kernel.to(x.dtype), b, self.stride, (0, self.padding),
                        self.dilation, self.groups)


class ChannelMask(nn.Module):
    """The structured-pruning gate of cocodet_tpu/models/blocks.py:110-130:
    ``y = x * scale + offset * (1 - scale)``, ``scale`` 0 or 1 per channel.
    ``scale`` and ``offset`` are f32 buffers (flax's ``masks`` collection),
    so the optimizer never sees them; the Pruner writes them
    (core/pruner.py). After a train-mode or eval-mode BN the gate is folded
    into the BN's per-channel vectors (``fold``); ``forward`` applies it
    explicitly, in the map's dtype, after a fused conv."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("offset", torch.zeros(features))

    def fold(self, weight: torch.Tensor, bias: torch.Tensor):
        """BN vectors with the gate folded in: ``weight * s`` and ``bias * s
        + offset * (1 - s)``. A BN output ``z = u * weight + bias`` gated is
        ``z * s + o * (1 - s)``; with s in {0, 1} that is exactly the BN
        output of these vectors (u * 0 + o = o, and u * w + b at s = 1). As
        torch ops before the BN, autograd carries the factor s to the
        weight's and bias's gradients."""
        s = self.scale.to(weight.dtype)
        return weight * s, bias * s + self.offset.to(bias.dtype) * (1.0 - s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale.to(x.dtype).view(1, -1, 1, 1)
        return x * s + self.offset.to(x.dtype).view(1, -1, 1, 1) * (1.0 - s)


class _BatchNormAct(torch.autograd.Function):
    """Train-mode BN and the activation after it through
    ``ops/cuda/bn_act.py``: on the card one launch each way (the resident
    kernel) where the map's channel tile fits a cluster's shared memory,
    else two passes (a per-channel reduce, then an apply); the plain stages
    on the CPU. Saves the map ``x`` in its own dtype, the per-channel
    vectors and the sums' count, no copy of the map in f32.

    On a ``mesh`` of more than one rank the statistics are the global
    batch's: the two passes, with ``[sum x, sum x^2, count]`` summed over
    the world between them forward, and ``[sum gz, sum gz (x - mean)]``
    backward, one all-reduce each way. The scale and bias gradients stay
    this rank's (the step sums every gradient over ranks itself)."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, act, mesh):
        args = (weight, bn.running_mean, bn.running_var, bn.eps, bn.momentum)
        if mesh is None:
            y, sums, fvec = bnk.forward(x, weight, bias, *args[1:], act)
        else:
            sums, _ = bnk.reduce(x, finish=False)
            all_reduce_(sums, mesh.world)
            fvec = bnk.finish(sums, *args)
            y = bnk.apply(x, fvec, bias, act)
        ctx.save_for_backward(x, weight, bias, fvec, sums)
        ctx.act, ctx.mesh = act, mesh
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, fvec, sums = ctx.saved_tensors
        count = sums[-1:]
        if ctx.mesh is None:
            dx, _, bvec = bnk.backward(x, g, fvec, bias, weight, count, ctx.act)
        else:
            local, _ = bnk.grad_reduce(x, g, fvec, bias, weight, count, ctx.act, finish=False)
            total = all_reduce_(local.clone(), ctx.mesh.world)
            bvec = bnk.grad_finish(total, local, fvec, weight, count)
            dx = bnk.grad_apply(x, g, fvec, bias, bvec, ctx.act)
        return dx, bvec[2], bvec[3], None, None, None


class BatchNorm(nn.BatchNorm2d):
    """BN with the JAX package's constants: eps 1e-3 and the torch
    convention momentum 0.03, flax momentum 0.97 (blocks.py:371-372). It
    normalises in f32 (f64 for an f64 input) and casts back to the input
    dtype, as flax's BatchNorm with ``dtype`` does. ``forward(x,
    act="identity")`` applies ``act`` ("identity" or "hard_swish") to the
    result.

    Train mode is flax's (flax/linen/normalization.py, ``_compute_stats``
    and ``_normalize``) with the activation fused in (``_BatchNormAct``):
    the batch statistics in f32 (f64 for an f64 input) over N, H and W,
    ``mean = E[x]`` and the biased ``var = max(0, E[x^2] - mean^2)``; ``y =
    act(T((x - mean) * (rsqrt(var + eps) * scale) + bias))``; the running
    statistics updated in place with the biased variance, ``ra = 0.97 ra +
    (1 - 0.97) stat`` (``nn.BatchNorm2d`` would take the unbiased one).

    ``mask``, a ``ChannelMask``, gates the BN output before the activation
    (blocks.py:401-415), folded into the BN's vectors in both modes and, in
    the data-parallel path, before the finish stage too."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor, act: str = "identity",
                mask: Optional["ChannelMask"] = None) -> torch.Tensor:
        weight, bias = (self.weight, self.bias) if mask is None else \
            mask.fold(self.weight, self.bias)
        if not self.training:
            acc = torch.promote_types(x.dtype, torch.float32)  # f64 stays f64
            y = F.batch_norm(x.to(acc), self.running_mean, self.running_var,
                             weight, bias, False, 0.0, self.eps).to(x.dtype)
            return hard_swish(y) if act == "hard_swish" else y
        mesh = active_mesh()
        if mesh is not None and mesh.size <= 1:
            mesh = None
        return _BatchNormAct.apply(x, weight, bias, self, act, mesh)


class ConvBnAct(nn.Module):
    """Conv -> BN -> activation (blocks.py:347-415). ``fused=True`` is the
    inference topology: the conv carries a bias and there is no BN. ``quant``
    applies to the fused topology only, as in JAX (:397-398). Hard-swish
    after a BN runs in the BN's own passes, and after a w8a8 conv in the
    conv's epilogue (the same numbers, no extra pass). ``use_mask`` adds the
    ``ChannelMask`` ``mask`` between BN and the activation (:412-413),
    folded into the BN (``BatchNorm.forward``). ``weight_mask`` gives the
    conv its ``conv_mask``; the activation after a ``"qat"`` conv is the
    standalone hard-swish, forward and backward."""

    def __init__(self, cin: int, features: int, kernel_size: int = 1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: str = "silu", fused: bool = False,
                 quant: Optional[str] = None, use_mask: bool = False,
                 weight_mask: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, stride, groups,
                           dilation, use_bias=fused,
                           quant=quant if fused else None, weight_mask=weight_mask)
        self.bn = None if fused else BatchNorm(features)
        # the ChannelMask gate between BN and the activation (:412-413)
        self.mask = ChannelMask(features) if use_mask else None
        self.act = get_activation(act)
        hard = act.lower() in HARD_SWISH_NAMES
        self.act_in_conv = self.conv.quant == "w8a8" and hard and self.mask is None
        self.act_in_bn = self.bn is not None and hard

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.act_in_conv:
            return self.conv(x, dtype, act="hard_swish")
        x = self.conv(x, dtype)
        if self.act_in_bn:
            return self.bn(x, act="hard_swish", mask=self.mask)
        if self.bn is not None:
            x = self.bn(x, mask=self.mask)
        elif self.mask is not None:
            x = self.mask(x)
        return self.act(x)


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (blocks.py:418-440)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None,
                 weight_mask: bool = False):
        super().__init__()
        kw = dict(act=act, fused=fused, quant=quant, weight_mask=weight_mask)
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, **kw)
        self.pconv = ConvBnAct(cin, features, 1, 1, **kw)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class DWConvNoP(nn.Module):
    """Depthwise conv only (blocks.py:443-465)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None,
                 weight_mask: bool = False):
        super().__init__()
        if features != cin:
            raise ValueError(f"DWConvNoP keeps the width: {cin} -> {features}")
        self.dconv = ConvBnAct(cin, cin, kernel_size, stride, groups=cin,
                               dilation=dilation, act=act, fused=fused,
                               quant=quant, weight_mask=weight_mask)

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
    and conv2's widths (:494-508); a residual block keeps ``features``.
    ``use_mask`` gates conv1 and a non-depthwise conv2."""

    def __init__(self, cin: int, features: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 kernel_size: int = 3, dilation: int = 1, act: str = "silu",
                 is_last: bool = False, custom: bool = False,
                 fused: bool = False, quant: Optional[str] = None,
                 hidden_width: Optional[int] = None,
                 out_width: Optional[int] = None, use_mask: bool = False,
                 weight_mask: bool = False):
        super().__init__()
        hidden = hidden_width if hidden_width is not None else int(features * expansion)
        self.use_add = shortcut and cin == features
        out = features if self.use_add or out_width is None else out_width
        self.out_width = out
        kw = dict(act=act, fused=fused, quant=quant, weight_mask=weight_mask)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, use_mask=use_mask, **kw)
        if depthwise and custom and not is_last and not self.use_add:
            self.conv2 = DWConvNoP(hidden, out, kernel_size, 1, dilation, **kw)
        elif depthwise:
            self.conv2 = DWConv(hidden, out, kernel_size, 1, dilation, **kw)
        else:
            # masked in a residual chain too (pre-add), as a member of its
            # residual group (blocks.py:514-527)
            self.conv2 = ConvBnAct(hidden, out, kernel_size, 1,
                                   dilation=dilation, use_mask=use_mask, **kw)

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
    ``features``) of :588-601. ``split_cat`` hands conv2 the pooled maps as
    split-concat parts (:605-607)."""

    def __init__(self, cin: int, features: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 fused: bool = False, quant: Optional[str] = None,
                 hidden_width: Optional[int] = None,
                 out_width: Optional[int] = None, use_mask: bool = False,
                 weight_mask: bool = False, split_cat: bool = False):
        super().__init__()
        self.split_cat = split_cat
        hidden = hidden_width if hidden_width is not None else cin // 2
        self.out_width = out_width if out_width is not None else features
        self.kernel_sizes = tuple(kernel_sizes)
        kw = dict(act=act, fused=fused, quant=quant, use_mask=use_mask,
                  weight_mask=weight_mask)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1, **kw)
        self.conv2 = ConvBnAct(hidden * (len(self.kernel_sizes) + 1),
                               self.out_width, 1, 1, **kw)

    def forward(self, x):
        x = self.conv1(x)
        mesh = active_mesh()
        if mesh is None or mesh.space is None:
            xs = [x] + [max_pool_same(x, k) for k in self.kernel_sizes]
        else:
            # a height-sharded map: one exchange of the widest pool's halo
            # (from several ranks where it is deeper than a rank's rows),
            # -inf past the map's edge, as the pool pads
            r, h = max(self.kernel_sizes) // 2, x.shape[2]
            xh = halo_exchange(x, r, r, mesh.space, fill=float("-inf"),
                               sizes=space_sizes(h))
            xs = [x] + [F.max_pool2d(xh.narrow(2, r - k // 2, h + k // 2 * 2), k, stride=1,
                                     padding=(0, k // 2)) for k in self.kernel_sizes]
        return self.conv2(xs if self.split_cat else torch.cat(xs, dim=1))


class CSPLayer(nn.Module):
    """CSP bottleneck with 3 convs (blocks.py:612-709). With ``custom`` the
    bypass conv2 emits ``cin - hidden`` channels, so the concat ``[x1, x2]``
    is exactly ``cin`` wide.

    ``slim`` holds the channel-slim pins (:640-680): ``{i: (hidden, out)}``
    for bottleneck i (None keeps a default), ``"res"`` for the residual
    stream (conv1 and every bottleneck) and ``"c2"`` for the bypass.
    ``use_mask`` gates conv2, the bottlenecks and, in a residual chain,
    conv1; never conv3.

    ``forward`` takes a map or split-concat parts (the PAFPN's merges under
    ``split_cat``), which conv1 and conv2, both 1x1, take as they are;
    ``split_cat`` hands conv3 ``(x1, x2)`` as parts (:641-703)."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, kernel_size: int = 3,
                 dilation: int = 1, act: str = "silu", custom: bool = False,
                 fused: bool = False, quant: Optional[str] = None,
                 slim: Optional[Dict[Any, Any]] = None, use_mask: bool = False,
                 weight_mask: bool = False, split_cat: bool = False):
        super().__init__()
        self.split_cat = split_cat
        slim = slim or {}
        hidden = slim.get("res", int(features * expansion))
        c2 = slim.get("c2", (cin - hidden) if custom else hidden)
        kw = dict(act=act, fused=fused, quant=quant, weight_mask=weight_mask)
        # conv1 leads a residual group only in a residual, non-depthwise
        # chain; the bypass conv2 is always prunable (blocks.py:665-675)
        self.conv1 = ConvBnAct(cin, hidden, 1, 1,
                               use_mask=use_mask and shortcut and not depthwise, **kw)
        self.conv2 = ConvBnAct(cin, c2, 1, 1, use_mask=use_mask, **kw)
        self.n = n
        width = hidden
        for i in range(n):
            hw, ow = slim.get(i, (None, None))
            block = Bottleneck(
                width, hidden, shortcut=shortcut, expansion=1.0,
                depthwise=depthwise, kernel_size=kernel_size,
                dilation=dilation, is_last=(i == n - 1), custom=custom,
                hidden_width=hw, out_width=ow, use_mask=use_mask, **kw)
            self.add_module(f"m{i}", block)
            width = block.out_width
        self.conv3 = ConvBnAct(width + c2, features, 1, 1, **kw)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        for i in range(self.n):
            x1 = getattr(self, f"m{i}")(x1)
        return self.conv3([x1, x2] if self.split_cat else torch.cat([x1, x2], dim=1))


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
                 fused: bool = False, quant: Optional[str] = None,
                 use_mask: bool = False, weight_mask: bool = False):
        super().__init__()
        self.order = order
        self.conv = ConvBnAct(4 * cin, features, kernel_size, stride, act=act,
                              fused=fused, quant=quant, use_mask=use_mask,
                              weight_mask=weight_mask)

    def forward(self, x_nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = space_to_depth(x_nhwc, self.order).permute(0, 3, 1, 2)
        return self.conv(x, dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW) (blocks.py:763-767)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
