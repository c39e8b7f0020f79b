"""Int8 fake-quantization, forward and backward, as one elementwise CUDA
kernel: the simulated w8a8 numerics of the ``quant="qat"`` conv
(cocodet_tpu/models/blocks.py:140-153, :284-319).

The kernel is ``cocodet_tpu_torch/csrc/fake_quant.cu``, whose header gives
the arithmetic in full. ``fake_quant_plain`` and ``fake_quant_grad_plain``
are the plain versions, op by op with the same roundings;
``models/blocks.py::fake_quant`` wraps the two wrappers in an autograd
Function that saves its input only.

Each element has a scale ``s`` and a clip bound ``b`` (the clip is
``[-b, b]``), one pair for the tensor (0-d) or one per index along ``axis``,
and optionally a divisor per index along dim 1 (a kernel's input channel):

- an activation: ``s`` the frozen act_scale, ``b = s * 127`` (``act_bound``);
- a kernel: ``s = am * f32(1/127)`` and ``b = am`` with ``am`` each out
  channel's ``max(max |w|, 1e-8)`` (``weight_scale_bound``), the divisor the
  per-channel act_scale folded into it. That is what the jitted JAX step
  computes: XLA turns ``/ 127.0`` into a multiply by ``f32(1/127)`` and folds
  ``127 * (am / 127)`` back into ``am``, so each out channel's largest
  weight sits on the bound (and takes the gradient 1/2 there).

``fake_quant`` and ``fake_quant_grad`` take the plain versions for tensors
on the CPU, and only there. For CUDA tensors they launch the kernel or
raise; they never fall back. The kernel takes f32 tensors dense in any
memory format (the channel of a storage index is found from the axis'
stride); the output has the input's layout, and a cotangent in another
layout is copied into it first. Launches are counted in
``fake_quant.launches`` and ``fake_quant_grad.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

_SOURCE = "fake_quant"
INV_127 = float(np.float32(1 / 127))  # 0x3c010204, XLA's reciprocal of 127


def act_bound(scale: torch.Tensor) -> torch.Tensor:
    """The clip bound of an activation scale: ``scale * 127`` in f32."""
    return scale * 127.0


def weight_scale_bound(kf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bound) of a kernel, per out channel (dim 0 of OIHW): ``am *
    f32(1/127)`` and ``am = max(max |kf|, 1e-8)``, taken with no gradient."""
    am = kf.detach().abs().amax(dim=tuple(range(1, kf.dim()))).clamp_min(1e-8)
    return am * INV_127, am


def _along(vec: Optional[torch.Tensor], v: torch.Tensor, axis: int):
    """``vec`` shaped to broadcast along ``axis`` of ``v`` (a 0-d one as it is)."""
    if vec is None or vec.dim() == 0:
        return vec
    shape = [1] * v.dim()
    shape[axis] = -1
    return vec.view(shape)


def _clip(v, b):
    """jnp.clip's max, then min, each propagating NaN: (max(-b, v), the clipped v)."""
    m = torch.maximum(-b, v)
    return m, torch.minimum(b, m)


def fake_quant_plain(v: torch.Tensor, scale: torch.Tensor, bound: torch.Tensor,
                     axis: int = 1, div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward, op by op: ``vc = min(b, max(-b, v))``, ``y = vc +
    (round(vc / s) * s - vc)`` (round half to even, an IEEE division: the
    quotient is taken in f64 and rounded, which rounds as the f32 division
    does, whatever device), then ``y / div`` where a divisor is given."""
    s, b, d = _along(scale, v, axis), _along(bound, v, axis), _along(div, v, 1)
    _, vc = _clip(v, b)
    q = torch.round((vc.double() / s.double()).float())
    y = vc + (q * s - vc)
    return y if d is None else (y.double() / d.double()).float()


def fake_quant_grad_plain(v: torch.Tensor, g: torch.Tensor, bound: torch.Tensor,
                          axis: int = 1, div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The VJP at ``v`` with cotangent ``g``: the gradient of XLA's max and
    min (1/2 where the two operands tie, so 1/2 at v = +-b), ``dx = ((g /
    div) * gmin) * gmax``."""
    b, d = _along(bound, v, axis), _along(div, v, 1)
    m, vc = _clip(v, b)
    one, half, zero = (torch.tensor(x, dtype=v.dtype, device=v.device) for x in (1.0, 0.5, 0.0))
    gmin = torch.where(m == vc, torch.where(b == vc, half, one), zero)
    gmax = torch.where(v == m, torch.where(-b == m, half, one), zero)
    t = g if d is None else (g.double() / d.double()).float()
    return (t * gmin) * gmax


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cocodet_fake_quant.argtypes = [p, p, p, i64, p, p, i64, i64, p, i64, i64,
                                       ctypes.c_int, p]
    lib.cocodet_fake_quant.restype = ctypes.c_int
    return lib


def _dense(t: torch.Tensor) -> bool:
    """Non-overlapping and dense: the storage holds exactly its elements."""
    if t.numel() <= 1:
        return True
    dims = sorted((st, n) for st, n in zip(t.stride(), t.shape) if n > 1)
    expect = 1
    for st, n in dims:
        if st != expect:
            return False
        expect *= n
    return True


def _channels(v: torch.Tensor, vec: Optional[torch.Tensor], axis: int, what: str):
    """(inner, count) of the kernel's channel map: a 0-d ``vec`` is one
    channel; a vector is one value per index along ``axis``."""
    if vec is None or vec.dim() == 0:
        return 1, 1
    if vec.shape != (v.shape[axis],):
        raise ValueError(f"{what}: {tuple(vec.shape)} values for axis {axis} of "
                         f"{tuple(v.shape)}")
    return max(v.stride(axis), 1), v.shape[axis]


def _vec(t: Optional[torch.Tensor], v: torch.Tensor, what: str) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.device != v.device or t.dtype != torch.float32:
        raise ValueError(f"{what} must be f32 on {v.device}, got {t.dtype} on {t.device}")
    return t.contiguous()


def _launch(v, g, out, scale, bound, axis, div) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"fake_quant runs on cpu or cuda, not {v.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"fake_quant takes f32, got {v.dtype}")
    if not _dense(v):
        raise ValueError(f"fake_quant takes a dense tensor, got strides {v.stride()}")
    bound = _vec(bound, v, "bound")
    scale = bound if scale is None else _vec(scale, v, "scale")  # the backward reads no scale
    div = _vec(div, v, "div")
    if scale.shape != bound.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and bound {tuple(bound.shape)} differ")
    s_inner, s_count = _channels(v, bound, axis, "scale")
    d_inner, d_count = _channels(v, div, 1, "div")
    if v.numel() == 0:
        return
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_fake_quant(
            v.data_ptr(), None if g is None else g.data_ptr(), out.data_ptr(), v.numel(),
            scale.data_ptr(), bound.data_ptr(), s_inner, s_count,
            None if div is None else div.data_ptr(), d_inner, d_count, int(g is not None),
            stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error {rc}")


def fake_quant(v: torch.Tensor, scale: torch.Tensor, bound: torch.Tensor, axis: int = 1,
               div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if v.device.type == "cpu":
        return fake_quant_plain(v, scale, bound, axis, div)
    y = torch.empty_like(v)
    _launch(v, None, y, scale, bound, axis, div)
    fake_quant.launches += 1
    return y


fake_quant.launches = 0


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def fake_quant_grad(v: torch.Tensor, g: torch.Tensor, bound: torch.Tensor, axis: int = 1,
                    div: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The VJP at ``v`` with cotangent ``g`` (same shape and dtype): the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if v.shape != g.shape or v.dtype != g.dtype or v.device != g.device:
        raise ValueError(f"v {tuple(v.shape)} {v.dtype} {v.device} and g "
                         f"{tuple(g.shape)} {g.dtype} {g.device} must match")
    if v.device.type == "cpu":
        return fake_quant_grad_plain(v, g, bound, axis, div)
    if not _same_layout(v, g):
        g = torch.empty_like(v).copy_(g)
    dx = torch.empty_like(v)
    _launch(v, g, dx, None, bound, axis, div)
    fake_quant_grad.launches += 1
    return dx


fake_quant_grad.launches = 0


def reset_launch_counts() -> None:
    fake_quant.launches = 0
    fake_quant_grad.launches = 0
