"""Hard-swish, forward and backward, as one elementwise CUDA kernel.

The kernel is ``cocodet_tpu_torch/csrc/hard_swish.cu``, whose header gives
the arithmetic in full: ``jax.nn.hard_swish`` (``x * relu6(x + 3.) / 6.``,
cocodet_tpu/models/blocks.py:53-54) and its VJP, rounded as XLA:CPU rounds
them under ``jax.jit`` (jax 0.9.0). ``hard_swish_plain`` and
``hard_swish_grad_plain`` are the plain versions, op by op with the same
roundings; ``models/blocks.py::hard_swish`` wraps the two wrappers in an
autograd Function that saves ``x`` only.

``hard_swish`` and ``hard_swish_grad`` take the plain versions for tensors
on the CPU, and only there. For CUDA tensors they launch the kernel or
raise; they never fall back. The kernel takes f32 or bf16 ``x`` that is
contiguous in the default or the channels-last memory format; the output
has ``x``'s layout, and a cotangent in another layout is copied into it
first. Launches are counted in ``hard_swish.launches`` and
``hard_swish_grad.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_SOURCE = "hard_swish"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SIXTH_F32 = float(np.float32(1 / 6))  # 0x3e2aaaab
_HALF = (torch.bfloat16, torch.float16)


def _sixth(dtype: torch.dtype) -> float:
    """1/6 rounded to ``dtype`` (f32 or f64), the constant XLA multiplies by
    in place of the division by 6."""
    return SIXTH_F32 if dtype == torch.float32 else 1 / 6


@functools.lru_cache(maxsize=None)
def _six(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.full((), 6.0, dtype=dtype, device=device)


def hard_swish_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish`` with the arithmetic that XLA:CPU gives it under
    jax 0.9.0, one op at a time:

    - f32: ``x * ((x + 3).clamp(0, 6) * f32(1/6))``. XLA rewrites the f32
      division by the constant 6 into a multiply by its rounded reciprocal
      0x3e2aaaab, so the multiply is what JAX computes; f64 (under
      ``jax.enable_x64``) likewise, with the f64 reciprocal;
    - bf16 and f16: ``x * ((x + 3).clamp(0, 6) / 6)``, each op computed in
      f32 and rounded to ``x``'s dtype, the division an IEEE division. The
      6 is a tensor on
      ``x``'s device: a PyTorch CUDA division by a Python number multiplies
      by the reciprocal instead.

    ``F.hardswish`` rounds otherwise (it differs from JAX on about a quarter
    of f32 inputs in [-4, 4]). XLA:CPU also flushes subnormal inputs and
    results to zero; PyTorch keeps them, on the CPU and in the kernels
    alike, so the two differ only there.
    """
    if x.dtype in _HALF:
        return x * ((x + 3).clamp(0, 6) / _six(x.device, x.dtype))
    return x * ((x + 3).clamp(0, 6) * _sixth(x.dtype))


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of f32 tensors, rounded once to f32. The product is exact
    in f64; the f64 sum is rounded to odd (its error, by TwoSum, nudges an
    inexact even result one ulp towards the true value), so rounding it to
    f32 gives the correctly rounded fused result."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def hard_swish_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP of ``jax.nn.hard_swish`` at ``x`` with cotangent ``g``, as
    ``jax.jit(jax.vjp)`` computes it on XLA:CPU: relu6's strict mask
    ``m = (0 < t < 6)`` with ``t = x + 3``, ``h = clamp(t, 0, 6) * f32(1/6)``
    and ``dx = g * h + (m ? (x * g) * f32(1/6) : 0)``. In f32 XLA fuses
    ``g * h + s`` into one fused multiply-add; in f64 it does the same, and
    here the product ``g * h`` is rounded before the sum, which moves a
    result by at most that rounding. In bf16 and f16 every op is computed in
    f32 and rounded to ``x``'s dtype, and the mask reads the rounded ``t``."""
    if x.dtype in _HALF:
        def rnd(v):
            return v.to(x.dtype).float()

        xf, gf = x.float(), g.float()
        t = rnd(xf + 3)
        a = rnd(gf * rnd(t.clamp(0, 6) * SIXTH_F32))
        s = torch.where((t > 0) & (t < 6), rnd(rnd(xf * gf) * SIXTH_F32), 0.0)
        return (a + s).to(x.dtype)
    sixth = _sixth(x.dtype)
    t = x + 3
    s = torch.where((t > 0) & (t < 6), (x * g) * sixth, 0.0)
    if x.dtype == torch.float32:
        return _fma_f32(g, t.clamp(0, 6) * sixth, s)
    return g * (t.clamp(0, 6) * sixth) + s


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_hard_swish.argtypes = [p, p, p, ctypes.c_int64, i, i, p]
    lib.cocodet_hard_swish.restype = i
    return lib


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16, got {x.dtype}")
    dense = x.is_contiguous() or (x.dim() == 4 and
                                  x.is_contiguous(memory_format=torch.channels_last))
    if not dense:
        raise ValueError(f"{what} takes a tensor contiguous in the default or the "
                         f"channels-last memory format, got strides {x.stride()}")


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


def _launch(x: torch.Tensor, g, out: torch.Tensor) -> None:
    if x.numel() == 0:
        return
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().cocodet_hard_swish(
            x.data_ptr(), None if g is None else g.data_ptr(), out.data_ptr(),
            x.numel(), _DTYPES[x.dtype], int(g is not None), stream)
    if rc != 0:
        raise RuntimeError(f"hard_swish kernel launch failed: CUDA error {rc}")


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish(x)``: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if x.device.type == "cpu":
        return hard_swish_plain(x)
    _check(x, "hard_swish")
    y = torch.empty_like(x)
    _launch(x, None, y)
    hard_swish.launches += 1
    return y


hard_swish.launches = 0


def hard_swish_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP of hard-swish at ``x`` with cotangent ``g`` (same shape and
    dtype): the kernel on CUDA tensors, the plain version on CPU ones."""
    if x.shape != g.shape or x.dtype != g.dtype or x.device != g.device:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} {x.device} and g "
                         f"{tuple(g.shape)} {g.dtype} {g.device} must match")
    if x.device.type == "cpu":
        return hard_swish_grad_plain(x, g)
    _check(x, "hard_swish_grad")
    if not _same_layout(x, g):
        g = torch.empty_like(x).copy_(g)
    dx = torch.empty_like(x)
    _launch(x, g, dx)
    hard_swish_grad.launches += 1
    return dx


hard_swish_grad.launches = 0


def reset_launch_counts() -> None:
    hard_swish.launches = 0
    hard_swish_grad.launches = 0
