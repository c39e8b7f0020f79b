"""Train-mode BatchNorm fused with the activation after it: two CUDA kernels
each way (a per-channel reduction, then one elementwise pass).

The kernels are ``cocodet_tpu_torch/csrc/bn_act.cu``, whose header gives the
arithmetic in full: flax ``nn.BatchNorm(use_running_average=False,
momentum=0.97, epsilon=1e-3, dtype)`` and then ``jax.nn.hard_swish`` (or no
activation), cocodet_tpu/models/blocks.py:403-415, and their VJP in closed
form. ``models/blocks.py::BatchNorm`` runs them through one autograd
Function that saves the map ``x`` and the per-channel vectors only.

The stages, each with its plain PyTorch version (``*_plain``), op by op in
the kernel's order of rounding:

- ``reduce``: ``sums = [sum x, sum x^2, count]`` over N, H, W and, from
  them, ``fvec = [mean, d, inv, mul]`` (``d = E[x^2] - mean^2``, ``var =
  max(d, 0)``, ``inv = 1 / sqrt(var + eps)``, ``mul = inv * scale``); the
  running statistics are updated in place. ``finish=False`` gives the sums
  only, which a data-parallel step sums over ranks before ``finish``;
- ``apply``: ``y = act(T((x - mean) * mul + bias))``;
- ``grad_reduce``: ``gsums = [sum gz, sum gz (x - mean)]`` with ``gz`` the
  activation's VJP at the recomputed BN output, and from them ``bvec = [c1,
  c2, dscale, dbias]``; ``grad_finish`` likewise after a sum over ranks;
- ``grad_apply``: ``dx = T((gz * mul + c1) + c2 * x)``.

Given the same sums, the vectors and the running statistics of a kernel equal
the plain version's bit for bit (``inv`` is computed in f64 from the f32
``var + eps`` and rounded once, on both sides), and so does each apply stage
given the same vectors; the sums themselves are taken in another order.

Every wrapper takes the plain version for tensors on the CPU, and only
there: for CUDA tensors it launches its kernel or raises. The kernels take
f32 or bf16 maps (N, C, H, W) contiguous in the channels-last or the default
memory format, and f32 vectors; a cotangent in another layout than its map is
copied into it first. Launches are counted on each wrapper (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from . import hard_swish as hs

_SOURCE = "bn_act"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"identity": 0, "hard_swish": 1}
_THREADS = 256
_ROWS_A_THREAD = 8        # the least rows a thread of the reduce takes
_REDUCE_TILE = 32         # channels a tile of the reduce (more tiles, more blocks finish)
_APPLY_TILE = 256         # channels a tile of the apply
_MAX_TRIPS = 8            # the apply's most trips of a thread (each the kernel's unroll rows)

_POINTERS = ("x", "g", "y", "fvec", "bias", "bvec", "partials", "counters", "sums", "local",
             "weight", "running_mean", "running_var", "count", "vec_out")
_INTS = ("C", "dtype", "act", "backward", "vec", "nchw", "groups", "lanes", "grid_x", "tiles",
         "trips", "finish")


class _Args(ctypes.Structure):
    """csrc/bn_act.cu::BnActArgs, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [("outer", ctypes.c_int64), ("inner", ctypes.c_int64)]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in ("eps", "keep", "one_minus_keep")])


def _acc(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: f32, or f64 for an f64 map (flax's promotion)."""
    return torch.promote_types(x.dtype, torch.float32)


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"bn_act takes act in {tuple(ACTS)}, got {act!r}")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """``[sum x (C), sum x^2 (C), count]`` over N, H and W, in f32 (f64 for
    an f64 map)."""
    xf = x.to(_acc(x))
    count = torch.full((1,), x.numel() // x.shape[1], dtype=xf.dtype, device=x.device)
    return torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])


def finish_plain(sums: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
                 running_var: torch.Tensor, eps: float, momentum: float) -> torch.Tensor:
    """``fvec = [mean, d, inv, mul]`` (4, C) from ``stats_plain``'s sums, as
    flax computes them; the running statistics updated in place with flax's
    momentum ``keep = 1 - momentum`` and the biased variance. ``inv`` is the
    correctly rounded ``rsqrt``: one rounding of the f64 ``1 / sqrt``."""
    c = weight.numel()
    n = sums[2 * c:]
    mean = sums[:c] / n
    d = sums[c:2 * c] / n - mean * mean
    # maximum, not clamp: at var == 0 (a constant channel) its gradient splits
    # in two, as jnp.maximum's does (grad_finish_plain)
    var = torch.maximum(d, torch.zeros_like(d))
    inv = (var + eps).double().sqrt().reciprocal().to(var.dtype)
    keep = 1.0 - momentum
    for ra, stat in ((running_mean, mean), (running_var, var)):
        ra.copy_(keep * ra + (1 - keep) * stat)
    return torch.stack([mean, d, inv, inv * weight])


def reduce_plain(x: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
                 running_var: torch.Tensor, eps: float, momentum: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's reduce stage: ``(sums, fvec)``."""
    sums = stats_plain(x)
    return sums, finish_plain(sums, weight, running_mean, running_var, eps, momentum)


def _bn_z(x: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``T((x - mean) * mul + bias)``: the BN output in the map's dtype."""
    acc = _acc(x)
    return ((x.to(acc) - _chan(fvec[0])) * _chan(fvec[3]) + _chan(bias.to(acc))).to(x.dtype)


def apply_plain(x: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
                act: str = "hard_swish") -> torch.Tensor:
    """``y = act(T((x - mean) * mul + bias))``."""
    _check_act(act)
    z = _bn_z(x, fvec, bias)
    return hs.hard_swish_plain(z) if act == "hard_swish" else z


def _grad_z(x, g, fvec, bias, act) -> torch.Tensor:
    """The cotangent of the BN output, ``act_vjp(z, g)`` in the map's dtype,
    as the statistics' dtype."""
    gz = hs.hard_swish_grad_plain(_bn_z(x, fvec, bias), g) if act == "hard_swish" else g
    return gz.to(_acc(x))


def grad_stats_plain(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor,
                     bias: torch.Tensor, act: str = "hard_swish") -> torch.Tensor:
    """``[sum gz (C), sum gz (x - mean) (C)]`` over N, H and W."""
    _check_act(act)
    gz = _grad_z(x, g, fvec, bias, act)
    t = x.to(_acc(x)) - _chan(fvec[0])
    return torch.cat([gz.sum((0, 2, 3)), (gz * t).sum((0, 2, 3))])


def grad_finish_plain(gsums: torch.Tensor, fvec: torch.Tensor, weight: torch.Tensor,
                      count: torch.Tensor, local: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``bvec = [c1, c2, dscale, dbias]`` (4, C): ``dx = gz * mul + c1 + c2 *
    x`` is autograd's chain through ``finish_plain`` and ``apply_plain`` in
    closed form; ``gsums`` are summed over every rank (the coefficients),
    ``local`` this rank's own (the parameter gradients; default ``gsums``).
    ``count`` is the forward's (``sums[2C:]``)."""
    c = weight.numel()
    a, b = gsums[:c], gsums[c:]
    al, bl = (a, b) if local is None else (local[:c], local[c:])
    mean, d, inv, mul = fvec
    du = (b * weight * -0.5) * (inv * inv * inv)
    # jnp.maximum(0, d) passes the whole gradient where d > 0, half of it at
    # a tie, none below
    dd = torch.where(d > 0, du, torch.where(d == 0, du * 0.5, torch.zeros_like(du)))
    dmean = -mul * a - 2 * mean * dd
    return torch.stack([dmean / count, 2 * dd / count, bl * inv, al])


def grad_reduce_plain(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor,
                      bias: torch.Tensor, weight: torch.Tensor, count: torch.Tensor,
                      act: str = "hard_swish") -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's reduce stage: ``(gsums, bvec)``."""
    gsums = grad_stats_plain(x, g, fvec, bias, act)
    return gsums, grad_finish_plain(gsums, fvec, weight, count)


def grad_apply_plain(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor,
                     bias: torch.Tensor, bvec: torch.Tensor,
                     act: str = "hard_swish") -> torch.Tensor:
    """``dx = T((gz * mul + c1) + c2 * x)``."""
    _check_act(act)
    gz = _grad_z(x, g, fvec, bias, act)
    dx = (gz * _chan(fvec[3]) + _chan(bvec[0])) + _chan(bvec[1]) * x.to(_acc(x))
    return dx.to(x.dtype)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    for name in ("cocodet_bn_act_reduce", "cocodet_bn_act_apply", "cocodet_bn_act_finish"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("cocodet_bn_act_unroll", "cocodet_bn_act_min_blocks"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.cache
def _unroll() -> int:
    """Rows (channels-last) or vectors (NCHW) a thread of the apply loads
    at once: the kernel's own constant."""
    return _lib().cocodet_bn_act_unroll()


@functools.cache
def _target_blocks(device: torch.device) -> int:
    """Blocks to aim for over all tiles: as many as the card keeps
    resident, the kernel's blocks an SM times the card's SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _lib().cocodet_bn_act_min_blocks() * sms


_counters = {}


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """The reduce's ticket counters on ``device``, one a channel tile. Zero
    at rest: each launch's last block sets its counter back to 0."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return buf


def _check_map(x: torch.Tensor, what: str) -> Tuple[bool, int, int]:
    """(nchw, outer, inner) of a map the kernels take; raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes f32 or bf16, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{what} takes a non-empty (N, C, H, W) map, got {tuple(x.shape)}")
    n, _, h, w = x.shape
    if x.is_contiguous(memory_format=torch.channels_last):
        return False, n * h * w, 1
    if x.is_contiguous():
        return True, n, h * w
    raise ValueError(f"{what} takes a map contiguous in the channels-last or the default "
                     f"memory format, got strides {x.stride()}")


def _check_vec(t: torch.Tensor, shape, device, what: str) -> None:
    if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: takes a contiguous f32 {tuple(shape)} tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _cl_tiles(c: int, v: int, width: int) -> Tuple[int, int, int]:
    """(groups, lanes, tiles) of a channels-last map of ``c`` channels
    loaded ``v`` at a time: the fewest tiles of at most ``width`` channels
    (``width`` a multiple of 8, at most 256), split evenly into groups of
    ``v`` channels, and as many row lanes as fit a block of 256 threads.
    The reduce takes narrow tiles: the last block of each tile sums the
    blocks' partials of its channels, with 256 / (its channels) threads a
    channel."""
    n = c // v
    tiles = math.ceil(n / (width // v))
    groups = math.ceil(n / tiles)
    return groups, _THREADS // groups, tiles


def _plan(x: torch.Tensor, maps, backward: bool, act: str, what: str) -> _Args:
    """The grid of both kernels for map ``x`` (and the other ``maps`` of its
    layout): 16-byte loads where every pointer is aligned and the contiguous
    dimension (C, or H*W for NCHW) holds whole vectors."""
    _check_act(act)
    nchw, outer, inner = _check_map(x, what)
    c = x.shape[1]
    v = 16 // x.element_size()
    vec = all(m.data_ptr() % 16 == 0 for m in maps) and (inner if nchw else c) % v == 0
    v = v if vec else 1
    blocks = _target_blocks(x.device)
    a = _Args(outer=outer, inner=inner, C=c, dtype=_DTYPES[x.dtype], act=ACTS[act],
              backward=int(backward), vec=int(vec), nchw=int(nchw))
    if nchw:
        a.groups, a.lanes, a.tiles = 1, _THREADS, c
        per_channel = outer * inner // v
        a.grid_x = min(math.ceil(per_channel / (_THREADS * _ROWS_A_THREAD)),
                       math.ceil(blocks / c))
    else:
        a.groups, a.lanes, a.tiles = _cl_tiles(c, v, _REDUCE_TILE)
        a.grid_x = min(math.ceil(outer / (a.lanes * _ROWS_A_THREAD)),
                       math.ceil(blocks / a.tiles))
    a.grid_x = max(1, a.grid_x)
    return a


def _apply_grid(a: _Args, device: torch.device) -> None:
    """Turn a plan into the apply's grid: one pass; a thread takes the
    kernel's unroll vectors (NCHW), or channels-last ``trips`` trips of
    unroll rows, as many (up to _MAX_TRIPS) as leave the map the target
    blocks."""
    v = (16 // 4 if a.dtype == _DTYPES[torch.float32] else 16 // 2) if a.vec else 1
    unroll = _unroll()
    if a.nchw:
        a.grid_x = math.ceil(a.outer * a.C * a.inner / (_THREADS * unroll * v))
        a.tiles = 1
    else:
        a.groups, a.lanes, a.tiles = _cl_tiles(a.C, v, _APPLY_TILE)
        one_trip = math.ceil(a.outer / (a.lanes * unroll))
        a.trips = max(1, min(_MAX_TRIPS, one_trip * a.tiles // _target_blocks(device)))
        a.grid_x = math.ceil(a.outer / (a.lanes * unroll * a.trips))
    if a.grid_x >= 1 << 31:
        raise ValueError(f"bn_act: map too large ({a.outer} x {a.C} x {a.inner})")


def _call(fn: str, a: _Args, device: torch.device) -> None:
    with torch.cuda.device(device):
        rc = getattr(_lib(), fn)(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: CUDA error {rc}")


def _forward_finish_args(a: _Args, weight, running_mean, running_var, eps, momentum,
                         device) -> None:
    c = a.C
    for t, name in ((weight, "weight"), (running_mean, "running_mean"),
                    (running_var, "running_var")):
        _check_vec(t, (c,), device, f"bn_act {name}")
    keep = 1.0 - momentum
    a.weight, a.running_mean, a.running_var = (weight.data_ptr(), running_mean.data_ptr(),
                                               running_var.data_ptr())
    a.eps, a.keep, a.one_minus_keep = float(np.float32(eps)), float(np.float32(keep)), \
        float(np.float32(1 - keep))


def _cotangent(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` in ``x``'s layout (a copy where the layouts differ)."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} {x.device} and g {tuple(g.shape)} "
                         f"{g.dtype} {g.device} must match")
    same = all(sa == sb for sa, sb, n in zip(x.stride(), g.stride(), x.shape) if n > 1)
    return g if same else torch.empty_like(x).copy_(g)


def reduce(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
           running_mean: Optional[torch.Tensor] = None,
           running_var: Optional[torch.Tensor] = None, eps: float = 1e-3,
           momentum: float = 0.03, finish: bool = True
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward's reduce stage: ``(sums, fvec)``, the running statistics
    updated in place. With ``finish=False``: ``(sums, None)``, the sums only
    (a data-parallel step sums them over ranks, then calls ``finish``)."""
    if x.device.type == "cpu":
        sums = stats_plain(x)
        if not finish:
            return sums, None
        return sums, finish_plain(sums, weight, running_mean, running_var, eps, momentum)
    a = _plan(x, (x,), False, "identity", "bn_act reduce")
    c = x.shape[1]
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    partials = torch.empty(a.grid_x * 2 * c, dtype=torch.float32, device=x.device)
    fvec = None
    a.x, a.partials, a.sums = x.data_ptr(), partials.data_ptr(), sums.data_ptr()
    a.counters = _ticket_counters(x.device, a.tiles).data_ptr()
    if finish:
        _forward_finish_args(a, weight, running_mean, running_var, eps, momentum, x.device)
        fvec = torch.empty((4, c), dtype=torch.float32, device=x.device)
        a.finish, a.vec_out = 1, fvec.data_ptr()
    _call("cocodet_bn_act_reduce", a, x.device)
    reduce.launches += 1
    return sums, fvec


def finish(sums: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
           running_var: torch.Tensor, eps: float = 1e-3, momentum: float = 0.03
           ) -> torch.Tensor:
    """``fvec`` from sums that were summed over ranks (``reduce(...,
    finish=False)`` then an all-reduce), the running statistics updated."""
    if sums.device.type == "cpu":
        return finish_plain(sums, weight, running_mean, running_var, eps, momentum)
    c = weight.numel()
    _check_vec(sums, (2 * c + 1,), sums.device, "bn_act finish sums")
    a = _Args(C=c, backward=0)
    _forward_finish_args(a, weight, running_mean, running_var, eps, momentum, sums.device)
    fvec = torch.empty((4, c), dtype=torch.float32, device=sums.device)
    a.sums, a.vec_out = sums.data_ptr(), fvec.data_ptr()
    _call("cocodet_bn_act_finish", a, sums.device)
    finish.launches += 1
    return fvec


def apply(x: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
          act: str = "hard_swish") -> torch.Tensor:
    """``y = act(T((x - mean) * mul + bias))``, in ``x``'s layout."""
    if x.device.type == "cpu":
        return apply_plain(x, fvec, bias, act)
    y = torch.empty_like(x)
    a = _plan(x, (x, y), False, act, "bn_act apply")
    _check_vec(fvec, (4, x.shape[1]), x.device, "bn_act fvec")
    _check_vec(bias, (x.shape[1],), x.device, "bn_act bias")
    _apply_grid(a, x.device)
    a.x, a.y, a.fvec, a.bias = x.data_ptr(), y.data_ptr(), fvec.data_ptr(), bias.data_ptr()
    _call("cocodet_bn_act_apply", a, x.device)
    apply.launches += 1
    return y


def grad_reduce(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
                weight: torch.Tensor, count: torch.Tensor, act: str = "hard_swish",
                finish: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward's reduce stage: ``(gsums, bvec)``; with ``finish=False``
    ``(gsums, None)`` (then an all-reduce and ``grad_finish``). ``count`` is
    the forward's, ``sums[2C:]``."""
    if x.device.type == "cpu":
        gsums = grad_stats_plain(x, g, fvec, bias, act)
        if not finish:
            return gsums, None
        return gsums, grad_finish_plain(gsums, fvec, weight, count)
    g = _cotangent(x, g)
    a = _plan(x, (x, g), True, act, "bn_act grad_reduce")
    c = x.shape[1]
    for t, shape, name in ((fvec, (4, c), "fvec"), (bias, (c,), "bias"),
                           (weight, (c,), "weight"), (count, (1,), "count")):
        _check_vec(t, shape, x.device, f"bn_act {name}")
    gsums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    partials = torch.empty(a.grid_x * 2 * c, dtype=torch.float32, device=x.device)
    a.x, a.g, a.fvec, a.bias = x.data_ptr(), g.data_ptr(), fvec.data_ptr(), bias.data_ptr()
    a.partials, a.sums = partials.data_ptr(), gsums.data_ptr()
    a.counters = _ticket_counters(x.device, a.tiles).data_ptr()
    bvec = None
    if finish:
        bvec = torch.empty((4, c), dtype=torch.float32, device=x.device)
        a.finish, a.vec_out = 1, bvec.data_ptr()
        a.weight, a.count = weight.data_ptr(), count.data_ptr()
    _call("cocodet_bn_act_reduce", a, x.device)
    grad_reduce.launches += 1
    return gsums, bvec


def grad_finish(gsums: torch.Tensor, local: torch.Tensor, fvec: torch.Tensor,
                weight: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``bvec`` from ``gsums`` summed over ranks (the coefficients of dx) and
    this rank's ``local`` sums (the parameter gradients)."""
    if gsums.device.type == "cpu":
        return grad_finish_plain(gsums, fvec, weight, count, local)
    c = weight.numel()
    dev = gsums.device
    for t, shape, name in ((gsums, (2 * c,), "gsums"), (local, (2 * c,), "local"),
                           (fvec, (4, c), "fvec"), (weight, (c,), "weight"),
                           (count, (1,), "count")):
        _check_vec(t, shape, dev, f"bn_act {name}")
    bvec = torch.empty((4, c), dtype=torch.float32, device=dev)
    a = _Args(C=c, backward=1, sums=gsums.data_ptr(), local=local.data_ptr(),
              fvec=fvec.data_ptr(), weight=weight.data_ptr(), count=count.data_ptr(),
              vec_out=bvec.data_ptr())
    _call("cocodet_bn_act_finish", a, dev)
    grad_finish.launches += 1
    return bvec


def grad_apply(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
               bvec: torch.Tensor, act: str = "hard_swish") -> torch.Tensor:
    """``dx = T((gz * mul + c1) + c2 * x)``, in ``x``'s layout."""
    if x.device.type == "cpu":
        return grad_apply_plain(x, g, fvec, bias, bvec, act)
    g = _cotangent(x, g)
    dx = torch.empty_like(x)
    a = _plan(x, (x, g, dx), True, act, "bn_act grad_apply")
    c = x.shape[1]
    for t, shape, name in ((fvec, (4, c), "fvec"), (bias, (c,), "bias"),
                           (bvec, (4, c), "bvec")):
        _check_vec(t, shape, x.device, f"bn_act {name}")
    _apply_grid(a, x.device)
    a.x, a.g, a.y = x.data_ptr(), g.data_ptr(), dx.data_ptr()
    a.fvec, a.bias, a.bvec = fvec.data_ptr(), bias.data_ptr(), bvec.data_ptr()
    _call("cocodet_bn_act_apply", a, x.device)
    grad_apply.launches += 1
    return dx


WRAPPERS = (reduce, finish, apply, grad_reduce, grad_finish, grad_apply)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
