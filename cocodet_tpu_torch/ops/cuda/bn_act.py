"""Train-mode BatchNorm fused with the activation after it: one CUDA kernel
each way where a map's channel tile fits a thread-block cluster's shared
memory (the resident kernel), else two (a per-channel reduction, then one
elementwise pass).

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
- ``grad_apply``: ``dx = T((gz * mul + c1) + c2 * x)``, ``gz`` recomputed
  or read back where ``grad_reduce`` wrote it (``backward`` keeps it for a
  channels-last map);
- ``resident_forward`` and ``resident_backward``: a map's reduce and apply
  in one launch (``bn_act_resident_kernel``), the map read once; ``forward``
  and ``backward`` take them where ``resident_plan`` gives the map a plan,
  the two stages otherwise.

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
             "weight", "running_mean", "running_var", "count", "vec_out", "gz")
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


def grad_z(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
           act: str = "hard_swish") -> torch.Tensor:
    """``gz``, the cotangent of the BN output, in x's dtype: what
    ``grad_reduce(..., gz=)`` writes."""
    return _grad_z(x, g, fvec, bias, act).to(x.dtype)


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
                     act: str = "hard_swish", gz: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``dx = T((gz * mul + c1) + c2 * x)``; ``gz`` (``grad_z``'s values in
    x's dtype) in place of the activation's VJP of ``g`` where given."""
    _check_act(act)
    gz = _grad_z(x, g, fvec, bias, act) if gz is None else gz.to(_acc(x))
    dx = (gz * _chan(fvec[3]) + _chan(bvec[0])) + _chan(bvec[1]) * x.to(_acc(x))
    return dx.to(x.dtype)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    for name in ("cocodet_bn_act_reduce", "cocodet_bn_act_apply", "cocodet_bn_act_finish",
                 "cocodet_bn_act_resident"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("cocodet_bn_act_unroll", "cocodet_bn_act_min_blocks",
                 "cocodet_bn_act_resident_scratch"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.cocodet_bn_act_resident_clusters.argtypes = [ctypes.POINTER(_Args),
                                                     ctypes.POINTER(ctypes.c_int)]
    lib.cocodet_bn_act_resident_clusters.restype = ctypes.c_int
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
        if vec and a.groups > 1 and a.groups % 2:
            # an even count of 16-byte groups: whole 32-byte sectors of a
            # row a tile, so the gz a backward reduce may write is no
            # partial sector that two tiles' blocks write apart
            a.groups -= 1
            a.tiles = math.ceil(c // v / a.groups)
            a.lanes = _THREADS // a.groups
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
                finish: bool = True, gz: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward's reduce stage: ``(gsums, bvec)``; with ``finish=False``
    ``(gsums, None)`` (then an all-reduce and ``grad_finish``). ``count`` is
    the forward's, ``sums[2C:]``. ``gz``, a tensor like a channels-last
    ``x``, receives ``grad_z`` (for ``grad_apply``)."""
    if gz is not None and (gz.shape != x.shape or gz.dtype != x.dtype
                           or gz.device != x.device or gz.stride() != x.stride()
                           or not x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("bn_act grad_reduce: gz must be laid out as a channels-last x")
    if x.device.type == "cpu":
        if gz is not None:
            gz.copy_(grad_z(x, g, fvec, bias, act))
        gsums = grad_stats_plain(x, g, fvec, bias, act)
        if not finish:
            return gsums, None
        return gsums, grad_finish_plain(gsums, fvec, weight, count)
    g = _cotangent(x, g)
    a = _plan(x, (x, g) if gz is None else (x, g, gz), True, act, "bn_act grad_reduce")
    c = x.shape[1]
    for t, shape, name in ((fvec, (4, c), "fvec"), (bias, (c,), "bias"),
                           (weight, (c,), "weight"), (count, (1,), "count")):
        _check_vec(t, shape, x.device, f"bn_act {name}")
    gsums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    partials = torch.empty(a.grid_x * 2 * c, dtype=torch.float32, device=x.device)
    a.x, a.g, a.fvec, a.bias = x.data_ptr(), g.data_ptr(), fvec.data_ptr(), bias.data_ptr()
    a.partials, a.sums = partials.data_ptr(), gsums.data_ptr()
    if gz is not None:
        a.gz = gz.data_ptr()
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
               bvec: torch.Tensor, act: str = "hard_swish",
               gz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dx = T((gz * mul + c1) + c2 * x)``, in ``x``'s layout; ``gz`` as
    ``grad_reduce(..., gz=)`` wrote it, in place of ``g``, where given."""
    if x.device.type == "cpu":
        return grad_apply_plain(x, g, fvec, bias, bvec, act, gz)
    g = _cotangent(x, g if gz is None else gz)
    dx = torch.empty_like(x)
    a = _plan(x, (x, g, dx), True, act, "bn_act grad_apply")
    c = x.shape[1]
    for t, shape, name in ((fvec, (4, c), "fvec"), (bias, (c,), "bias"),
                           (bvec, (4, c), "bvec")):
        _check_vec(t, shape, x.device, f"bn_act {name}")
    _apply_grid(a, x.device)
    a.x, a.g, a.y = x.data_ptr(), g.data_ptr(), dx.data_ptr()
    a.fvec, a.bias, a.bvec = fvec.data_ptr(), bias.data_ptr(), bvec.data_ptr()
    if gz is not None:
        if g is not gz or a.nchw:
            raise ValueError("bn_act grad_apply: gz must be laid out as a channels-last x")
        a.gz = gz.data_ptr()
    _call("cocodet_bn_act_apply", a, x.device)
    grad_apply.launches += 1
    return dx


def resident_plan(rows: int, c: int, elem: int, backward: bool, *, sms: int, slab_bytes: int,
                  max_cluster: int) -> Optional[Tuple[int, int]]:
    """``(groups, cluster)`` of the resident kernel for a channels-last map
    of ``rows`` rows (N*H*W) and ``c`` channels of ``elem`` bytes, or None:
    the map takes the two passes. A tile is ``groups`` 16-byte groups of
    channels (2: 32 bytes of a row, a whole sector; else 1), a cluster
    ``cluster`` CTAs (at most ``max_cluster``), each an even chunk of the
    rows whose slab (x, and g backward) must fit ``slab_bytes``; an SM
    holds one such CTA. The map takes the resident kernel only where all
    its CTAs run at once (at most ``sms``; a second wave would wait for the
    first's loads and arithmetic in turn) and, forward, where a CTA's slab
    is at most half of ``slab_bytes``: on a 640 px step the two passes were
    faster on every other map (PERF.md §6; the forward's second pass reads
    a map of this size again from L2). The widest tile, and the fewest CTAs
    a cluster that still give half the SMs a CTA (fewer, larger CTAs were
    faster on the small maps). ``c`` must hold whole 16-byte groups."""
    v = 16 // elem
    if c % v:
        return None
    tensors = 2 if backward else 1
    limit = slab_bytes if backward else slab_bytes // 2
    for gt in (2, 1):
        tiles = math.ceil(c / (gt * v))
        fits = [cs for cs in (1, 2, 4, 8, 16)
                if cs <= max_cluster and math.ceil(rows / cs) * gt * 16 * tensors <= limit
                and tiles * cs <= sms]
        if fits:
            half = [cs for cs in fits if 2 * tiles * cs >= sms]
            return gt, half[0] if half else fits[-1]
    return None


@functools.cache
def _resident_limits(device: torch.device) -> Tuple[int, int, int]:
    """(slab bytes a CTA, the largest cluster the card launches with such a
    slab, SMs) of ``device``: its shared memory a block less the kernel's
    scratch, and its SMs."""
    lib = _lib()
    props = torch.cuda.get_device_properties(device)
    slab = props.shared_memory_per_block_optin - lib.cocodet_bn_act_resident_scratch()
    for cs in (16, 8, 4, 2, 1):
        # bf16 backward, 32-byte tiles: a row takes 64 bytes of the slab
        a = _Args(outer=cs * (slab // 64), inner=1, C=16, dtype=1, act=1, backward=1, vec=1,
                  groups=2, grid_x=cs, tiles=1)
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.cocodet_bn_act_resident_clusters(ctypes.byref(a), ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"cocodet_bn_act_resident_clusters: CUDA error {rc}")
        if n.value >= 1:
            return slab, cs, props.multi_processor_count
    raise RuntimeError("no cluster of bn_act_resident_kernel fits the card")


def shape_plan(shape, dtype: torch.dtype, backward: bool, device: torch.device
               ) -> Optional[Tuple[int, int]]:
    """``resident_plan`` of a channels-last (N, C, H, W) map of ``dtype``
    with ``device``'s own numbers (its SMs, shared memory and largest
    cluster)."""
    if dtype not in _DTYPES:
        return None
    slab, max_cluster, sms = _resident_limits(device)
    n, c, h, w = shape
    return resident_plan(n * h * w, c, dtype.itemsize, backward, sms=sms, slab_bytes=slab,
                         max_cluster=max_cluster)


def plan_for(x: torch.Tensor, backward: bool, maps=()) -> Optional[Tuple[int, int]]:
    """The resident plan of map ``x`` on the card (``shape_plan``), or None:
    the two passes. Only a channels-last f32 or bf16 map whose pointers
    (``x`` and ``maps``) are 16-byte aligned has one."""
    if x.device.type != "cuda" or x.dim() != 4 or x.numel() == 0 \
            or not x.is_contiguous(memory_format=torch.channels_last) \
            or any(m.data_ptr() % 16 for m in (x, *maps)):
        return None
    return shape_plan(tuple(x.shape), x.dtype, backward, x.device)


def _resident_args(x: torch.Tensor, maps, backward: bool, act: str, plan, what: str) -> _Args:
    _check_act(act)
    nchw, outer, _ = _check_map(x, what)
    plan = plan_for(x, backward, maps) if plan is None else plan
    c, v = x.shape[1], 16 // x.element_size()
    if nchw or plan is None or c % v or any(m.data_ptr() % 16 for m in maps):
        raise ValueError(f"{what}: the map {tuple(x.shape)} {x.dtype} has no resident plan "
                         f"(channels-last, 16-byte aligned, C a multiple of {v}, a channel "
                         f"tile within a cluster's shared memory): it takes the two passes")
    groups, cluster = plan
    return _Args(outer=outer, inner=1, C=c, dtype=_DTYPES[x.dtype], act=ACTS[act],
                 backward=int(backward), vec=1, nchw=0, groups=groups, grid_x=cluster,
                 tiles=math.ceil(c / (groups * v)))


def resident_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float = 1e-3,
                     momentum: float = 0.03, act: str = "hard_swish", plan=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward in one launch: ``(y, sums, fvec)``, the running
    statistics updated in place; ``plan`` as ``plan_for`` gives it (by
    default ``plan_for(x)``). Raises for a map without one."""
    if x.device.type == "cpu":
        sums, fvec = reduce_plain(x, weight, running_mean, running_var, eps, momentum)
        return apply_plain(x, fvec, bias, act), sums, fvec
    y = torch.empty_like(x)
    a = _resident_args(x, (x, y), False, act, plan, "bn_act resident_forward")
    c = x.shape[1]
    _forward_finish_args(a, weight, running_mean, running_var, eps, momentum, x.device)
    _check_vec(bias, (c,), x.device, "bn_act bias")
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    fvec = torch.empty((4, c), dtype=torch.float32, device=x.device)
    a.x, a.y, a.bias, a.sums, a.vec_out = (x.data_ptr(), y.data_ptr(), bias.data_ptr(),
                                           sums.data_ptr(), fvec.data_ptr())
    _call("cocodet_bn_act_resident", a, x.device)
    resident_forward.launches += 1
    return y, sums, fvec


def resident_backward(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
                      weight: torch.Tensor, count: torch.Tensor, act: str = "hard_swish",
                      plan=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in one launch: ``(dx, gsums, bvec)``; ``plan`` as
    ``plan_for(x, True)`` gives it. Raises for a map without one."""
    if x.device.type == "cpu":
        gsums, bvec = grad_reduce_plain(x, g, fvec, bias, weight, count, act)
        return grad_apply_plain(x, g, fvec, bias, bvec, act), gsums, bvec
    g = _cotangent(x, g)
    dx = torch.empty_like(x)
    a = _resident_args(x, (x, g, dx), True, act, plan, "bn_act resident_backward")
    c = x.shape[1]
    for t, shape, name in ((fvec, (4, c), "fvec"), (bias, (c,), "bias"),
                           (weight, (c,), "weight"), (count, (1,), "count")):
        _check_vec(t, shape, x.device, f"bn_act {name}")
    gsums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    bvec = torch.empty((4, c), dtype=torch.float32, device=x.device)
    a.x, a.g, a.y, a.fvec, a.bias = (x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                     fvec.data_ptr(), bias.data_ptr())
    a.weight, a.count, a.sums, a.vec_out = (weight.data_ptr(), count.data_ptr(),
                                            gsums.data_ptr(), bvec.data_ptr())
    _call("cocodet_bn_act_resident", a, x.device)
    resident_backward.launches += 1
    return dx, gsums, bvec


def forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor, eps: float = 1e-3,
            momentum: float = 0.03, act: str = "hard_swish"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The map's forward, ``(y, sums, fvec)``: the resident kernel where
    ``plan_for`` gives the map a plan, else ``reduce`` then ``apply``; the
    plain stages on the CPU."""
    plan = plan_for(x, False)
    if plan is not None:
        return resident_forward(x, weight, bias, running_mean, running_var, eps, momentum, act,
                                plan)
    sums, fvec = reduce(x, weight, running_mean, running_var, eps, momentum)
    return apply(x, fvec, bias, act), sums, fvec


def backward(x: torch.Tensor, g: torch.Tensor, fvec: torch.Tensor, bias: torch.Tensor,
             weight: torch.Tensor, count: torch.Tensor, act: str = "hard_swish"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The map's backward, ``(dx, gsums, bvec)``, as ``forward`` chooses;
    a cotangent in another layout than ``x`` is copied into it first. The
    two passes of a channels-last map keep ``gz``: the reduce writes it and
    the apply reads it back instead of computing the activation's VJP again
    (the apply's arithmetic, not its bytes, bounded it; on a 640 px step
    2-21% faster on every two-pass map but the 157 MB stem, 4% slower,
    PERF.md §6)."""
    if x.device.type != "cpu":
        g = _cotangent(x, g)
    plan = plan_for(x, True, (g,))
    if plan is not None:
        return resident_backward(x, g, fvec, bias, weight, count, act, plan)
    keep = x.device.type == "cuda" and x.dim() == 4 \
        and x.is_contiguous(memory_format=torch.channels_last)
    gz = torch.empty_like(x) if keep else None
    gsums, bvec = grad_reduce(x, g, fvec, bias, weight, count, act, gz=gz)
    return grad_apply(x, g, fvec, bias, bvec, act, gz), gsums, bvec


WRAPPERS = (reduce, finish, apply, grad_reduce, grad_finish, grad_apply, resident_forward,
            resident_backward)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
