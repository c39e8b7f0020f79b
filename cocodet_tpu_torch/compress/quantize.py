"""Post-training int8 quantization (cocodet_tpu/compress/quantize.py:38-364).

1. ``calibrate``: run batches through a model built with ``quant="calib"``;
   every quantizable conv max-reduces its per-input-channel input absmax
   (models/blocks.py Conv2d). Returns the ``quant_stats`` tree.
2. ``build_quant_tree``: the stats -> per-conv ``act_scale`` (absmax / 127),
   a scalar, or a (cin,) vector with ``per_channel_act``.
3. ``quantize_weights``: per-out-channel symmetric int8 kernels, with a
   per-channel ``act_scale`` folded into the kernel first; biases stay
   float.
4. ``quantize_model``: the three in one call; the result loads into a model
   built with ``quant="w8a8"``.

Scope: the fused topology's ConvBnAct convs (backbone, FPN, head towers).
The head prediction convs stay float. The weight math is numpy, step for
step the JAX package's, so on the same statistics it is bit-equal.

w4a8 checkpoints (:228-310): ``pack_int4_tree`` stores the int4-grid
kernels two nibbles a byte, ``unpack_int4_tree`` (run by
``utils/checkpoint.py::load_checkpoint``) restores the int8 arrays, which
serve through the int8 conv as any w8a8 model's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.convert import flatten_tree, load_variables, unflatten_tree

_STATS = "act_absmax"


def calibrate(model: nn.Module, variables: Mapping[str, Any],
              batches: Iterable) -> Dict[str, Any]:
    """Load ``variables`` into a ``quant="calib"`` model, run the batches of
    NHWC images through it, and return the ``quant_stats`` tree
    ``{scope...: {"act_absmax": (cin,) f32}}``: each conv's input absmax per
    channel, max-reduced over the batches."""
    load_variables(model, variables)
    device = next(model.parameters()).device
    stats = {name: buf for name, buf in model.named_buffers() if name.endswith(_STATS)}
    for buf in stats.values():
        buf.zero_()
    n = 0
    with torch.no_grad():
        for images in batches:
            if not isinstance(images, torch.Tensor):
                images = torch.from_numpy(np.asarray(images, np.float32))
            model(images.to(device, torch.float32))
            n += 1
    if n == 0:
        raise ValueError("calibrate needs at least one batch")
    return unflatten_tree({tuple(name.split(".")): buf.cpu().numpy().copy()
                           for name, buf in stats.items()})


def build_quant_tree(stats: Mapping[str, Any], per_channel_act: bool = False) -> Dict:
    """quant_stats (per-input-channel absmax vectors) -> ``quant`` tree with
    per-conv ``act_scale`` leaves: the scalar max(absmax) / 127, or with
    ``per_channel_act`` the (cin,) vector. The Focus stem stays per-tensor
    in either mode: its input is the raw image (cocodet_tpu/compress/
    quantize.py:77-89)."""
    out = {}
    for path, val in flatten_tree(stats).items():
        if path[-1] != _STATS:
            continue
        absmax = np.asarray(val, np.float32)
        if absmax.ndim > 1:  # collapse any stacked leading axis
            absmax = absmax.max(axis=tuple(range(absmax.ndim - 1)))
        scope = path[:-1]
        is_focus_stem = scope[:3] == ("backbone", "backbone", "stem")
        if per_channel_act and absmax.ndim and not is_focus_stem:
            out[scope + ("act_scale",)] = np.asarray(
                np.maximum(absmax, 1e-8) / 127.0, np.float32)
        else:
            out[scope + ("act_scale",)] = np.float32(
                max(float(np.max(absmax)), 1e-8) / 127.0)
    return unflatten_tree(out)


def _mse_clip_scales(kernel: np.ndarray, absmax: np.ndarray, qmax: int,
                     grid=tuple(np.linspace(0.3, 1.0, 29))) -> np.ndarray:
    """Per-out-channel scale c * absmax / qmax minimizing the quantization
    MSE over the clip grid (for int4, where plain absmax loses the bulk)."""
    flat = kernel.reshape(-1, kernel.shape[-1])            # (N, cout)
    best_scale = np.maximum(absmax, 1e-8) / qmax
    q = np.clip(np.round(flat / best_scale), -qmax, qmax)
    best_err = ((flat - q * best_scale) ** 2).sum(axis=0)
    for c in grid[:-1]:                                    # 1.0 == absmax
        s = np.maximum(absmax * c, 1e-8) / qmax
        q = np.clip(np.round(flat / s), -qmax, qmax)
        e = ((flat - q * s) ** 2).sum(axis=0)
        better = e < best_err
        best_scale = np.where(better, s, best_scale)
        best_err = np.where(better, e, best_err)
    return best_scale


def quantize_weights(variables: Mapping[str, Any], quant_tree: Mapping[str, Any],
                     bits: int = 8, clip_search: bool = None,
                     w8_keep_patterns: Tuple[str, ...] = (),
                     w8_keep_frac: float = 0.0) -> Tuple[Dict, Dict]:
    """Per-out-channel symmetric int-``bits`` quantization of every conv
    kernel that has an ``act_scale``. Returns (variables with int8 kernels,
    quant tree with ``w_scale`` and ``act_scale``).

    ``bits=4`` narrows the grid to [-7, 7] and keeps the int8 runtime type;
    ``clip_search`` (default: on for bits=4) takes MSE-optimal clip scales;
    ``w8_keep_patterns`` and ``w8_keep_frac`` keep some convs on the int8
    grid (by name, and the given fraction with the worst int4 error), and
    each conv's width goes into a ``w_bits`` leaf."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if clip_search is None:
        clip_search = bits == 4

    frac_keep: set = set()
    if bits == 4 and w8_keep_frac > 0.0:
        flat0 = flatten_tree(variables["params"])
        qflat0 = flatten_tree(quant_tree)
        rel_err = {}
        for path in qflat0:
            if path[-1] != "act_scale":
                continue
            kpath = path[:-1] + ("kernel",)
            k = np.asarray(flat0[kpath], np.float32)
            # rank on the folded kernel, the tensor the main loop quantizes
            a = np.asarray(qflat0[path], np.float32)
            if a.ndim and k.shape[2] != a.shape[0]:
                a = a.max()  # grouped/depthwise: per-tensor collapse
            if a.ndim:
                k = k * a[None, None, :, None]
            absmax = np.maximum(np.abs(k).max(axis=(0, 1, 2)), 1e-8)
            s = (_mse_clip_scales(k, absmax, 7) if clip_search
                 else absmax / 7.0)
            q = np.clip(np.round(k.reshape(-1, k.shape[-1]) / s), -7, 7)
            err = ((k.reshape(-1, k.shape[-1]) - q * s) ** 2).sum()
            rel_err[kpath] = float(err / max((k ** 2).sum(), 1e-12))
        n_keep = int(round(len(rel_err) * w8_keep_frac))
        frac_keep = set(sorted(rel_err, key=rel_err.get)[-n_keep:]
                        if n_keep else [])

    params = dict(flatten_tree(variables["params"]))
    qflat = dict(flatten_tree(quant_tree))
    for path in list(qflat):
        if path[-1] != "act_scale":
            continue
        scope = path[:-1]  # ends with (..., "conv")
        kpath = scope + ("kernel",)
        name = "/".join(kpath)
        keep8 = bits == 4 and (
            any(pat in name for pat in w8_keep_patterns)
            or kpath in frac_keep)
        qmax = 127 if (bits == 8 or keep8) else 7
        kbits = 8 if (bits == 8 or keep8) else 4
        kernel = np.asarray(params[kpath], np.float32)
        a_scale = np.asarray(qflat[path], np.float32)
        if a_scale.ndim and kernel.shape[2] != a_scale.shape[0]:
            # grouped/depthwise conv: the kernel's cin axis is cin/groups, so
            # a per-channel fold does not factor: collapse to per-tensor
            a_scale = a_scale.max()
            qflat[path] = np.float32(a_scale)
        if a_scale.ndim:
            # fold the per-channel activation scale into the kernel before
            # the per-cout quantization: conv(x/s_c, W*s_c) == conv(x, W)
            kernel = kernel * a_scale[None, None, :, None]
        absmax = np.abs(kernel).max(axis=(0, 1, 2))  # per out channel
        if clip_search and kbits == 4:
            w_scale = _mse_clip_scales(kernel, absmax, qmax)
        else:
            w_scale = np.maximum(absmax, 1e-8) / qmax
        q = np.clip(np.round(kernel / w_scale), -qmax, qmax).astype(np.int8)
        params[kpath] = q
        qflat[scope + ("w_scale",)] = np.asarray(w_scale, np.float32)
        if bits == 4:
            qflat[scope + ("w_bits",)] = np.int32(kbits)
    new_vars = dict(variables)
    new_vars["params"] = unflatten_tree(params)
    return new_vars, unflatten_tree(qflat)


def quantize_model(calib_model: nn.Module, variables: Mapping[str, Any],
                   calib_batches: Iterable, per_channel_act: bool = False,
                   bits: int = 8, clip_search: bool = None,
                   w8_keep_patterns: Tuple[str, ...] = (),
                   w8_keep_frac: float = 0.0) -> Dict:
    """One-call PTQ: calibrate ``calib_model`` (built with quant="calib") on
    ``variables``, quantize the weights, and return the variable tree
    (params with int8 kernels + the ``quant`` tree) for a model built with
    quant="w8a8"."""
    stats = calibrate(calib_model, variables, calib_batches)
    qtree = build_quant_tree(stats, per_channel_act=per_channel_act)
    qvars, quant = quantize_weights(variables, qtree, bits=bits,
                                    clip_search=clip_search,
                                    w8_keep_patterns=w8_keep_patterns,
                                    w8_keep_frac=w8_keep_frac)
    qvars["quant"] = quant
    return qvars


def quantization_report(variables: Mapping[str, Any], bits: int = 8) -> Dict[str, Any]:
    """Byte accounting of quantized vs float parameters. ``bits`` is the
    storage width of the int8 kernels (4 when packed two a byte, with the
    int32 shape leaf per kernel); per-conv ``w_bits`` leaves override it."""
    flat = flatten_tree(variables["params"])
    kernel_bits = {}
    if "quant" in variables:
        for p, v in flatten_tree(variables["quant"]).items():
            if p[-1] == "w_bits":
                kernel_bits[p[:-1] + ("kernel",)] = int(v)

    def leaf_bytes(path, v):
        b = kernel_bits.get(path, bits)
        return (int(np.prod(v.shape)) * b + 7) // 8 \
            + (4 * v.ndim if b == 4 else 0)

    flat = {p: np.asarray(v) for p, v in flat.items()}
    int8_bytes = sum(leaf_bytes(p, v) for p, v in flat.items()
                     if v.dtype == np.int8)
    float_bytes = sum(int(np.prod(v.shape)) * 4 for v in flat.values()
                      if v.dtype != np.int8)
    n_q = sum(1 for v in flat.values() if v.dtype == np.int8)
    return {"quantized_convs": n_q,
            "weight_bits": bits,
            "int8_bytes": int8_bytes,
            "float_bytes": float_bytes,
            "total_mb": (int8_bytes + float_bytes) / 2**20}


INT4_DATA = "__int4_packed__"
INT4_SHAPE = "__int4_shape__"


def pack_int4_tree(params: Mapping[str, Any], kernel_paths=None) -> Dict:
    """Pack int4-grid kernels two values a byte (quantize.py:232-276): each
    packed leaf becomes ``{INT4_DATA: uint8[ceil(n/2)], INT4_SHAPE:
    int32[ndim]}``, the even flat index in the low nibble (two's
    complement), an odd count padded with a zero nibble. ``kernel_paths``
    (flat path tuples) declares the packed leaves, which must be int8 in
    [-8, 7]; without it every int8 leaf whose values fit [-8, 7] packs."""
    out = {}
    for path, leaf in flatten_tree(params).items():
        arr = np.asarray(leaf)
        fits = arr.dtype == np.int8 and (not arr.size or (arr.min() >= -8 and arr.max() <= 7))
        if kernel_paths is not None:
            packable = path in kernel_paths
            if packable and not fits:
                raise ValueError(f"pack_int4_tree: {'/'.join(map(str, path))} was declared "
                                 "int4 but is not a nibble-range int8 leaf")
        else:
            packable = fits and arr.size
        if packable and arr.size:
            v = arr.ravel()
            if v.size % 2:
                v = np.concatenate([v, np.zeros(1, np.int8)])
            nib = v.astype(np.uint8) & 0xF
            out[path + (INT4_DATA,)] = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
            out[path + (INT4_SHAPE,)] = np.asarray(arr.shape, np.int32)
        else:
            out[path] = leaf
    return unflatten_tree(out)


def unpack_int4_tree(tree: Mapping[str, Any]) -> Dict:
    """The inverse of ``pack_int4_tree`` (quantize.py:279-306): int8 arrays,
    each nibble sign-extended, at every packed node; other leaves pass
    through. A data leaf without its shape, or a shape without its data,
    raises JAX's ``ValueError``."""
    flat = flatten_tree(tree)
    out = {}
    for path, leaf in flat.items():
        where = "/".join(map(str, path[:-1]))
        if path[-1] == INT4_SHAPE:
            if path[:-1] + (INT4_DATA,) not in flat:
                raise ValueError(f"corrupt int4-packed checkpoint: orphan {INT4_SHAPE} at "
                                 f"{where} (no {INT4_DATA} sibling)")
            continue
        if path[-1] != INT4_DATA:
            out[path] = leaf
            continue
        spath = path[:-1] + (INT4_SHAPE,)
        if spath not in flat:
            raise ValueError(f"corrupt int4-packed checkpoint: {where} has {INT4_DATA} but "
                             f"no {INT4_SHAPE} sibling (truncated save?)")
        shape = tuple(int(s) for s in np.asarray(flat[spath]))
        packed = np.asarray(leaf, np.uint8)
        nib = np.empty(packed.size * 2, np.uint8)
        nib[0::2] = packed & 0xF
        nib[1::2] = packed >> 4
        v = ((nib ^ 8).astype(np.int16) - 8).astype(np.int8)
        out[path[:-1]] = v[:int(np.prod(shape)) if shape else 1].reshape(shape)
    return unflatten_tree(out)


def tree_has_int4(tree: Mapping[str, Any]) -> bool:
    return any(path[-1] == INT4_DATA for path in flatten_tree(tree))


def int4_kernel_paths(quant: Mapping[str, Any]) -> set:
    """The kernels ``quantize_weights(bits=4)`` put on the int4 grid: those
    whose conv has ``w_bits`` 4 (tools/quantize_model.py:170-175)."""
    return {p[:-1] + ("kernel",) for p, v in flatten_tree(quant).items()
            if p[-1] == "w_bits" and int(v) == 4}
