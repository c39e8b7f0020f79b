"""The device-mosaic input pipeline's per-pixel programs as four CUDA kernels.

The kernels are ``cocodet_tpu_torch/csrc/train_aug.cu``; they replace the
XLA programs of the JAX package's device path (``cocodet_tpu/data/
device_mosaic.py`` and ``device_aug.py``), whose header lists them:

- ``mosaic_canvas`` (K1): four raw tiles resized and pasted on the 2x canvas
  (``compose_canvas``), stored as uint8 (its values are integers);
- ``affine_pass`` (K2): one pass of the two-pass affine warp
  (``affine_warp``): pass 1 canvas rows -> an f32 (B, 2ih, iw, 3) map, pass 2
  its columns -> the warped (B, ih, iw, 3) uint8;
- ``mixup`` (K3): the mixup partner's two resamples, the origin select and
  the blend of ``_mosaic_one`` -> the (B, sh, sw, 3) uint8 mid image;
- ``train_aug`` (K4): HSV jitter, flip and letterbox of ``_train_aug_one``
  -> the (B, ih, iw, 3) f32 images of the train step.

Each has a plain version here (``*_plain``), which follows the JAX ops one by
one in f32, item by item: the CPU runs it, and ``chip_smoke.py`` holds the
kernel to it on the card, bit for bit. Divisions are tensor by tensor (a
PyTorch CUDA division by a Python number multiplies by the reciprocal), and
``jnp.remainder``'s sign rule is written out. The label math around the
kernels is plain tensor code in ``data/device_mosaic.py`` and
``data/device_aug.py``.

A wrapper takes the plain version for tensors on the CPU, and only there; on
CUDA tensors it launches its kernel or raises, and counts the launch in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from . import build

_SOURCE = "train_aug"
F32 = torch.float32
BORDER = 114.0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _c(value: float, device) -> torch.Tensor:
    """An f32 0-d tensor on ``device``: divisions by it are IEEE divisions on
    every device."""
    return torch.tensor(float(value), dtype=F32, device=device)


def _pymod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder(x, y)`` for f32: fmod, then + y where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def lin_taps(o: torch.Tensor, scale: torch.Tensor, src_len: int):
    """``_lin_weights``: position o reads src at (o + 0.5) / scale - 0.5; taps
    clamped to [0, max(src_len - 1, 0)]."""
    p = (o + 0.5) / scale - 0.5
    f = torch.floor(p)
    w = (p - f).clamp(0.0, 1.0)
    hi = max(int(src_len) - 1, 0)
    i = f.to(torch.int64)
    return i.clamp(0, hi), (i + 1).clamp(0, hi), w


def _bilinear(img: torch.Tensor, y0, y1, wy, x0, x1, wx) -> torch.Tensor:
    """Rows, then columns, as JAX's separable gathers."""
    rows = img[y0] * (1.0 - wy)[:, None, None] + img[y1] * wy[:, None, None]
    return rows[:, x0] * (1.0 - wx)[None, :, None] + rows[:, x1] * wx[None, :, None]


def letterbox_plain(img: torch.Tensor, h: int, w: int, out_size: Tuple[int, int],
                    nh: int, nw: int) -> torch.Tensor:
    """``letterbox_resize_one`` with host extents ``(nh, nw)``: ``img`` (sh,
    sw, 3) f32 with true size (h, w) -> (oh, ow, 3) f32, 114 outside."""
    oh, ow = out_size
    dev = img.device
    y0, y1, wy = lin_taps(torch.arange(oh, dtype=F32, device=dev), _c(nh, dev) / _c(h, dev), h)
    x0, x1, wx = lin_taps(torch.arange(ow, dtype=F32, device=dev), _c(nw, dev) / _c(w, dev), w)
    out = _bilinear(img, y0, y1, wy, x0, x1, wx)
    live = ((torch.arange(oh, device=dev) < nh)[:, None]
            & (torch.arange(ow, device=dev) < nw)[None, :])
    return torch.where(live[..., None], out, BORDER)


def tile_rects(yc: int, xc: int, nhw: Sequence[Sequence[int]], ih: int, iw: int):
    """``_tile_rects`` of one item, in integers: per tile (x1, y1, x2, y2, padw,
    padh) on the 2x canvas."""
    nh = [v[0] for v in nhw]
    nw = [v[1] for v in nhw]
    x1 = [max(xc - nw[0], 0), xc, max(xc - nw[2], 0), xc]
    y1 = [max(yc - nh[0], 0), max(yc - nh[1], 0), yc, yc]
    x2 = [xc, min(xc + nw[1], 2 * iw), xc, min(xc + nw[3], 2 * iw)]
    y2 = [yc, yc, min(2 * ih, yc + nh[2]), min(2 * ih, yc + nh[3])]
    sx1 = [nw[0] - (x2[0] - x1[0]), 0, nw[2] - (x2[2] - x1[2]), 0]
    sy1 = [nh[0] - (y2[0] - y1[0]), nh[1] - (y2[1] - y1[1]), 0, 0]
    return [(x1[t], y1[t], x2[t], y2[t], x1[t] - sx1[t], y1[t] - sy1[t]) for t in range(4)]


def mosaic_canvas_plain(tiles: torch.Tensor, hw5: torch.Tensor, nhw5: torch.Tensor,
                        yc: torch.Tensor, xc: torch.Tensor,
                        out_size: Tuple[int, int]) -> torch.Tensor:
    """``compose_canvas`` for a batch: (B, 2ih, 2iw, 3) uint8. Each tile is
    sampled on its own rectangle only (the rectangles are disjoint, so this is
    JAX's where chain)."""
    ih, iw = out_size
    dev = tiles.device
    out = []
    for b, (hw, nhw, y, x) in enumerate(zip(hw5.tolist(), nhw5.tolist(), yc.tolist(),
                                            xc.tolist())):
        canvas = torch.full((2 * ih, 2 * iw, 3), BORDER, dtype=F32, device=dev)
        for t, (x1, y1, x2, y2, padw, padh) in enumerate(tile_rects(y, x, nhw[:4], ih, iw)):
            if y2 <= y1 or x2 <= x1:
                continue
            (h0, w0), (nh, nw) = hw[t], nhw[t]
            v = torch.arange(y1, y2, dtype=F32, device=dev) - _c(padh, dev)
            u = torch.arange(x1, x2, dtype=F32, device=dev) - _c(padw, dev)
            ys = lin_taps(v, _c(nh, dev) / _c(h0, dev), h0)
            xs = lin_taps(u, _c(nw, dev) / _c(w0, dev), w0)
            canvas[y1:y2, x1:x2] = _bilinear(tiles[b, t].to(F32), *ys, *xs)
        out.append(torch.round(canvas.clamp(0.0, 255.0)).to(torch.uint8))
    return torch.stack(out)


def _warp_terms(m: torch.Tensor):
    """The f32 inverse-matrix terms of ``affine_warp``: (1 / safe_m00,
    safe_m00, c, d) and the row m."""
    m00, m01, m02, m10, m11, m12 = m.unbind()
    dev = m.device
    det = m00 * m11 - m01 * m10
    safe_det = torch.where(det.abs() < 1e-6, _c(1e-6, dev), det)
    safe_m00 = torch.where(m00.abs() < 1e-3, _c(1e-3, dev), m00)
    return _c(1.0, dev) / safe_m00, safe_m00, -m10 / safe_det, m00 / safe_det


def warp_taps(m: torch.Tensor, out_size: Tuple[int, int], pass_: int):
    """The taps of one pass of ``affine_warp`` for one item's forward matrix
    ``m`` (6,) f32, as ``_shift_scale_pass`` computes them: line r is
    resampled at scale * j + offsets[r]; returns the lower tap i0 (lines,
    positions) int64 and its weight w f32. Pass 1: the canvas's 2ih rows at
    iw positions; pass 2: H's iw columns at ih positions."""
    ih, iw = out_size
    dev = m.device
    inv_m00, safe_m00, c, d = _warp_terms(m)
    if pass_ == 1:
        scale, n = inv_m00, iw
        offsets = (-m[2] - m[1] * torch.arange(2 * ih, dtype=F32, device=dev)) / safe_m00
    elif pass_ == 2:
        scale, n = d, ih
        offsets = c * (torch.arange(iw, dtype=F32, device=dev) - m[2]) - d * m[5]
    else:
        raise ValueError(f"pass_ is 1 or 2, got {pass_}")
    q = scale * torch.arange(n, dtype=F32, device=dev)
    qf = torch.floor(q)
    fq = q - qf
    of = torch.floor(offsets)
    fo = offsets - of
    s = fq[None, :] + fo[:, None]
    carry = s >= 1.0
    w = s - carry.to(F32)
    i0 = of.to(torch.int64)[:, None] + qf.to(torch.int64)[None, :] + carry.to(torch.int64)
    return i0, w


def _shift_scale_pass(img: torch.Tensor, i0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_shift_scale_pass``: row r of ``img`` (R, C, 3) f32 resampled at the
    taps of ``warp_taps``; a tap outside [0, C - 1] reads 114. In range JAX's
    doubled-row roll reads img[r, i0], indexed directly here."""
    R, C = img.shape[:2]
    rows = torch.arange(R, device=img.device)[:, None]
    lo = torch.where(((i0 >= 0) & (i0 <= C - 1))[..., None], img[rows, i0.clamp(0, C - 1)],
                     BORDER)
    hi = torch.where(((i0 + 1 >= 0) & (i0 + 1 <= C - 1))[..., None],
                     img[rows, (i0 + 1).clamp(0, C - 1)], BORDER)
    return lo * (1.0 - w)[..., None] + hi * w[..., None]


def affine_pass_plain(inp: torch.Tensor, m6: torch.Tensor, out_size: Tuple[int, int],
                      pass_: int) -> torch.Tensor:
    """One pass of ``affine_warp`` for a batch. Pass 1: canvas (B, 2ih, 2iw, 3)
    uint8 -> H (B, 2ih, iw, 3) f32, unrounded; pass 2: H -> (B, ih, iw, 3)
    uint8, round(clip(., 0, 255)) of its column resample."""
    out = []
    for b in range(inp.shape[0]):
        i0, w = warp_taps(m6[b], out_size, pass_)
        if pass_ == 1:
            out.append(_shift_scale_pass(inp[b].to(F32), i0, w))
        else:
            res = _shift_scale_pass(inp[b].transpose(0, 1), i0, w).transpose(0, 1)
            out.append(torch.round(res.clamp(0.0, 255.0)).to(torch.uint8))
    return torch.stack(out).contiguous()


def mixup_plain(tiles: torch.Tensor, hw5: torch.Tensor, nhw5: torch.Tensor,
                warped: torch.Tensor, mrand: torch.Tensor,
                out_size: Tuple[int, int]) -> torch.Tensor:
    """``_mixup_partner`` and the origin select and blend of ``_mosaic_one``:
    (B, sh, sw, 3) uint8."""
    ih, iw = out_size
    sh, sw = tiles.shape[2:4]
    dev = tiles.device
    out = []
    for b, (hw, nhw, mr) in enumerate(zip(hw5.tolist(), nhw5.tolist(), mrand.tolist())):
        use_mosaic = mr[0] > 0
        if use_mosaic:
            mid = torch.full((sh, sw, 3), BORDER, dtype=F32, device=dev)
            mid[:ih, :iw] = warped[b].to(F32)
            oh, ow = ih, iw
        else:
            mid = tiles[b, 0].to(F32)
            oh, ow = hw[0]
        if mr[9] > 0:
            cp_img = torch.round(letterbox_plain(tiles[b, 4].to(F32), *hw[4], (ih, iw), *nhw[4]))
            tw2, th2 = int(mr[14]), int(mr[15])
            yy = torch.arange(sh, dtype=F32, device=dev) + mrand[b, 13]
            xx = torch.arange(sw, dtype=F32, device=dev) + mrand[b, 12]
            if mr[11] > 0:
                xx = _c(tw2 - 1, dev) - xx
            live = (((yy < th2) & (torch.arange(sh, device=dev) < oh))[:, None]
                    & ((xx >= 0) & (xx < tw2) & (torch.arange(sw, device=dev) < ow))[None, :])
            ys = lin_taps(yy, _c(th2, dev) / _c(ih, dev), ih)
            xs = lin_taps(xx, _c(tw2, dev) / _c(iw, dev), iw)
            cp = torch.where(live[..., None], torch.round(_bilinear(cp_img, *ys, *xs)), BORDER)
            mid = torch.floor(0.5 * mid + 0.5 * cp)
        out.append(mid.to(torch.uint8))
    return torch.stack(out)


def hsv_jitter_plain(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """``hsv_jitter`` (with ``bgr_to_hsv`` and ``hsv_to_bgr``) of a (..., 3)
    f32 BGR image by truncated ``gains`` (3,)."""
    dev = img.device
    b, g, r = img.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(v == r, (g - b) / safe * 30.0,
                    torch.where(v == g, (b - r) / safe * 30.0 + 60.0,
                                (r - g) / safe * 30.0 + 120.0))
    h = torch.where(diff > 0, _pymod(h, 180.0), 0.0)
    s = torch.where(v > 0, diff / torch.where(v > 0, v, 1.0) * 255.0, 0.0)
    h = _pymod(h + gains[0], 180.0)
    s = (s + gains[1]).clamp(0.0, 255.0)
    v = (v + gains[2]).clamp(0.0, 255.0)
    h6 = h / _c(30.0, dev)
    c = v * (s / _c(255.0, dev))
    x = c * (1.0 - (_pymod(h6, 2.0) - 1.0).abs())
    m = v - c
    sector = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    zero = torch.zeros_like(c)

    def select(c0, c1, c2, c3, c4, default):
        out = default
        for k, val in reversed(list(enumerate((c0, c1, c2, c3, c4)))):
            out = torch.where(sector == k, val, out)
        return out

    rr = select(c, x, zero, zero, x, c)
    gg = select(x, c, c, x, zero, zero)
    bb = select(zero, zero, x, c, c, x)
    out = torch.stack([bb + m, gg + m, rr + m], dim=-1)
    return torch.round(out).clamp(0.0, 255.0)


def train_aug_plain(img: torch.Tensor, hw: torch.Tensor, nhw: torch.Tensor,
                    gains: torch.Tensor, flip: torch.Tensor, fallback: torch.Tensor,
                    out_size: Tuple[int, int]) -> torch.Tensor:
    """The pixels of ``_train_aug_one`` for a batch: (B, ih, iw, 3) f32."""
    sw = img.shape[2]
    dev = img.device
    out = []
    for b, ((h, w), (nh, nw), fl, fb) in enumerate(zip(hw.tolist(), nhw.tolist(),
                                                       flip.tolist(), fallback.tolist())):
        use = img[b].to(F32)
        if not fb:
            use = hsv_jitter_plain(use, gains[b])
            if fl:
                use = use[:, (w - 1 - torch.arange(sw, device=dev)).clamp(0, sw - 1)]
        out.append(letterbox_plain(use, h, w, out_size, nh, nw))
    return torch.stack(out)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cocodet_mosaic_canvas.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.cocodet_affine_pass.argtypes = [p, p, p, i, i, i, i, p]
    lib.cocodet_mixup.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.cocodet_train_aug.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.cocodet_mosaic_canvas, lib.cocodet_affine_pass, lib.cocodet_mixup,
               lib.cocodet_train_aug):
        fn.restype = i
    return lib


def _check(what: str, device: torch.device, **tensors) -> None:
    want = {torch.uint8, torch.int32, torch.float32}
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype or dtype not in want:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _run(what: str, fn, args: List, device: torch.device) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def mosaic_canvas(tiles: torch.Tensor, hw5: torch.Tensor, nhw5: torch.Tensor,
                  yc: torch.Tensor, xc: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """K1: tiles (B, 5, sh, sw, 3) uint8, hw5/nhw5 (B, 5, 2) int32, yc/xc (B,)
    int32 -> the (B, 2ih, 2iw, 3) uint8 mosaic canvas."""
    if tiles.device.type == "cpu":
        return mosaic_canvas_plain(tiles, hw5, nhw5, yc, xc, out_size)
    B, _, sh, sw, _ = tiles.shape
    ih, iw = out_size
    _check("mosaic_canvas", tiles.device, tiles=(tiles, torch.uint8, (B, 5, sh, sw, 3)),
           hw5=(hw5, torch.int32, (B, 5, 2)), nhw5=(nhw5, torch.int32, (B, 5, 2)),
           yc=(yc, torch.int32, (B,)), xc=(xc, torch.int32, (B,)))
    canvas = torch.empty((B, 2 * ih, 2 * iw, 3), dtype=torch.uint8, device=tiles.device)
    _run("mosaic_canvas", _lib().cocodet_mosaic_canvas,
         [tiles.data_ptr(), hw5.data_ptr(), nhw5.data_ptr(), yc.data_ptr(), xc.data_ptr(),
          canvas.data_ptr(), B, sh, sw, ih, iw], tiles.device)
    mosaic_canvas.launches += 1
    return canvas


def affine_pass(inp: torch.Tensor, m6: torch.Tensor, out_size: Tuple[int, int],
                pass_: int) -> torch.Tensor:
    """K2: pass 1 canvas (B, 2ih, 2iw, 3) uint8 -> (B, 2ih, iw, 3) f32; pass 2
    that map -> (B, ih, iw, 3) uint8. ``m6``: (B, 6) f32 forward matrices."""
    if inp.device.type == "cpu":
        return affine_pass_plain(inp, m6, out_size, pass_)
    ih, iw = out_size
    B = inp.shape[0]
    if pass_ == 1:
        in_dtype, in_shape, out_dtype, out_shape = (torch.uint8, (B, 2 * ih, 2 * iw, 3), F32,
                                                    (B, 2 * ih, iw, 3))
    elif pass_ == 2:
        in_dtype, in_shape, out_dtype, out_shape = (F32, (B, 2 * ih, iw, 3), torch.uint8,
                                                    (B, ih, iw, 3))
    else:
        raise ValueError(f"pass_ is 1 or 2, got {pass_}")
    _check("affine_pass", inp.device, inp=(inp, in_dtype, in_shape), m6=(m6, F32, (B, 6)))
    out = torch.empty(out_shape, dtype=out_dtype, device=inp.device)
    _run("affine_pass", _lib().cocodet_affine_pass,
         [inp.data_ptr(), out.data_ptr(), m6.data_ptr(), pass_, B, ih, iw], inp.device)
    affine_pass.launches += 1
    return out


def mixup(tiles: torch.Tensor, hw5: torch.Tensor, nhw5: torch.Tensor, warped: torch.Tensor,
          mrand: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """K3: -> the (B, sh, sw, 3) uint8 mid image (mosaic or tile 0, blended
    with the mixup partner where mrand[:, 9] > 0)."""
    if tiles.device.type == "cpu":
        return mixup_plain(tiles, hw5, nhw5, warped, mrand, out_size)
    B, _, sh, sw, _ = tiles.shape
    ih, iw = out_size
    _check("mixup", tiles.device, tiles=(tiles, torch.uint8, (B, 5, sh, sw, 3)),
           hw5=(hw5, torch.int32, (B, 5, 2)), nhw5=(nhw5, torch.int32, (B, 5, 2)),
           warped=(warped, torch.uint8, (B, ih, iw, 3)), mrand=(mrand, F32, (B, 16)))
    mid = torch.empty((B, sh, sw, 3), dtype=torch.uint8, device=tiles.device)
    _run("mixup", _lib().cocodet_mixup,
         [tiles.data_ptr(), hw5.data_ptr(), nhw5.data_ptr(), warped.data_ptr(),
          mrand.data_ptr(), mid.data_ptr(), B, sh, sw, ih, iw], tiles.device)
    mixup.launches += 1
    return mid


def train_aug(img: torch.Tensor, hw: torch.Tensor, nhw: torch.Tensor, gains: torch.Tensor,
              flip: torch.Tensor, fallback: torch.Tensor,
              out_size: Tuple[int, int]) -> torch.Tensor:
    """K4: img (B, sh, sw, 3) uint8, hw/nhw (B, 2) int32, truncated gains (B,
    3) f32, flip/fallback (B,) int32 -> (B, ih, iw, 3) f32."""
    if img.device.type == "cpu":
        return train_aug_plain(img, hw, nhw, gains, flip, fallback, out_size)
    B, sh, sw, _ = img.shape
    ih, iw = out_size
    _check("train_aug", img.device, img=(img, torch.uint8, (B, sh, sw, 3)),
           hw=(hw, torch.int32, (B, 2)), nhw=(nhw, torch.int32, (B, 2)),
           gains=(gains, F32, (B, 3)), flip=(flip, torch.int32, (B,)),
           fallback=(fallback, torch.int32, (B,)))
    out = torch.empty((B, ih, iw, 3), dtype=F32, device=img.device)
    _run("train_aug", _lib().cocodet_train_aug,
         [img.data_ptr(), hw.data_ptr(), nhw.data_ptr(), gains.data_ptr(), flip.data_ptr(),
          fallback.data_ptr(), out.data_ptr(), B, sh, sw, ih, iw], img.device)
    train_aug.launches += 1
    return out


WRAPPERS = (mosaic_canvas, affine_pass, mixup, train_aug)
PLAIN = {mosaic_canvas: mosaic_canvas_plain, affine_pass: affine_pass_plain,
         mixup: mixup_plain, train_aug: train_aug_plain}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()
