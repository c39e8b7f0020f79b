"""Mosaic, random affine and mixup on the card (cocodet_tpu/data/
device_mosaic.py).

The host keeps image decode and every random draw: ``DeviceMosaicDataset.
fetch`` pulls the four mosaic tiles and the mixup partner raw and draws in
the exact call order of the JAX package (and of its host path), so one
seeded ``random.Random`` per item gives the same augmentation; the host
derives the affine matrix, the mosaic centre, the mixup offsets and every
resized extent in f64 and ships them in a dense vector (``mrand``) and
``nhw5``, so that no f32 floor on the card can land a pixel off.
``make_mosaic_collate`` packs the items into static uint8 buffers.

On the card, ``mosaic_mixup_batch`` runs the per-pixel work as three CUDA
kernels (``ops/cuda/train_aug.py``: the canvas, the warp with both of its
passes in one launch, the mixup) and the label math as plain tensor ops with
no host sync: the
tile shifts, ``affine_boxes``, ``_mixup_boxes`` and the stable
front-compaction of ``_mosaic_one``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops.cuda import train_aug as kernels

# per-item mosaic/mixup parameter vector (device_mosaic.py:57-69):
#   [0] use_mosaic, [1:3] yc, xc (int()'d), [3:9] the affine m row-major,
#   [9] use_mixup, [10] mixup jit scale, [11] mixup flip, [12:14] x_off,
#   y_off (int()'d), [14:16] tw2, th2 = int(iw*jit), int(ih*jit) in host f64
N_MOSAIC_RANDOMS = 16


def get_affine_params(target_size: Tuple[int, int], degrees, translate, scales, shear,
                      rng) -> np.ndarray:
    """transforms.get_affine_matrix's draws (angle, scale, shear_x, shear_y,
    tx, ty, in that order) and its f64 matrix, as the flat [m00 m01 m02 m10
    m11 m12] (device_mosaic.py:72-101)."""

    def _rand(value, center=0.0):
        if isinstance(value, (int, float)):
            return rng.uniform(center - value, center + value)
        return rng.uniform(value[0], value[1])

    tw, th = target_size
    angle = _rand(degrees)
    scale = _rand(scales, center=1.0)
    if scale <= 0.0:
        raise ValueError("scale must be positive")
    rad = math.radians(angle)
    alpha, beta = scale * math.cos(rad), scale * math.sin(rad)
    rot = np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])
    shear_x = math.tan(_rand(shear) * math.pi / 180)
    shear_y = math.tan(_rand(shear) * math.pi / 180)
    m = np.ones((2, 3))
    m[0] = rot[0] + shear_y * rot[1]
    m[1] = rot[1] + shear_x * rot[0]
    m[0, 2] = _rand(translate) * tw
    m[1, 2] = _rand(translate) * th
    return m.reshape(6).astype(np.float64)


class DeviceMosaicDataset:
    """The host side of the device-mosaic path (device_mosaic.py:445-574):
    ``fetch`` returns (tiles[5], hws[5], nhw (5, 2), targets[5], mrand,
    tt_randoms, info, img_id)."""

    def __init__(self, dataset, img_size: Tuple[int, int], degrees: float = 10.0,
                 translate: float = 0.1, mosaic_scale=(0.5, 1.5), mixup_scale=(0.5, 1.5),
                 shear: float = 2.0, enable_mixup: bool = True, mosaic_prob: float = 1.0,
                 mixup_prob: float = 1.0, mosaic: bool = True, hsv_prob: float = 1.0,
                 rng=None):
        import random as _random

        self._dataset = dataset
        self.rng = rng or _random
        self.input_dim = tuple(img_size)
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.mixup_scale = mixup_scale
        self.shear = shear
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.hsv_prob = hsv_prob

    def __len__(self):
        return len(self._dataset)

    def close_mosaic(self):
        self.enable_mosaic = False
        self.enable_mixup = False

    def _ann_count(self, idx: int) -> int:
        return len(self._dataset.annotations[idx][0])

    def fetch(self, index, rng=None):
        from .device_aug import draw_randoms

        rng = rng or self.rng
        if isinstance(index, tuple):
            self.enable_mosaic, index = index
        ih, iw = self.input_dim
        mrand = np.zeros((N_MOSAIC_RANDOMS,), np.float32)
        tiles, hws, targets = [], [], []

        use_mosaic = self.enable_mosaic and rng.random() < self.mosaic_prob
        if use_mosaic:
            mrand[0] = 1.0
            mrand[1] = int(rng.uniform(0.5 * ih, 1.5 * ih))
            mrand[2] = int(rng.uniform(0.5 * iw, 1.5 * iw))
            indices = [index] + [rng.randint(0, len(self._dataset) - 1) for _ in range(3)]
            img_info, img_id = (ih, iw), None
            for pos, idx in enumerate(indices):
                img, labels, info, iid = self._dataset.pull_item(idx)
                if pos == 0:
                    img_info, img_id = info, iid
                tiles.append(img)
                hws.append(img.shape[:2])
                targets.append(labels)
            mrand[3:9] = get_affine_params((iw, ih), self.degrees, self.translate, self.scale,
                                           self.shear, rng)
            n_labels = sum(len(t) for t in targets)
        else:
            self._dataset.img_size = self.input_dim
            img, labels, img_info, img_id = self._dataset.pull_item(index)
            tiles = [img] + [np.zeros((1, 1, 3), np.uint8)] * 3
            hws = [img.shape[:2], (1, 1), (1, 1), (1, 1)]
            targets = [labels, np.zeros((0, 5), np.float32)] + [np.zeros((0, 5), np.float32)] * 2
            n_labels = len(labels)

        # the mixup gate keys on the enable flags and the label count, not on
        # the mosaic draw (mosaic.py:110-112)
        use_mixup = (self.enable_mosaic and self.enable_mixup and n_labels > 0
                     and rng.random() < self.mixup_prob)
        partner = np.zeros((1, 1, 3), np.uint8)
        p_labels = np.zeros((0, 5), np.float32)
        if use_mixup:
            mrand[9] = 1.0
            jit = rng.uniform(*self.mixup_scale)
            mrand[10] = jit
            mrand[11] = 1.0 if rng.random() > 0.5 else 0.0
            p_idx = None
            for _ in range(50):  # resample until labels; only randint draws
                cand = rng.randint(0, len(self._dataset) - 1)
                if self._ann_count(cand) > 0:
                    p_idx = cand
                    break
            if p_idx is None:
                mrand[9] = 0.0
            else:
                partner, p_labels, _, _ = self._dataset.pull_item(p_idx)
                tw2, th2 = int(iw * jit), int(ih * jit)
                mrand[14], mrand[15] = tw2, th2
                oh, ow = (ih, iw) if use_mosaic else tiles[0].shape[:2]
                pad_w, pad_h = max(tw2, ow), max(th2, oh)
                mrand[12] = rng.randint(0, pad_w - ow) if pad_w > ow else 0
                mrand[13] = rng.randint(0, pad_h - oh) if pad_h > oh else 0
        tiles.append(partner)
        hws.append(partner.shape[:2])
        targets.append(p_labels)

        # resized extents int(h*s) in host f64; row 4 is the partner's first
        # letterbox
        nhw = np.zeros((5, 2), np.int32)
        for t in range(5):
            h0, w0 = hws[t]
            s = min(ih / h0, iw / w0)
            nhw[t] = (int(h0 * s), int(w0 * s))

        tt_randoms = draw_randoms(rng, 1, self.hsv_prob)[0]
        return tiles, hws, nhw, targets, mrand, tt_randoms, img_info, img_id


_TRUNC_WARNED = [False]


def make_mosaic_collate(src_size: Tuple[int, int], max_boxes: int = 120):
    """Collate ``DeviceMosaicDataset`` items into the static buffers of
    ``mosaic_mixup_batch`` (device_mosaic.py:580-627): returns (batch dict
    of numpy arrays, None, infos, ids)."""
    sh, sw = src_size

    def collate(items):
        b = len(items)
        tiles = np.zeros((b, 5, sh, sw, 3), np.uint8)
        hw = np.zeros((b, 5, 2), np.int32)
        nhw = np.zeros((b, 5, 2), np.int32)
        boxes = np.zeros((b, 5, max_boxes, 4), np.float32)
        classes = np.zeros((b, 5, max_boxes), np.float32)
        nvalid = np.zeros((b, 5), np.int32)
        mrand = np.zeros((b, N_MOSAIC_RANDOMS), np.float32)
        tt = np.zeros((b, items[0][5].shape[0]), np.float32)
        infos, ids = [], []
        for i, (t5, hw5, nhw5, tg5, mr, ttr, info, iid) in enumerate(items):
            for t in range(5):
                h = min(t5[t].shape[0], sh)
                w = min(t5[t].shape[1], sw)
                tiles[i, t, :h, :w] = t5[t][:h, :w]
                hw[i, t] = (h, w)
                n = min(len(tg5[t]), max_boxes)
                if len(tg5[t]) > max_boxes and not _TRUNC_WARNED[0]:
                    _TRUNC_WARNED[0] = True
                    print(f"[device_mosaic] WARNING: tile with {len(tg5[t])} boxes truncated "
                          f"to max_boxes={max_boxes} (raise exp.device_mosaic_max_boxes "
                          f"to keep host parity on crowded images)", flush=True)
                if n:
                    boxes[i, t, :n] = tg5[t][:n, :4]
                    classes[i, t, :n] = tg5[t][:n, 4]
                nvalid[i, t] = n
            nhw[i] = nhw5
            mrand[i] = mr
            tt[i] = ttr
            infos.append(info)
            ids.append(iid)
        batch = {"mosaic_tiles": tiles, "hw5": hw, "nhw5": nhw, "boxes5": boxes,
                 "classes5": classes, "nvalid5": nvalid, "mrand": mrand, "randoms": tt}
        return batch, None, infos, ids

    return collate


# --------------------------------------------------------------------------
# the card's side
# --------------------------------------------------------------------------


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, float(value), dtype=torch.float32)


def affine_boxes(boxes: torch.Tensor, m: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """``affine_boxes`` for a batch: boxes (B, M, 4) xyxy through the forward
    matrices m (B, 6), the enclosing box clipped to (tw, th)."""
    tw, th = out_size
    m00, m01, m02, m10, m11, m12 = (m[:, k, None, None] for k in range(6))
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = torch.stack([x1, x1, x2, x2], dim=-1)
    cy = torch.stack([y1, y2, y1, y2], dim=-1)
    wx = m00 * cx + m01 * cy + m02
    wy = m10 * cx + m11 * cy + m12
    return torch.stack([wx.amin(-1).clamp(0, tw), wy.amin(-1).clamp(0, th),
                        wx.amax(-1).clamp(0, tw), wy.amax(-1).clamp(0, th)], dim=-1)


def compact(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor):
    """The stable front-compaction of the valid rows (B, M): (boxes, classes,
    count), the rest zeroed."""
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    classes = torch.gather(classes, 1, order)
    n = valid.sum(1).to(torch.int32)
    live = torch.arange(valid.shape[1], device=valid.device)[None, :] < n[:, None]
    return (torch.where(live[..., None], boxes, 0.0), torch.where(live, classes, 0.0), n)


def mosaic_mixup_batch(tiles: torch.Tensor, hw: torch.Tensor, nhw: torch.Tensor,
                       boxes: torch.Tensor, classes: torch.Tensor, nvalid: torch.Tensor,
                       mrand: torch.Tensor, out_size: Tuple[int, int]):
    """The batched mosaic + affine + mixup (device_mosaic.py:631-668).

    tiles (B, 5, sh, sw, 3) uint8, hw/nhw (B, 5, 2) int32, boxes (B, 5, N, 4)
    f32 xyxy, classes (B, 5, N) f32, nvalid (B, 5) int32, mrand (B, 16) f32 ->
    images (B, sh, sw, 3) uint8 (integer-valued, as JAX's f32), hw (B, 2)
    int32, boxes (B, 5N, 4), classes (B, 5N), nvalid (B,) int32. The whole
    batch in one launch of each kernel, with no chunking."""
    ih, iw = out_size
    B, _, N = classes.shape
    dev = tiles.device
    yc = mrand[:, 1].to(torch.int32)
    xc = mrand[:, 2].to(torch.int32)
    m = mrand[:, 3:9].contiguous()
    canvas = kernels.mosaic_canvas(tiles, hw, nhw, yc, xc, out_size)
    warped = kernels.affine_warp(canvas, m, out_size)
    img = kernels.mixup(tiles, hw, nhw, warped, mrand, out_size)

    # labels: tile boxes -> canvas coordinates -> the affine
    h0, w0 = _f(hw[:, :4, 0]), _f(hw[:, :4, 1])
    s = torch.minimum(_full(ih, h0) / h0, _full(iw, w0) / w0)  # (B, 4)
    nh, nw = nhw[:, :4, 0], nhw[:, :4, 1]
    zero = torch.zeros_like(yc)
    x1 = torch.stack([torch.maximum(xc - nw[:, 0], zero), xc,
                      torch.maximum(xc - nw[:, 2], zero), xc], 1)
    y1 = torch.stack([torch.maximum(yc - nh[:, 0], zero), torch.maximum(yc - nh[:, 1], zero),
                      yc, yc], 1)
    x2 = torch.stack([xc, torch.clamp_max(xc + nw[:, 1], 2 * iw), xc,
                      torch.clamp_max(xc + nw[:, 3], 2 * iw)], 1)
    y2 = torch.stack([yc, yc, torch.clamp_max(yc + nh[:, 2], 2 * ih),
                      torch.clamp_max(yc + nh[:, 3], 2 * ih)], 1)
    sx1 = torch.stack([nw[:, 0] - (x2[:, 0] - x1[:, 0]), zero,
                       nw[:, 2] - (x2[:, 2] - x1[:, 2]), zero], 1)
    sy1 = torch.stack([nh[:, 0] - (y2[:, 0] - y1[:, 0]), nh[:, 1] - (y2[:, 1] - y1[:, 1]),
                       zero, zero], 1)
    padw, padh = _f(x1 - sx1)[..., None], _f(y1 - sy1)[..., None]
    b = boxes[:, :4] * s[..., None, None]
    mos = torch.stack([(b[..., 0] + padw).clamp(0, 2 * iw), (b[..., 1] + padh).clamp(0, 2 * ih),
                       (b[..., 2] + padw).clamp(0, 2 * iw), (b[..., 3] + padh).clamp(0, 2 * ih)],
                      dim=-1)
    slot = torch.arange(N, device=dev)
    mb = affine_boxes(mos.reshape(B, 4 * N, 4), m, (iw, ih))
    mc = classes[:, :4].reshape(B, 4 * N)
    mv = (slot[None, None, :] < nvalid[:, :4, None]).reshape(B, 4 * N)

    # the origin: the mosaic, or tile 0 passed through
    use_mosaic = mrand[:, 0] > 0
    hw_mid = torch.where(use_mosaic[:, None], torch.tensor([ih, iw], dtype=torch.int32,
                                                           device=dev), hw[:, 0])
    pad3 = torch.zeros((B, 3 * N), dtype=torch.float32, device=dev)
    ob = torch.where(use_mosaic[:, None, None], mb,
                     torch.cat([boxes[:, 0], pad3[..., None].expand(B, 3 * N, 4)], 1))
    oc = torch.where(use_mosaic[:, None], mc, torch.cat([classes[:, 0], pad3], 1))
    ov = torch.where(use_mosaic[:, None], mv,
                     torch.cat([slot[None, :] < nvalid[:, 0, None], pad3 > 0], 1))

    # the mixup partner's labels (_mixup_boxes)
    use_mixup = mrand[:, 9] > 0
    h4, w4 = _f(hw[:, 4, 0]), _f(hw[:, 4, 1])
    s5 = torch.minimum(_full(ih, h4) / h4, _full(iw, w4) / w4)
    tw2 = _f(mrand[:, 14].to(torch.int32))[:, None]
    pb = boxes[:, 4] * (s5 * mrand[:, 10])[:, None, None]
    flipped = torch.stack([tw2 - pb[..., 2], pb[..., 1], tw2 - pb[..., 0], pb[..., 3]], dim=-1)
    pb = torch.where((mrand[:, 11] > 0)[:, None, None], flipped, pb)
    xo, yo = mrand[:, 12, None], mrand[:, 13, None]
    oh, ow = _f(hw_mid[:, 0])[:, None], _f(hw_mid[:, 1])[:, None]
    pb = torch.stack([torch.minimum(torch.clamp_min(pb[..., 0] - xo, 0), ow),
                      torch.minimum(torch.clamp_min(pb[..., 1] - yo, 0), oh),
                      torch.minimum(torch.clamp_min(pb[..., 2] - xo, 0), ow),
                      torch.minimum(torch.clamp_min(pb[..., 3] - yo, 0), oh)], dim=-1)
    pkeep = (pb[..., 2] - pb[..., 0] > 1) & (pb[..., 3] - pb[..., 1] > 1)
    pv = use_mixup[:, None] & pkeep & (slot[None, :] < nvalid[:, 4, None])

    fb, fc, n_out = compact(torch.cat([ob, pb], 1), torch.cat([oc, classes[:, 4]], 1),
                            torch.cat([ov, pv], 1))
    return img, hw_mid, fb, fc, n_out
