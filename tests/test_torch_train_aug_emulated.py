"""csrc/train_aug.cu's kernels (K1-K4), compiled by g++ against a CPU
stand-in for the CUDA they use (tests/torch_cuda_emu.py), against their
plain versions (cocodet_tpu_torch/ops/cuda/train_aug.py::*_plain), bit for
bit, at small sizes.

The card runs the same source and chip_smoke.py's phase j1 holds it there;
these tests hold its arithmetic and its block logic where there is no card:
K2 on matrices at the draw's extremes, past each guard and off the canvas;
K3 with mixup off, passthrough origins, flipped partners, crops at each
edge, tw2 either side of iw, stage-1 downscales, and stages small enough
that both of its bands are walked; K1 and K4 on random tiles with
downscales, flips and fallbacks. Sizes off the block grid and rows that are
not whole 16-byte chunks take the kernels' byte paths.
"""

import math
import os
import random
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_cuda_emu as emu  # noqa: E402

from cocodet_tpu_torch.data.device_mosaic import get_affine_params  # noqa: E402
from cocodet_tpu_torch.ops.cuda import train_aug as ta  # noqa: E402


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emu.build(tmp_path_factory.mktemp("train_aug_emu"))


def _matrix(scale, degrees, shear, tx, ty, size):
    ih, iw = size
    rad = math.radians(degrees)
    alpha, beta = scale * math.cos(rad), scale * math.sin(rad)
    sx, sy = math.tan(math.radians(shear)), math.tan(math.radians(-shear))
    return [alpha - sy * beta, beta + sy * alpha, tx * iw, -beta + sx * alpha, alpha + sx * beta,
            ty * ih]


def _warp_matrices(size):
    ih, iw = size
    ms = [_matrix(0.1, 10, 2, 0.1, -0.1, size), _matrix(2.0, -10, -2, -0.1, 0.1, size),
          _matrix(0.5, 5, 1, 0.05, 0.02, size), _matrix(1.0, 0, 0, 0, 0, size),
          _matrix(1.3, -7, 2, 0.1, 0.1, size), _matrix(0.1, -10, -2, -0.1, -0.1, size),
          [1e-4, 0.01, 3.0, 0.02, 0.9, -2.0],   # past the safe_m00 guard
          [0.5, 0.0, 0.0, 0.0, 0.0, 5.0],       # det 0: past the safe_det guard
          [0.5, 0.5, 10.0, 0.5, 0.5, 10.0],     # det 0, a diagonal of canvas row 0
          _matrix(1.0, 0, 0, 10.0, 0, size)]     # off the canvas: all 114
    ms += [get_affine_params((iw, ih), 10.0, 0.1, (0.1, 2.0), 2.0, random.Random(s)).tolist()
           for s in range(4)]
    return np.asarray(ms, np.float64).astype(np.float32)


@pytest.mark.parametrize("size", [(64, 64), (40, 72), (33, 100), (72, 50), (24, 136)])
def test_affine_warp_kernel_equals_plain(lib, size):
    """K2 (affine_warp_kernel); (33, 100) and (72, 50) have rows that are not
    whole 16-byte chunks, (24, 136) a tile row narrower than the block."""
    ih, iw = size
    m6 = _warp_matrices(size)
    B = len(m6)
    canvas = np.random.RandomState(ih).randint(0, 256, (B, 2 * ih, 2 * iw, 3)).astype(np.uint8)
    got = emu.run(lib, "emu_affine_warp", [canvas, m6], (B, ih, iw, 3), np.uint8, [B, ih, iw])
    want = ta.affine_warp_plain(torch.from_numpy(canvas), torch.from_numpy(m6), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[9] == 114).all() and (got[3] != 114).any()


# K3's items: each a set of draws (see _mixup_inputs)
MIX_KINDS = ["nomix", "pass nomix", "pass", "flip", "cropmax flip", "cropmin", "cropmax", "small",
             "big1", "small flip cropmax", "big tiny", "unscaled one", "unscaled",
             "pass flip cropmax", "big", "one"]


def _mixup_inputs(rs, sh, sw, ih, iw):
    """One item of each MIX_KINDS: "pass" a passthrough origin, "nomix" mixup
    off, "flip", "cropmin"/"cropmax" the offsets at their low or high edge,
    "small"/"big1"/"one" jit 0.5, 1.5 or 1 (tw2 below, above or at iw), "big"
    a partner as large as the buffer (a stage-1 downscale), "tiny" its
    extents cut to 1/8, "unscaled" a partner its letterbox leaves unscaled."""
    B = len(MIX_KINDS)
    tiles = rs.randint(0, 256, (B, 5, sh, sw, 3)).astype(np.uint8)
    hw5 = np.zeros((B, 5, 2), np.int32)
    nhw5 = np.zeros((B, 5, 2), np.int32)
    mrand = np.zeros((B, 16), np.float32)
    for b, kind in enumerate(MIX_KINDS):
        for t in range(5):
            h, w = rs.randint(max(1, sh // 3), sh + 1), rs.randint(max(1, sw // 3), sw + 1)
            if t == 4 and "big" in kind.split():
                h, w = sh, sw
            if t == 4 and "unscaled" in kind:
                h, w = ih, rs.randint(iw // 2, iw + 1)
            hw5[b, t] = h, w
            s = min(ih / h, iw / w)
            nhw5[b, t] = int(h * s), int(w * s)
        if "tiny" in kind:
            nhw5[b, 4] = max(1, ih // 8), max(1, iw // 8)
        mosaic = "pass" not in kind
        jit = {"small": 0.5, "big1": 1.5, "one": 1.0}.get(
            next((j for j in ("small", "big1", "one") if j in kind.split()), ""),
            rs.uniform(0.5, 1.5))
        tw2, th2 = int(iw * jit), int(ih * jit)
        oh, ow = (ih, iw) if mosaic else tuple(hw5[b, 0])
        room_x, room_y = max(tw2, ow) - ow, max(th2, oh) - oh
        if "cropmax" in kind:
            x_off, y_off = room_x, room_y
        elif "cropmin" in kind:
            x_off, y_off = 0, 0
        else:
            x_off, y_off = rs.randint(0, room_x + 1), rs.randint(0, room_y + 1)
        mrand[b] = [mosaic, 0, 0, 1, 0, 0, 0, 1, 0, "nomix" not in kind, jit, "flip" in kind,
                    x_off, y_off, tw2, th2]
    warped = rs.randint(0, 256, (B, ih, iw, 3)).astype(np.uint8)
    return tiles, hw5, nhw5, warped, mrand


@pytest.mark.parametrize("stages", ["launch", "smallest"])
@pytest.mark.parametrize("geometry", [(64, 64, 64, 64), (72, 100, 64, 96), (64, 50, 64, 50),
                                      (96, 96, 64, 64), (40, 70, 33, 47)])
def test_mixup_kernel_equals_plain(lib, geometry, stages):
    """K3 (mixup_kernel) on MIX_KINDS; "smallest": S1 and source stages of
    two whole rows each, so that both bands are walked; (64, 50, 64, 50) has
    rows of 150 bytes (the byte paths)."""
    sh, sw, ih, iw = geometry
    inputs = _mixup_inputs(np.random.RandomState(sum(geometry)), sh, sw, ih, iw)
    B = inputs[0].shape[0]
    small = stages == "smallest"
    got = emu.run(lib, "emu_mixup", list(inputs), (B, sh, sw, 3), np.uint8,
                  [B, sh, sw, ih, iw, 2 * iw if small else 0, (6 * sw + 15) & ~15 if small else 0])
    want = ta.mixup_plain(*[torch.from_numpy(a) for a in inputs], (ih, iw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geometry", [(64, 64, 32, 32), (50, 100, 40, 72)])
def test_mosaic_canvas_kernel_equals_plain(lib, geometry):
    """K1 (mosaic_canvas_kernel): upscales, downscales (walked in bands),
    centres on and inside the canvas edges."""
    sh, sw, ih, iw = geometry
    rs = np.random.RandomState(sh + sw)
    B = 4
    tiles = rs.randint(0, 256, (B, 5, sh, sw, 3)).astype(np.uint8)
    hw5 = np.stack([rs.randint(1, sh + 1, (B, 5)), rs.randint(1, sw + 1, (B, 5))], -1)
    scale = rs.choice([0.2, 0.7, 1.0, 1.6], (B, 5, 1))
    nhw5 = np.maximum((hw5 * scale).astype(np.int32), 1)
    yc = np.asarray([0, ih // 2, ih, 2 * ih], np.int32)
    xc = np.asarray([2 * iw, iw, iw // 3, 0], np.int32)
    args = [tiles, hw5.astype(np.int32), nhw5.astype(np.int32), yc, xc]
    got = emu.run(lib, "emu_mosaic_canvas", args, (B, 2 * ih, 2 * iw, 3), np.uint8,
                  [B, sh, sw, ih, iw])
    want = ta.mosaic_canvas_plain(*[torch.from_numpy(a) for a in args], (ih, iw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geometry", [(64, 64, 48, 64), (50, 100, 40, 70)])
def test_train_aug_kernel_equals_plain(lib, geometry):
    """K4 (train_aug_kernel): HSV gains, flips and fallbacks, up- and
    downscaled letterboxes."""
    sh, sw, ih, iw = geometry
    rs = np.random.RandomState(sh * sw)
    B = 4
    img = rs.randint(0, 256, (B, sh, sw, 3)).astype(np.uint8)
    hw = np.stack([rs.randint(1, sh + 1, B), rs.randint(1, sw + 1, B)], -1).astype(np.int32)
    hw[0] = sh, sw
    s = np.minimum(ih / hw[:, 0], iw / hw[:, 1])
    nhw = np.stack([hw[:, 0] * s, hw[:, 1] * s], -1).astype(np.int32)
    nhw[1] = np.maximum(nhw[1] // 3, 1)  # a downscale
    gains = np.stack([rs.randint(-20, 21, B), rs.randint(-80, 81, B), rs.randint(-60, 61, B)],
                     -1).astype(np.float32)
    flip = np.asarray([1, 0, 1, 0], np.int32)
    fallback = np.asarray([0, 0, 1, 1], np.int32)
    args = [img, hw, nhw, gains, flip, fallback]
    got = emu.run(lib, "emu_train_aug", args, (B, ih, iw, 3), np.float32, [B, sh, sw, ih, iw])
    want = ta.train_aug_plain(*[torch.from_numpy(a) for a in args], (ih, iw)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
