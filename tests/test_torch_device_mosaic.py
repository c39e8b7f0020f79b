"""The port's device-mosaic input pipeline (cocodet_tpu_torch/data/
device_mosaic.py, device_aug.py, ops/cuda/train_aug.py's plain versions)
against cocodet_tpu/data/device_mosaic.py and device_aug.py, with the JAX
tests' ``FakeDataset`` and seeds (tests/test_device_mosaic.py), in its cases:
axis-aligned, rotation, passthrough (with mixup), no mixup, f32-divergent
sizes.

Tolerances, each stated:
- the host side, ``fetch`` and the collate: exact (every array and value);
- against JAX's programs run op by op (``jax.disable_jit``): exact, images,
  boxes and every other output (the plain versions follow the JAX ops in
  f32 with IEEE division);
- against JAX's jitted programs, which the JAX trainer runs: hw, nvalid and
  classes exact; boxes within 1e-3 px; images within 1 grey level
  everywhere; of the mosaic stage's integer-valued images at most 0.1%
  differ at all. Of the final f32 images at most 0.7% differ by more than
  1e-3 (measured worst 0.53%, passthrough with mixup; next 0.28%,
  rotation). This is looser than "0.1% differ at all", which the final
  images cannot meet against the jitted programs: under ``jax.jit``
  XLA:CPU contracts multiply-adds into FMAs (the letterbox's blend
  ``a * (1 - w) + b * w`` becomes ``fma(a, 1 - w, b * w)`` in both passes:
  emulated so, 0 of its values differ from the jitted letterbox; computed
  as written, 11.7% differ in their last bits at 46x48 -> 61x64), so up to
  ~11% of the final values move in their last bits, and a value whose HSV
  rounding flips moves by up to a grey level, in all three channels of a
  pixel. Op by op, 0 values differ.
"""

import math
import random
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_device_mosaic import FakeDataset, _boxes, _rand_img  # noqa: E402

from cocodet_tpu.data import device_aug as jda  # noqa: E402
from cocodet_tpu.data import device_mosaic as jdm  # noqa: E402
from cocodet_tpu_torch.data import device_aug as pda  # noqa: E402
from cocodet_tpu_torch.data import device_mosaic as pdm  # noqa: E402
from cocodet_tpu_torch.ops.cuda import train_aug as ta  # noqa: E402

KEYS = ("mosaic_tiles", "hw5", "nhw5", "boxes5", "classes5", "nvalid5", "mrand")
SIZE = (64, 64)


def _dataset(seed=5):
    return FakeDataset(np.random.RandomState(seed), n=10, img_size=SIZE)


def _divergent_dataset():
    """Every item at (33, 47): f64 extents (44, 64), f32 floor (44, 63)."""
    rs = np.random.RandomState(7)
    ds = FakeDataset(rs, n=10, img_size=SIZE)
    for i in range(len(ds)):
        ds._imgs[i] = _rand_img(rs, 33, 47)
        ds.annotations[i] = (_boxes(rs, 3, 33, 47), (33, 47), (33, 47), f"{i}.jpg")
    return ds


CASES = {
    "axis_aligned": dict(seed=11, degrees=0.0, shear=0.0),
    "rotation": dict(seed=23),
    "passthrough_mixup": dict(seed=31, mosaic_prob=0.0),
    "no_mixup": dict(seed=41, enable_mixup=False, degrees=0.0, shear=0.0),
    "f32_divergent": dict(seed=51, mosaic_prob=0.0, dataset=_divergent_dataset),
}


def _fetch_both(seed, degrees=10.0, shear=2.0, mosaic_prob=1.0, enable_mixup=True,
                dataset=_dataset, n_items=3):
    ds = dataset()
    kw = dict(degrees=degrees, translate=0.1, mosaic_scale=(0.8, 1.2), mixup_scale=(0.7, 1.3),
              shear=shear, enable_mixup=enable_mixup, mosaic_prob=mosaic_prob, mixup_prob=1.0)
    j = jdm.DeviceMosaicDataset(ds, img_size=SIZE, **kw)
    p = pdm.DeviceMosaicDataset(ds, img_size=SIZE, **kw)
    ji = [j.fetch(i, rng=random.Random(seed + i)) for i in range(n_items)]
    pi = [p.fetch(i, rng=random.Random(seed + i)) for i in range(n_items)]
    return ji, pi


def _assert_items_equal(ji, pi):
    for a, b in zip(ji, pi):
        tiles_a, hws_a, nhw_a, tg_a, mr_a, tt_a, info_a, id_a = a
        tiles_b, hws_b, nhw_b, tg_b, mr_b, tt_b, info_b, id_b = b
        for x, y in zip(tiles_a, tiles_b):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(tg_a, tg_b):
            np.testing.assert_array_equal(x, y)
        assert [tuple(h) for h in hws_a] == [tuple(h) for h in hws_b]
        for x, y in ((nhw_a, nhw_b), (mr_a, mr_b), (tt_a, tt_b)):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert info_a == info_b and id_a == id_b


def _collate_both(ji, pi):
    jb = jdm.make_mosaic_collate(SIZE, max_boxes=16)(ji)[0]
    pb = pdm.make_mosaic_collate(SIZE, max_boxes=16)(pi)[0]
    assert sorted(jb) == sorted(pb)
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        assert jb[k].dtype == pb[k].dtype, k
    return jb, {k: torch.from_numpy(v) for k, v in pb.items()}


def _images_close(got, want, what, frac_tol=1e-3, floor=0.0):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1.0, (what, d.max())
    frac = float((d > floor).mean())
    assert frac <= frac_tol, (what, frac)


def _port_outputs(tb):
    mos = pdm.mosaic_mixup_batch(*[tb[k] for k in KEYS], SIZE)
    final = pda.mosaic_preproc_batch(tb, SIZE, max_labels=30)
    return mos, final


@pytest.mark.parametrize("case", sorted(CASES))
def test_fetch_and_collate_equal_jax(case):
    ji, pi = _fetch_both(**CASES[case])
    _assert_items_equal(ji, pi)
    jb, _ = _collate_both(ji, pi)
    if case.startswith("passthrough") or case == "f32_divergent":
        assert not jb["mrand"][:, 0].any() and jb["mrand"][:, 9].any()
    else:
        assert jb["mrand"][:, 0].all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_programs_equal_jax_op_by_op(case):
    jb, tb = _collate_both(*_fetch_both(**CASES[case], n_items=2))
    with jax.disable_jit():
        jm = jdm.mosaic_mixup_batch(*[jb[k] for k in KEYS], out_size=SIZE)
        jf = jda.mosaic_preproc_batch(jb, SIZE, max_labels=30)
    pm, pf = _port_outputs(tb)
    for got, want in zip(list(pm) + list(pf), list(jm) + list(jf)):
        got = got.numpy()
        np.testing.assert_array_equal(got.astype(np.asarray(want).dtype), np.asarray(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_programs_match_jax_jitted(case):
    jb, tb = _collate_both(*_fetch_both(**CASES[case]))
    jm = [np.asarray(x) for x in jdm.mosaic_mixup_batch(*[jb[k] for k in KEYS], out_size=SIZE)]
    jimg, jlab = [np.asarray(x) for x in jda.mosaic_preproc_batch(jb, SIZE, max_labels=30)]
    (img, hw, boxes, classes, nvalid), (fimg, flab) = _port_outputs(tb)
    np.testing.assert_array_equal(hw.numpy(), jm[1])
    np.testing.assert_array_equal(nvalid.numpy(), jm[4])
    np.testing.assert_array_equal(classes.numpy(), jm[3])
    np.testing.assert_allclose(boxes.numpy(), jm[2], rtol=0, atol=1e-3)
    _images_close(img.numpy(), jm[0], "mosaic stage")
    np.testing.assert_array_equal(flab[..., 0].numpy(), jlab[..., 0])
    np.testing.assert_allclose(flab[..., 1:].numpy(), jlab[..., 1:], rtol=0, atol=1e-3)
    _images_close(fimg.numpy(), jimg, "final images", frac_tol=7e-3, floor=1e-3)


def test_train_aug_batch_fallback_and_flip_match_jax():
    """train_aug_batch alone on raw buffers, with boxes that the scaling
    kills (the clean-image fallback), an item without boxes, flips on and
    off: the plain version against JAX op by op, exact. (Shapes as the
    pipeline's, so JAX's op-by-op compiles are shared.)"""
    rs = np.random.RandomState(3)
    b, n = 2, 80
    for hw, nvalid, flips, tiny, want_fallback in (
            ([[64, 64], [40, 30]], [6, 3], [0.1, 0.9], 1, [0, 1]),
            ([[33, 47], [64, 64]], [0, 5], [0.9, 0.1], None, [1, 0])):
        imgs = rs.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)
        hw = np.asarray(hw, np.int32)
        boxes = np.zeros((b, n, 4), np.float32)
        boxes[:, :, :2] = rs.uniform(0, 20, (b, n, 2))
        boxes[:, :, 2:] = boxes[:, :, :2] + rs.uniform(4, 20, (b, n, 2))
        if tiny is not None:
            boxes[tiny, :, 2:] = boxes[tiny, :, :2] + 0.5  # too small: the fallback
        classes = rs.randint(0, 9, (b, n)).astype(np.float32)
        nvalid = np.asarray(nvalid, np.int32)
        randoms = jda.draw_randoms(random.Random(9), b, 1.0)
        randoms[:, 7] = flips
        nhw = np.asarray([[int(h * min(64 / h, 64 / w)), int(w * min(64 / h, 64 / w))]
                          for h, w in hw], np.int32)
        args = (imgs, hw, boxes, classes, nvalid, randoms, nhw)
        with jax.disable_jit():
            want = jda.train_aug_batch(*args, out_size=SIZE, max_labels=30)
        got = pda.train_aug_batch(*[torch.from_numpy(a) for a in args], out_size=SIZE,
                                  max_labels=30)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        a = pda.aug_inputs(*[torch.from_numpy(x) for x in (hw, boxes, nvalid, randoms)], SIZE)
        assert a["fallback"].tolist() == want_fallback
        assert a["flip"].tolist() == [int(f < 0.5) for f in flips]


def test_hsv_jitter_plain_equals_jax_op_by_op():
    """Every hue sector, grey pixels (no hue), black, white, negative and
    wrapping gains."""
    rs = np.random.RandomState(4)
    img = np.concatenate([rs.randint(0, 256, (2000, 3)), [[0, 0, 0], [255, 255, 255],
                                                          [7, 7, 7], [0, 0, 255]]])
    img = img.astype(np.float32)
    for gains in ([3.0, -20.0, 10.0], [-5.0, 30.0, -30.0], [179.0, 0.0, 0.0]):
        with jax.disable_jit():
            want = np.asarray(jda.hsv_jitter(img, np.asarray(gains, np.float32)))
        got = ta.hsv_jitter_plain(torch.from_numpy(img), torch.tensor(gains))
        np.testing.assert_array_equal(got.numpy(), want)


def test_affine_warp_plain_equals_jax_op_by_op():
    """The warp (K2's plain version) against affine_warp, with rotation and
    shear, and a matrix past the safe_m00 guard."""
    rs = np.random.RandomState(2)
    canvas = rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    ms = [jdm.get_affine_params(SIZE, 10.0, 0.1, (0.5, 1.5), 2.0, random.Random(s))
          for s in range(2)]
    ms[1][0] = 1e-4  # m00 under the 1e-3 guard
    m = np.stack(ms).astype(np.float32)
    got = ta.affine_warp(torch.from_numpy(canvas), torch.from_numpy(m), SIZE)
    for b in range(2):
        with jax.disable_jit():
            want = np.asarray(jdm.affine_warp(canvas[b].astype(np.float32), m[b], SIZE))
        np.testing.assert_array_equal(got[b].numpy().astype(np.float32), want)


def _warp_matrix(scale, degrees, shear, tx, ty):
    """get_affine_params's f64 matrix for fixed draws (shear_x = shear,
    shear_y = -shear, in degrees; translations as fractions of SIZE)."""
    rad = math.radians(degrees)
    alpha, beta = scale * math.cos(rad), scale * math.sin(rad)
    sx, sy = math.tan(math.radians(shear)), math.tan(math.radians(-shear))
    return [alpha - sy * beta, beta + sy * alpha, tx * SIZE[1],
            -beta + sx * alpha, alpha + sx * beta, ty * SIZE[0]]


# K2's matrices: the draw's extremes in yolox_m_p6 (scale 0.1-2.0, +-10
# degrees, shear +-2, translation +-0.1), each guard, the whole output on
# the border
WARP_CASES = {
    "scale_0.1": [_warp_matrix(0.1, 10.0, 2.0, 0.1, -0.1),
                  _warp_matrix(0.1, -10.0, -2.0, -0.1, 0.1)],
    "scale_2.0": [_warp_matrix(2.0, -10.0, 2.0, 0.1, 0.1),
                  _warp_matrix(2.0, 10.0, -2.0, -0.1, -0.1)],
    "safe_det_guard": [[0.5, 0.5, 10.0, 0.5, 0.5, 10.0], [1e-4, 0.0, 0.0, 0.0, 1e-4, 0.0]],
    "all_border": [_warp_matrix(1.0, 5.0, 1.0, 3.0, 0.0), _warp_matrix(0.7, 0.0, 0.0, 0.0, -4.0)],
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_affine_warp_plain_equals_jax_at_the_extremes(case):
    """K2's plain version against affine_warp run op by op, bit for bit, on
    the matrices of WARP_CASES."""
    rs = np.random.RandomState(len(case))
    canvas = rs.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    m = np.asarray(WARP_CASES[case], np.float64).astype(np.float32)
    got = ta.affine_warp(torch.from_numpy(canvas), torch.from_numpy(m), SIZE).numpy()
    for b in range(2):
        with jax.disable_jit():
            want = np.asarray(jdm.affine_warp(canvas[b].astype(np.float32), m[b], SIZE))
        np.testing.assert_array_equal(got[b].astype(np.float32), want)
    if case == "all_border":
        assert (got == 114).all()
    else:
        assert (got != 114).any()


def _jax_mixup_one(tiles, hw, nhw, warped, mr, size):
    """The origin select, _mixup_partner and the floor blend of
    _mosaic_one (device_mosaic.py:398-422) for one item."""
    ih, iw = size
    sh, sw = tiles.shape[1:3]
    use_mosaic = mr[0] > 0
    placed = jnp.full((sh, sw, 3), 114.0, jnp.float32)
    placed = jax.lax.dynamic_update_slice(placed, warped.astype(jnp.float32), (0, 0, 0))
    mid = jnp.where(use_mosaic, placed, tiles[0].astype(jnp.float32))
    hw_mid = jnp.where(use_mosaic, jnp.asarray([ih, iw], jnp.int32), hw[0])
    cp, _, _ = jdm._mixup_partner(tiles[4].astype(jnp.float32), hw[4], (ih, iw), (sh, sw),
                                  hw_mid, mr[10], mr[11], mr[12], mr[13], mr[14], mr[15],
                                  nhw=nhw[4])
    return jnp.where(mr[9] > 0, jnp.floor(0.5 * mid + 0.5 * cp), mid)


# K3's draws: (mosaic origin, jit, flip, offsets: "low", "high" or "mid")
MIXUP_CASES = {
    "flipped": (1, 1.2, 1, "mid"),
    "crop_low_edges": (1, 1.4, 0, "low"),
    "crop_high_edges": (1, 1.4, 0, "high"),
    "flipped_crop_high_edges": (1, 1.45, 1, "high"),
    "tw2_above_iw": (1, 1.5, 0, "mid"),
    "tw2_below_iw": (1, 0.55, 0, "mid"),
    "passthrough_origin": (0, 0.9, 1, "high"),
}


@pytest.mark.parametrize("case", sorted(MIXUP_CASES))
def test_mixup_plain_equals_jax_op_by_op(case):
    """K3's plain version against _mixup_partner and _mosaic_one's origin
    select and blend run op by op, bit for bit: a (72, 80) buffer around a
    (64, 64) input, a partner downscaled and one upscaled at stage 1."""
    mosaic, jit, flip, offsets = MIXUP_CASES[case]
    rs = np.random.RandomState(len(case))
    ih, iw = SIZE
    sh, sw = 72, 80
    tiles = rs.randint(0, 256, (2, 5, sh, sw, 3)).astype(np.uint8)
    hw = np.asarray([[[60, 70]] * 4 + [[72, 80]], [[45, 50]] * 4 + [[30, 41]]], np.int32)
    nhw = np.asarray([[[int(h * min(ih / h, iw / w)), int(w * min(ih / h, iw / w))]
                       for h, w in item] for item in hw], np.int32)
    warped = rs.randint(0, 256, (2, ih, iw, 3)).astype(np.uint8)
    mrand = np.zeros((2, 16), np.float32)
    for b in range(2):
        tw2, th2 = int(iw * jit), int(ih * jit)
        oh, ow = (ih, iw) if mosaic else tuple(hw[b, 0])
        room_x, room_y = max(tw2, ow) - ow, max(th2, oh) - oh
        x_off, y_off = {"low": (0, 0), "high": (room_x, room_y),
                        "mid": (room_x // 2, room_y // 3)}[offsets]
        mrand[b] = [mosaic, 0, 0, 1, 0, 0, 0, 1, 0, 1, jit, flip, x_off, y_off, tw2, th2]
    got = ta.mixup_plain(*[torch.from_numpy(a) for a in (tiles, hw, nhw, warped, mrand)], SIZE)
    for b in range(2):
        with jax.disable_jit():
            want = _jax_mixup_one(tiles[b], hw[b], nhw[b], warped[b], mrand[b], SIZE)
        np.testing.assert_array_equal(got[b].numpy().astype(np.float32), np.asarray(want))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    canvas = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ta.affine_warp(canvas, torch.zeros((1, 5)), (4, 4))
    with pytest.raises(TypeError):
        ta.affine_warp(canvas, torch.zeros((1, 6), dtype=torch.float64), (4, 4))
    assert all(fn.launches == 0 for fn in ta.WRAPPERS)  # the CPU runs the plain versions


def _greedy_bands(i0, i1, cap):
    """Bands by a linear walk: extend a band while its rows read at most
    ``cap`` source rows."""
    out, ra = [], 0
    while ra < len(i0):
        rb = ra + 1
        while rb < len(i0) and i1[rb] - i0[ra] + 1 <= cap:
            rb += 1
        out.append((ra, rb))
        ra = rb
    return out


@pytest.mark.parametrize("seed", range(4))
def test_bands_are_the_greedy_walk(seed):
    """``ta.bands`` (the kernels' ``band_end``, a binary search) cuts a
    block's rows as a linear walk does; every band fits, none can grow."""
    rs = np.random.RandomState(seed)
    for _ in range(50):
        n = rs.randint(1, 65)
        i0 = np.cumsum(rs.randint(0, 12, n))
        i1 = i0 + rs.randint(0, 2, n)
        i1 = np.maximum.accumulate(i1)
        cap = rs.randint(2, 40)
        got = ta.bands(i0.tolist(), i1.tolist(), cap)
        assert got == _greedy_bands(i0.tolist(), i1.tolist(), cap)
        for ra, rb in got:
            assert i1[rb - 1] - i0[ra] + 1 <= cap
            assert rb == n or i1[rb] - i0[ra] + 1 > cap


def _tap(o, num, den):
    """One position's plain taps (lo, hi)."""
    i0, i1, _ = ta.lin_taps(torch.tensor([float(o)]), torch.tensor(float(num)) /
                            torch.tensor(float(den)), den)
    return int(i0[0]), int(i1[0])


def _brute_aug_bands(hw, nhw, flip, fallback, size, sw):
    """K4's bands, block by block and pixel by pixel from the plain taps."""
    ih, iw = size
    rows, cols = ta.AUG_TILE
    most = 0
    for (h, w), (nh, nw), fl, fb in zip(hw, nhw, flip, fallback):
        for r0 in range(0, min(nh, ih), rows):
            for c0 in range(0, min(nw, iw), cols):
                taps = [_tap(c, nw, w) for c in range(c0, min(c0 + cols, nw, iw))]
                t0, t1 = min(t[0] for t in taps), max(t[1] for t in taps)
                img_cols = [min(max(w - 1 - t, 0), sw - 1) if fl and not fb else t
                            for t in range(t0, t1 + 1)]
                lo, hi = 3 * min(img_cols), 3 * max(img_cols) + 3
                if sw * 3 % 16 == 0:
                    lo, hi = lo // 16 * 16, -(-hi // 16) * 16
                cap = min(ta.aug_raw_bytes(sw) // (hi - lo), ta.aug_stage_px(sw) // (t1 - t0 + 1))
                ys = [_tap(r, nh, h) for r in range(r0, min(r0 + rows, nh, ih))]
                most = max(most, len(_greedy_bands([y[0] for y in ys], [y[1] for y in ys], cap)))
    return most


def _brute_canvas_bands(hw5, nhw5, yc, xc, size, sw):
    """K1's bands, tile by tile and block by block from the plain taps."""
    ih, iw = size
    rows, cols = ta.CANVAS_TILE
    most = 0
    for hw, nhw, y, x in zip(hw5, nhw5, yc, xc):
        for t, (x1, y1, x2, y2, padw, padh) in enumerate(ta.tile_rects(y, x, nhw[:4], ih, iw)):
            (h0, w0), (nh, nw) = hw[t], nhw[t]
            for v0 in range(0, 2 * ih, rows):
                for u0 in range(0, 2 * iw, cols):
                    vr = range(max(y1, v0), min(y2, v0 + rows))
                    ur = range(max(x1, u0), min(x2, u0 + cols))
                    if not len(vr) or not len(ur):
                        continue
                    us = [_tap(u - padw, nw, w0) for u in ur]
                    lo, hi = 3 * min(u[0] for u in us), 3 * max(u[1] for u in us) + 3
                    if sw * 3 % 16 == 0:
                        lo, hi = lo // 16 * 16, -(-hi // 16) * 16
                    vs = [_tap(v - padh, nh, h0) for v in vr]
                    cap = ta.canvas_stage_bytes(sw) // (hi - lo)
                    most = max(most, len(_greedy_bands([v[0] for v in vs], [v[1] for v in vs],
                                                       cap)))
    return most


@pytest.mark.parametrize("sw", [96, 100])
def test_block_bands_match_a_brute_force_walk(sw):
    """``train_aug_bands`` and ``mosaic_canvas_bands``, which chip_smoke.py
    prints beside K4's and K1's card checks, against a walk over the plain
    taps of every block: upscales (one band), downscales (several), flipped
    and fallback items, rows of 16-byte chunks (sw 96) and not (sw 100)."""
    rs = np.random.RandomState(sw)
    size = (40, 72)
    hw = [[sw, sw], [60, sw], [sw, 33], [17, 25]]
    nhw = [[5, 7], [40, 72], [12, 40], [40, 60]]
    flip, fb = [1, 0, 1, 1], [0, 0, 0, 1]
    got = ta.train_aug_bands(*(torch.tensor(a, dtype=torch.int32) for a in (hw, nhw, flip, fb)),
                             size, sw)
    assert got == _brute_aug_bands(hw, nhw, flip, fb, size, sw) and got > 1
    hw5 = rs.randint(20, sw + 1, (3, 5, 2)).tolist()
    nhw5 = [[[rs.randint(2, 60), rs.randint(2, 60)] for _ in range(5)] for _ in range(3)]
    yc, xc = [40, 0, 80], [72, 144, 30]
    got = ta.mosaic_canvas_bands(*(torch.tensor(a, dtype=torch.int32)
                                   for a in (hw5, nhw5, yc, xc)), size, sw)
    assert got == _brute_canvas_bands(hw5, nhw5, yc, xc, size, sw)


@pytest.mark.parametrize("sw", [1, 5, 16, 100, 768, 2731, 5000])
def test_stages_hold_two_whole_source_rows(sw):
    """The kernels' invariant: whatever the scale, one output row (which
    reads two source rows) fits each stage."""
    row = ta._row_bytes(0, sw - 1, sw)[1]
    assert ta.canvas_stage_bytes(sw) >= 2 * row and ta.aug_raw_bytes(sw) >= 2 * row
    assert ta.aug_stage_px(sw) >= 2 * sw and ta.aug_stage_px(sw) % 4 == 0


def test_jitted_letterbox_is_the_fma_contracted_blend():
    """Why the jitted programs differ from the op-by-op ones (and so from the
    port): jitted on XLA:CPU, the letterbox's blend ``a * (1 - w) + b * w``
    is ``fma(a, 1 - w, b * w)`` in both passes. Emulated so in numpy (the
    product exact in f64, one rounding to f32), it equals the jitted
    letterbox bit for bit; computed as written, it equals the op-by-op one."""
    rs = np.random.RandomState(0)
    img = np.zeros((64, 64, 3), np.float32)
    img[:46, :48] = rs.randint(0, 256, (46, 48, 3))
    hw, nhw = np.array([46, 48], np.int32), np.array([61, 64], np.int32)

    def letterbox(i, h, n):
        return jda.letterbox_resize_one(i, h, SIZE, nhw=n)[0]

    jitted = np.asarray(jax.jit(letterbox)(img, hw, nhw))
    with jax.disable_jit():
        eager = np.asarray(letterbox(img, hw, nhw))
    y0, y1, wy = [np.asarray(x) for x in jda._lin_weights(64, 46, np.float32(61) / np.float32(46))]
    x0, x1, wx = [np.asarray(x) for x in jda._lin_weights(64, 48, np.float32(64) / np.float32(48))]
    one = np.float32(1)

    def blend(a, b, w0, w1, fma):
        if fma:
            return (a.astype(np.float64) * w0 + (b * w1)).astype(np.float32)
        return a * w0 + b * w1

    live = (np.arange(64)[:, None] < 61)[..., None]
    for fma, want in ((True, jitted), (False, eager)):
        rows = blend(img[y0], img[y1], (one - wy)[:, None, None], wy[:, None, None], fma)
        out = blend(rows[:, x0], rows[:, x1], (one - wx)[None, :, None], wx[None, :, None], fma)
        np.testing.assert_array_equal(np.where(live, out, np.float32(114)), want)
    assert (jitted != eager).mean() > 0.05
