"""The host mosaic path of the port (cocodet_tpu_torch/data/transforms.py,
data/mosaic.py, csrc/host/warp.cpp, the loader's default collate and the
exp's host branch) against cv2 and the JAX package's own path
(cocodet_tpu/data/transforms.py, data/mosaic.py, data/samplers.py,
exp/yolox_exp.py:194-215).

Tolerances: none. ``warp_affine`` equals ``cv2.warpAffine`` (INTER_LINEAR,
border 114) on every value of the matrices drawn below; BGR->HSV equals
``cv2.cvtColor`` on all 2^24 colours, HSV->BGR on all 180 x 256 x 256
triples, in rows of 256 (cv2's vector loop) and of 37 (its scalar tail too);
the plain numpy versions equal both. With the same ``random.Random`` seeds
the port's ``augment_hsv``, ``random_affine``, ``TrainTransform``,
``MosaicDetection.fetch`` and the exp's loader give JAX's images bit for bit
and its labels exactly, on JPEGs that JAX reads through ``cv2.imread``.
The reference is cv2 5.0.0, whose warp and HSV->BGR kernels are float code; the
header of csrc/host/warp.cpp says which operations they take in which
order. The last test trains the shipped phase-1 exp, cut to depth 0.33 and
width 0.125 at 128 px, for two steps in each of three epochs on the CPU.
"""

import os
import random

import cv2
import numpy as np
import pytest

from cocodet_tpu.data import coco as jcoco
from cocodet_tpu.data import mosaic as jmosaic
from cocodet_tpu.data import transforms as jt
from cocodet_tpu.exp import get_exp_by_file as jax_exp
from cocodet_tpu_torch.data import coco as pcoco
from cocodet_tpu_torch.data import mosaic as pmosaic
from cocodet_tpu_torch.data import transforms as pt
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.exp import get_exp_by_file as port_exp

from torch_port_utils import private_native_builds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXP = os.path.join(REPO, "exps", "p6", "yolox_m_p6.py")
PORT_EXP = os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py")
SMALL = ["depth", "0.33", "width", "0.125", "input_size", "(128, 128)", "test_size",
         "(128, 128)", "multiscale_range", "(0, 1)", "multiscale_step", "64",
         "compute_dtype", "float32", "data_num_workers", "2"]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """JAX's TrainTransform letterboxes through its native library: this
    module's process builds its own (tests/torch_port_utils.py)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """The port's synthetic train set: 10 JPEGs of 64-128 px."""
    return make_synthetic_coco(str(tmp_path_factory.mktemp("synth")), n_train=10, n_val=2,
                               size_range=(64, 128), seed=5)


def phase1():
    return port_exp(PORT_EXP)


def blurred(rs, h, w):
    return cv2.GaussianBlur(rs.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2)


# ---------------------------------------------------------------------- HSV
def _chunks(img, rows=512):
    for y in range(0, img.shape[0], rows):
        yield img[y:y + rows]


def test_bgr_to_hsv_exhaustive():
    c = np.arange(1 << 24, dtype=np.uint32)
    img = np.empty((1 << 24, 3), np.uint8)
    for k, shift in enumerate((16, 8, 0)):
        img[:, k] = (c >> shift) & 255
    img = img.reshape(4096, 4096, 3)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(pt.bgr_to_hsv(img), want)
    for part, w in zip(_chunks(img), _chunks(want)):
        np.testing.assert_array_equal(pt.bgr_to_hsv_plain(part), w)


@pytest.mark.parametrize("width", [256, 37])
def test_hsv_to_bgr_exhaustive(width):
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).astype(np.uint8).reshape(-1, 3)
    rows = -(-len(hsv) // width)
    hsv = np.concatenate([hsv, hsv[: rows * width - len(hsv)]]).reshape(rows, width, 3)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    np.testing.assert_array_equal(pt.hsv_to_bgr(hsv), want)
    for part, w in zip(_chunks(hsv, 4096 * 16 // width), _chunks(want, 4096 * 16 // width)):
        np.testing.assert_array_equal(pt.hsv_to_bgr_plain(part), w)


def test_hsv_to_bgr_hue_past_179():
    """Hues 180-255 (outside what augment_hsv makes) follow cv2 too."""
    hsv = np.stack(np.meshgrid(np.arange(180, 256), np.arange(256), np.arange(0, 256, 3),
                               indexing="ij"), -1).astype(np.uint8).reshape(-1, 64, 3)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    np.testing.assert_array_equal(pt.hsv_to_bgr(hsv), want)
    np.testing.assert_array_equal(pt.hsv_to_bgr_plain(hsv), want)


# --------------------------------------------------------------------- warp
def _warp_cases(kind):
    """(image, matrix, dsize) triples."""
    exp = phase1()
    rs = np.random.default_rng(sum(map(ord, kind)))
    cases = []
    if kind == "phase1":  # the exp's draws on canvases of 2x a 64-128 px input
        for i in range(24):
            ih, iw = (int(v) for v in rs.integers(64, 129, 2))
            m, _ = pt.get_affine_matrix((iw, ih), exp.degrees, exp.translate, exp.mosaic_scale,
                                        exp.shear, rng=random.Random(i))
            cases.append((blurred(rs, 2 * ih, 2 * iw), m, (iw, ih)))
    elif kind == "extremes":  # each draw at the ends of its range
        for angle in (-exp.degrees, exp.degrees):
            for scale in exp.mosaic_scale:
                for sh in (-exp.shear, exp.shear):
                    for tr in (-exp.translate, exp.translate):
                        rot = pt.rotation_matrix_2d(angle, scale)
                        t = np.tan(sh * np.pi / 180)
                        m = np.stack([rot[0] + t * rot[1], rot[1] + t * rot[0]])
                        m[0, 2], m[1, 2] = tr * 100, -tr * 90
                        cases.append((blurred(rs, 180, 200), m, (100, 90)))
    elif kind == "one_pixel":  # 1-pixel and 2-pixel sources: every tap near the border
        for i in range(16):
            h, w = (int(v) for v in rs.integers(1, 3, 2))
            m, _ = pt.get_affine_matrix((33, 17), exp.degrees, exp.translate, (0.1, 2.0),
                                        exp.shear, rng=random.Random(100 + i))
            cases.append((rs.integers(0, 256, (h, w, 3), dtype=np.uint8), m, (33, 17)))
    else:  # widths around cv2's 16-pixel vector step
        for i, dw in enumerate((1, 15, 16, 17, 31, 33, 48, 130)):
            m, _ = pt.get_affine_matrix((dw, 40), exp.degrees, exp.translate, exp.mosaic_scale,
                                        exp.shear, rng=random.Random(200 + i))
            cases.append((blurred(rs, 80, 2 * dw + 2), m, (dw, 40)))
    return cases


@pytest.mark.parametrize("kind", ["phase1", "extremes", "one_pixel", "widths"])
def test_warp_affine_matches_cv2(kind):
    for img, m, dsize in _warp_cases(kind):
        want = cv2.warpAffine(img, m, dsize=dsize, borderValue=(114, 114, 114))
        np.testing.assert_array_equal(pt.warp_affine(img, m, dsize), want)
        np.testing.assert_array_equal(pt.warp_affine_plain(img, m, dsize), want)


def test_affine_matrix_equals_jax():
    exp = phase1()
    for i in range(200):
        tgt = (128 + i, 96 + i // 2)
        got = pt.get_affine_matrix(tgt, exp.degrees, exp.translate, exp.mosaic_scale, exp.shear,
                                   rng=random.Random(i))
        want = jt.get_affine_matrix(tgt, exp.degrees, exp.translate, exp.mosaic_scale, exp.shear,
                                    rng=random.Random(i))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for angle in (-10.0, -3.3, 0.0, 0.1, 7.77, 10.0, 45.0, 90.0):
        for scale in (0.1, 1.0, 1.7):
            np.testing.assert_array_equal(pt.rotation_matrix_2d(angle, scale),
                                          cv2.getRotationMatrix2D((0, 0), angle, scale))


# ------------------------------------------------------- the transforms vs JAX
@pytest.mark.parametrize("seed", range(4))
def test_augment_hsv_equals_jax(seed):
    rs = np.random.default_rng(seed)
    img = blurred(rs, 96, 128 + seed)
    a, b = img.copy(), img.copy()
    pt.augment_hsv(a, rng=random.Random(seed))
    jt.augment_hsv(b, rng=random.Random(seed))
    np.testing.assert_array_equal(a, b)


def _targets(rs, n, h, w):
    xy = rs.uniform(0, [w, h], (n, 2))
    wh = rs.uniform(2, [w / 2, h / 2], (n, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
    return np.concatenate([boxes, rs.integers(0, 80, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_random_affine_equals_jax(seed):
    exp = phase1()
    rs = np.random.default_rng(seed)
    img, tg = blurred(rs, 256, 240), _targets(rs, 5, 256, 240)
    kw = dict(target_size=(120, 128), degrees=exp.degrees, translate=exp.translate,
              scales=exp.mosaic_scale, shear=exp.shear)
    ga, la = pt.random_affine(img, tg.copy(), rng=random.Random(seed), **kw)
    gb, lb = jt.random_affine(img, tg.copy(), rng=random.Random(seed), **kw)
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("case", ["boxes", "empty", "degenerate", "many"])
def test_train_transform_equals_jax(case):
    exp = phase1()
    rs = np.random.default_rng(len(case))
    img = blurred(rs, 100, 140)
    n = {"boxes": 4, "empty": 0, "degenerate": 3, "many": 70}[case]
    tg = _targets(rs, n, 100, 140)
    if case == "degenerate":  # boxes thinner than a pixel after the letterbox
        tg[:, 2] = tg[:, 0] + 0.5
    for seed in range(3):
        a = pt.TrainTransform(max_labels=exp.max_labels_mosaic, flip_prob=exp.flip_prob,
                              hsv_prob=exp.hsv_prob)
        b = jt.TrainTransform(max_labels=exp.max_labels_mosaic, flip_prob=exp.flip_prob,
                              hsv_prob=exp.hsv_prob)
        ia, la = a(img.copy(), tg.copy(), (128, 160), rng=random.Random(seed))
        ib, lb = b(img.copy(), tg.copy(), (128, 160), rng=random.Random(seed))
        assert ia.dtype == ib.dtype == np.float32 and la.dtype == lb.dtype == np.float32
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


# ------------------------------------------------------------- the mosaic
def _datasets(coco_dir, size=(128, 128)):
    kw = dict(data_dir=coco_dir, json_file="instances_train2017.json", name="train2017",
              img_size=size)
    return pcoco.COCODataset(**kw), jcoco.COCODataset(**kw)


def _wrap(module, dataset, transforms, exp, **over):
    kw = dict(mosaic=True, img_size=(128, 128), degrees=exp.degrees, translate=exp.translate,
              mosaic_scale=exp.mosaic_scale, mixup_scale=exp.mixup_scale, shear=exp.shear,
              enable_mixup=exp.enable_mixup, mosaic_prob=exp.mosaic_prob,
              mixup_prob=exp.mixup_prob,
              preproc=transforms.TrainTransform(max_labels=exp.max_labels_mosaic,
                                                flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob))
    kw.update(over)
    return module.MosaicDetection(dataset, **kw)


@pytest.mark.parametrize("mode", ["mosaic_mixup", "mosaic_only", "plain", "closed",
                                  "raw"])
def test_mosaic_fetch_equals_jax(coco_dir, mode):
    exp = phase1()
    pd, jd = _datasets(coco_dir)
    over = {"mosaic_only": dict(enable_mixup=False), "plain": dict(mosaic=False),
            "raw": dict(preproc=None)}.get(mode, {})
    a, b = _wrap(pmosaic, pd, pt, exp, **over), _wrap(jmosaic, jd, jt, exp, **over)
    if mode == "closed":
        a.close_mosaic()
        b.close_mosaic()
    for i in range(len(pd)):
        item = (a.enable_mosaic, i) if i % 2 else i
        ga = a.fetch(item, random.Random(1000 + i))
        gb = b.fetch(item, random.Random(1000 + i))
        np.testing.assert_array_equal(ga[0], gb[0])
        np.testing.assert_array_equal(ga[1], gb[1])
        assert ga[2] == gb[2] and ga[3] == gb[3]


class _Flipping:
    """A dataset whose pull_item sets the wrapper's mosaic flag to True, as a
    concurrent item of a batch sampled before close_mosaic does on the
    loader's threads."""

    def __init__(self, dataset):
        self.dataset, self.wrapper = dataset, None

    def __len__(self):
        return len(self.dataset)

    def pull_item(self, index):
        self.wrapper.enable_mosaic = True
        return self.dataset.pull_item(index)


def test_fetch_reads_its_own_mosaic_flag(coco_dir):
    """An item sampled after close_mosaic, (False, index), whose flag another
    thread sets to True while it runs: the port's item stays without mosaic
    and mixup, as the unraced JAX item; JAX's item reads the shared flag
    again before mixup and blends a partner in (ROADMAP Queue 3)."""
    exp = phase1()
    pd, jd = _datasets(coco_dir)
    out = {}
    for name, module, ds, tr in (("port", pmosaic, pd, pt), ("jax", jmosaic, jd, jt)):
        for raced in (False, True):
            src = _Flipping(ds) if raced else ds
            w = _wrap(module, src, tr, exp, preproc=None)
            if raced:
                src.wrapper = w
            out[name, raced] = w.fetch((False, 3), random.Random(7))
    for k in range(2):
        np.testing.assert_array_equal(out["port", True][k], out["jax", False][k])
        np.testing.assert_array_equal(out["port", False][k], out["jax", False][k])
    assert len(out["jax", True][1]) > len(out["jax", False][1])  # a partner's boxes added


def test_mosaic_helpers_equal_jax():
    rs = np.random.default_rng(0)
    for pos in range(4):
        for xc, yc, w, h in rs.integers(1, 300, (20, 4)):
            args = (pos, int(xc), int(yc), int(w), int(h), 150, 140)
            assert pmosaic._mosaic_tile_coords(*args) == jmosaic._mosaic_tile_coords(*args)
    box = rs.uniform(-20, 200, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(pmosaic.adjust_box_anns(box, 0.7, 13, -4, 120, 110),
                                  jmosaic.adjust_box_anns(box, 0.7, 13, -4, 120, 110))


# ------------------------------------------------------ the loader and exp
def _exp(factory, path, coco_dir, extra=()):
    exp = factory(path)
    exp.merge(SMALL + ["data_dir", coco_dir] + list(extra))
    return exp


def test_loader_batches_equal_jax(coco_dir):
    """The exp's host loader: the first batches, and the batches sampled
    after ``close_mosaic`` (the no-aug epochs), equal JAX's loader's with the
    same seed. The two batches in flight when the switch comes (the loader
    submits two ahead) are left out: whether their items ran before the
    switch, with mixup, depends on the threads' timing, in JAX's loader as
    in the port's. One worker each: JAX's items read a mosaic flag that a
    concurrent item of an earlier batch may set (data/mosaic.py, fetch)."""
    kw = dict(batch_size=3, seed=4)
    one = ["data_num_workers", "1"]
    pl = _exp(port_exp, PORT_EXP, coco_dir, one).get_data_loader(**kw)
    jl = _exp(jax_exp, JAX_EXP, coco_dir, one).get_data_loader(**kw)
    pi, ji = iter(pl), iter(jl)
    for step in range(6):
        if step == 2:
            pl.close_mosaic()
            jl.close_mosaic()
        (ia, la, fa, da), (ib, lb, fb, db) = next(pi), next(ji)
        if step in (2, 3):
            continue
        assert ia.shape == ib.shape == (3, 128, 128, 3) and ia.dtype == ib.dtype == np.float32
        np.testing.assert_array_equal(ia, ib, err_msg=f"step {step}")
        np.testing.assert_array_equal(la, lb, err_msg=f"step {step}")
        assert fa == fb and da == db
    pi.close()
    ji.close()


def test_shipped_exp_trains_on_the_host_path(coco_dir, tmp_path, monkeypatch):
    """exps/p6/yolox_m_p6.py as it ships but cut in depth, width and size:
    the host loader, two steps an epoch, the no-aug switch before epoch 2
    (the trainer closes the mosaic at ``epoch + 1 >= max_epoch -
    no_aug_epochs``, as JAX's does); every loss finite."""
    import sys

    import torch

    from cocodet_tpu_torch.core import trainer as ptr

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    exp = _exp(port_exp, PORT_EXP, coco_dir, ["max_epoch", "3", "warmup_epochs", "1",
                                              "no_aug_epochs", "1", "print_interval", "1",
                                              "output_dir", str(tmp_path)])
    assert exp.device_mosaic is False and exp.device_aug is False

    class Args:
        batch_size, resume, ckpt, cache, no_aug, start_epoch = 5, False, None, False, False, None

    t = ptr.Trainer(exp, Args(), device="cpu")
    t.evaluate_and_save_model = lambda: None
    torch.manual_seed(0)
    t.train()
    assert [s["iterations"] for s in t.epoch_stats] == [2, 2, 2]
    assert [s["use_l1"] for s in t.epoch_stats] == [False, True, True]
    assert all(s["nonfinite_losses"] == 0 for s in t.epoch_stats)
    assert t.train_loader.dataset.enable_mosaic is False  # closed for the no-aug epoch
    losses = t.meter["loss"].latest
    assert np.isfinite(losses)
