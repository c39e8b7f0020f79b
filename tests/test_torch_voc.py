"""Port parity: PASCAL VOC (cocodet_tpu_torch/data/voc.py,
evaluators/voc_evaluator.py, exps/example/) against cocodet_tpu's, on
trees written by ``data/synthetic.py::make_synthetic_voc``.

Exact throughout: the XML parse and the dataset items bit for bit (the port
decodes and resizes as cv2 does), ``voc_ap`` and ``eval_class`` on seeded
detections, the host mosaic's items, and both evaluators' mAP where their
frames agree. The evaluators are fed one stub's detections (a fixed
``NMSResult`` a batch in place of the model and its postprocess), so what
they are held to is their own bookkeeping: the letterbox, the frame, the
ground truths, the matching.

The frame. JAX's evaluator divides the detections by the letterbox ratio
of the already resized image and scores them against the XML boxes in
original pixels (cocodet_tpu/evaluators/voc_evaluator.py:122-152): it
agrees with the port only where the longer side is the test size (``r0 =
1``). Elsewhere a perfect detector scores 1.0 in the port and below it in
JAX (ROADMAP Queue 3).
"""

import importlib
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cocodet_tpu.data import mosaic as jmosaic
from cocodet_tpu.data import transforms as jt
from cocodet_tpu.data import voc as jvoc
from cocodet_tpu.evaluators import voc_evaluator as jeval
from cocodet_tpu.ops.nms import NMSResult as JaxResult
from cocodet_tpu_torch import entry
from cocodet_tpu_torch.data import mosaic as pmosaic
from cocodet_tpu_torch.data import transforms as pt
from cocodet_tpu_torch.data import voc as pvoc
from cocodet_tpu_torch.data.synthetic import make_synthetic_voc
from cocodet_tpu_torch.evaluators import voc_evaluator as peval
from cocodet_tpu_torch.exp import Exp
from cocodet_tpu_torch.ops.nms import NMSResult
from torch_port_utils import private_native_builds

jpost = importlib.import_module("cocodet_tpu.ops.postprocess")

SETS = (("2007", "trainval", 6), ("2007", "test", 5), ("2012", "trainval", 3))
SIZE = (96, 96)


@pytest.fixture(scope="module", autouse=True)
def native(tmp_path_factory):
    with private_native_builds(tmp_path_factory.mktemp("native")):
        yield


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), sets=SETS,
                              size_range=(80, 160), seed=3)


@pytest.fixture(scope="module")
def square(tmp_path_factory):
    """A tree whose images' longer side is the test size: r0 = 1."""
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc_r0")),
                              sets=(("2007", "test", 7),), size_range=(60, 96),
                              long_side=SIZE[0], seed=4)


IMAGE_SETS = tuple((y, s) for y, s, _ in SETS)


def test_parse_voc_xml_equals_jax(devkit):
    ds = pvoc.VOCDetection(devkit, IMAGE_SETS)
    names = set()
    for i in range(len(ds)):
        path = ds.annotation_path(i)
        with open(path) as f:
            names |= {line.split("<name>")[1].split("</name>")[0]
                      for line in f if "<name>" in line}
        for keep in (False, True):
            got, gd = pvoc.parse_voc_xml(path, keep)
            want, wd = jvoc.parse_voc_xml(path, keep)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            assert gd == wd
    # the tree exercises the difficult flag, unknown names and case
    assert "zebra" in names and any(n != n.strip().lower() for n in names)
    flags = [d for i in range(len(ds)) for d in pvoc.parse_voc_xml(ds.annotation_path(i),
                                                                    True)[1]]
    assert 0 < sum(flags) < len(flags)


def test_pull_item_equals_jax(devkit):
    got = pvoc.VOCDetection(devkit, IMAGE_SETS, img_size=SIZE)
    want = jvoc.VOCDetection(devkit, IMAGE_SETS, img_size=SIZE)
    assert got.items == want.items and len(got) == sum(n for _, _, n in SETS)
    for i in range(len(got)):
        a, b = got.pull_item(i), want.pull_item(i)
        assert a[0].dtype == b[0].dtype == np.uint8
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]


def test_voc_ap_and_eval_class_equal_jax():
    rs = np.random.RandomState(0)
    for _ in range(5):
        rec = np.sort(rs.uniform(0, 1, 30))
        prec = rs.uniform(0, 1, 30)
        for m in (False, True):
            assert peval.voc_ap(rec, prec, m) == jeval.voc_ap(rec, prec, m)
    for trial in range(20):
        gts = {}
        for img in range(4):
            n = int(rs.randint(0, 4))
            xy = rs.uniform(0, 80, (n, 2))
            wh = rs.uniform(5, 40, (n, 2))
            gts[img] = (np.concatenate([xy, xy + wh], 1).astype(np.float32),
                        rs.uniform(size=n) < 0.2)
        dets = []
        for _ in range(int(rs.randint(0, 12))):
            img = int(rs.randint(0, 5))  # image 4 has no ground truth
            b, _ = gts.get(img, (np.zeros((0, 4), np.float32), None))
            if len(b) and rs.uniform() < 0.7:
                box = b[rs.randint(len(b))] + rs.normal(0, 3, 4)
            else:
                box = np.concatenate([rs.uniform(0, 80, 2), rs.uniform(80, 120, 2)])
            dets.append((img, float(rs.uniform()), box.astype(np.float32)))
        for m in (False, True):
            got = peval.eval_class(list(dets), gts, use_07_metric=m)
            want = jeval.eval_class(list(dets), gts, use_07_metric=m)
            assert got == want or (np.isnan(got) and np.isnan(want)), trial


def _detections(ds, perfect, size=SIZE, max_det=16, seed=0):
    """One batch of the whole set in the network's frame: each image's XML
    boxes times min(size / h, size / w), jittered and mixed with false
    positives; ``perfect``: the boxes that are not difficult, exactly (a
    detection of a class whose boxes are all difficult scores AP 0)."""
    rs = np.random.RandomState(seed)
    n = len(ds)
    boxes = np.zeros((n, max_det, 4), np.float32)
    scores = np.zeros((n, max_det), np.float32)
    classes = np.zeros((n, max_det), np.int32)
    valid = np.zeros((n, max_det), bool)
    for i in range(n):
        gt, _ = pvoc.parse_voc_xml(ds.annotation_path(i), keep_difficult=not perfect)
        h, w = pvoc.read_image(os.path.join(ds.items[i][0], "JPEGImages",
                                            f"{ds.items[i][1]}.jpg")).shape[:2]
        s = min(size[0] / h, size[1] / w)
        rows = [(g[:4] * s, int(g[4]), 0.9 if perfect else float(rs.uniform(0.3, 1)))
                for g in gt]
        if not perfect:
            rows = [(b + rs.normal(0, 2, 4), c if rs.uniform() < 0.8 else int(rs.randint(20)),
                     sc) for b, c, sc in rows]
            for _ in range(int(rs.randint(0, 4))):
                xy = rs.uniform(0, size[0] - 20, 2)
                rows.append((np.concatenate([xy, xy + rs.uniform(5, 20, 2)]),
                             int(rs.randint(20)), float(rs.uniform(0, 1))))
        rows = sorted(rows, key=lambda r: -r[2])[:max_det]
        for j, (b, c, sc) in enumerate(rows):
            boxes[i, j], classes[i, j], scores[i, j], valid[i, j] = b, c, sc, True
    return boxes, scores, classes, valid


def _port_map(monkeypatch, ds, dets, use_07):
    """The port's VOCEvaluator on ``dets`` (one batch of the whole set)."""

    class Stub:
        def __init__(self, model, cfg):
            pass

        def __call__(self, imgs):
            assert imgs.shape == (len(ds), *SIZE, 3)
            b, s, c, v = (torch.from_numpy(a) for a in dets)
            return NMSResult(b, s, c, s, v)

    monkeypatch.setattr(entry, "Predictor", Stub)
    ev = peval.VOCEvaluator(ds, img_size=SIZE, batch_size=len(ds), use_07_metric=use_07)
    ap, ap50, _ = ev.evaluate(type("P", (), {"model": None})())
    assert ap == ap50 == ev.stats["mAP"]
    return ap, ev


def _jax_map(monkeypatch, ds, dets, use_07):
    """JAX's VOCEvaluator on the same detections (its postprocess stubbed;
    jitted once, for the one batch)."""
    consts = tuple(jnp.asarray(a) for a in dets)
    monkeypatch.setattr(jpost, "postprocess", lambda outputs, strides, cfg: JaxResult(
        consts[0], consts[1], consts[2], consts[1], consts[3]))
    model = type("M", (), {"apply": staticmethod(lambda v, imgs: imgs)})()
    exp = type("E", (), {"strides": (8, 16, 32)})()
    ev = jeval.VOCEvaluator(ds, img_size=SIZE, batch_size=len(ds), use_07_metric=use_07)
    ap, ap50, _ = ev.evaluate(exp, {}, model=model)
    return ap


@pytest.mark.parametrize("use_07", [False, True], ids=["all_point", "07"])
def test_evaluator_equals_jax_where_r0_is_1(monkeypatch, square, use_07):
    ds_p = pvoc.VOCDetection(square, (("2007", "test"),), img_size=SIZE)
    ds_j = jvoc.VOCDetection(square, (("2007", "test"),), img_size=SIZE)
    dets = _detections(ds_p, perfect=False)
    got, ev = _port_map(monkeypatch, ds_p, dets, use_07)
    want = _jax_map(monkeypatch, ds_j, dets, use_07)
    assert 0.05 < want < 0.95
    assert got == want
    # the records give the mAP again on the host, both metrics
    assert ev.evaluate_prediction(ev.records, use_07)["mAP"] == got
    assert len(ev.records) == int(dets[3].sum())


def test_jax_frame_fault(monkeypatch, devkit):
    """A perfect detector: 1.0 in the port, below 1.0 in JAX, whose
    detections stay r0 times too small (r0 = 96 / the longer side here)."""
    sets = (("2007", "trainval"),)
    ds_p = pvoc.VOCDetection(devkit, sets, img_size=SIZE)
    ds_j = jvoc.VOCDetection(devkit, sets, img_size=SIZE)
    dets = _detections(ds_p, perfect=True)
    got, ev = _port_map(monkeypatch, ds_p, dets, use_07=False)
    want = _jax_map(monkeypatch, ds_j, dets, use_07=False)
    assert got == 1.0
    assert want < 0.5


def _mosaic(module, transforms, dataset, **over):
    exp = Exp()
    kw = dict(mosaic=True, img_size=(128, 128), degrees=exp.degrees, translate=exp.translate,
              mosaic_scale=exp.mosaic_scale, mixup_scale=exp.mixup_scale, shear=exp.shear,
              enable_mixup=exp.enable_mixup, mosaic_prob=exp.mosaic_prob,
              mixup_prob=exp.mixup_prob,
              preproc=transforms.TrainTransform(max_labels=exp.max_labels_mosaic,
                                                flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob))
    kw.update(over)
    return module.MosaicDetection(dataset, **kw)


@pytest.mark.parametrize("mode", ["mosaic_mixup", "plain"])
def test_host_mosaic_over_voc_equals_jax(devkit, mode):
    over = {"plain": dict(mosaic=False)}.get(mode, {})
    a = _mosaic(pmosaic, pt, pvoc.VOCDetection(devkit, IMAGE_SETS, img_size=(128, 128)), **over)
    b = _mosaic(jmosaic, jt, jvoc.VOCDetection(devkit, IMAGE_SETS, img_size=(128, 128)), **over)
    for i in range(4):
        ga = a.fetch(i, random.Random(500 + i))
        gb = b.fetch(i, random.Random(500 + i))
        np.testing.assert_array_equal(ga[0], gb[0])
        np.testing.assert_array_equal(ga[1], gb[1])
        assert ga[2] == gb[2] and ga[3] == gb[3]


def test_device_mosaic_refuses_voc(devkit):
    from cocodet_tpu_torch.data.device_mosaic import DeviceMosaicDataset

    with pytest.raises(TypeError, match="annotations"):
        DeviceMosaicDataset(pvoc.VOCDetection(devkit, IMAGE_SETS), img_size=(128, 128))


def test_voc_exp_builds_the_voc_objects(devkit):
    """The VOC exp's factories equal JAX's: the train set (2007 + 2012
    trainval at input_size, TrainTransform with max_labels) and the
    evaluator (2007 test at test_size, test_conf, NMS, 20 classes)."""
    from cocodet_tpu import exp as jexp
    from cocodet_tpu_torch import exp as pexp

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.join("example", "yolox_voc", "yolox_voc_s.py")
    port = pexp.get_exp_by_file(os.path.join(repo, "cocodet_tpu_torch", "exps", rel))
    ref = jexp.get_exp_by_file(os.path.join(repo, "exps", rel))
    for e in (port, ref):
        e.data_dir = os.path.dirname(devkit)
    a, b = port.get_dataset(), ref.get_dataset()
    assert a.items == b.items and a.img_size == b.img_size == (640, 640)
    assert isinstance(a.preproc, pt.TrainTransform)
    assert vars(a.preproc) == vars(b.preproc)
    ea, eb = port.get_evaluator(batch_size=4), ref.get_evaluator(batch_size=4)
    assert isinstance(ea, peval.VOCEvaluator)
    assert ea.dataset.items == eb.dataset.items
    for k in ("img_size", "conf_threshold", "nms_threshold", "num_classes", "batch_size",
              "use_07_metric"):
        assert getattr(ea, k) == getattr(eb, k), k
