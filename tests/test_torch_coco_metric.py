"""The port's COCO mAP (cocodet_tpu_torch/evaluators/coco_metric.py) and
its native matcher (evaluators/fast_coco_eval.py over
csrc/host/cocoeval.cpp) against the JAX package's, on fuzzed ground truth
and detections: crowds, every area range, score ties across images, and
maxDets other than the default.

Tolerance: none. Both are float64 numpy over the same arithmetic, so the
12 stats and the per-class APs are equal, not close, with either matcher;
against the brute-force oracle of tests/cocoeval_oracle.py (another
arithmetic) they agree to 1e-9, as the JAX package's own test holds them.
"""

import json

import numpy as np
import pytest

import cocoeval_oracle
from cocodet_tpu.evaluators import coco_metric as jm
from cocodet_tpu.layers import fast_coco_eval as jfce
from cocodet_tpu_torch.evaluators import coco_metric as tm
from cocodet_tpu_torch.evaluators import fast_coco_eval as tfce
from test_coco_metric import _random_scene
from torch_port_utils import private_native_builds


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native letterbox and COCO matcher, built for this process before any JAX
    reference runs (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native"), coco_eval=True) as paths:
        yield paths


def _fuzzed(seed):
    """_random_scene plus detections with many boxes per image, so maxDets
    truncates, and boxes of every area range."""
    gts, dts = _random_scene(seed, n_imgs=8, n_cats=4)
    rs = np.random.RandomState(100 + seed)
    for img in range(3):
        for _ in range(40):
            w, h = np.exp(rs.uniform(np.log(3), np.log(200), 2))
            x, y = rs.uniform(0, 400, 2)
            dts.append({"image_id": img, "category_id": int(rs.randint(1, 5)),
                        "bbox": [float(x), float(y), float(w), float(h)],
                        "score": round(float(rs.rand()), 3)})
    return gts, dts


def _metrics(module, gts, dts, **kw):
    m = module.COCOMeanAP(**kw)
    m.add_gt_annotations(gts)
    m.add_detections(dts)
    return m


CASES = [(seed, native, max_dets) for seed in (0, 1, 2) for native in (True, False)
         for max_dets in (jm.MAX_DETS,)] + [(3, True, (1, 5, 20)), (4, False, (2, 7, 50))]


@pytest.mark.parametrize("seed,native,max_dets", CASES)
def test_stats_equal_jax(seed, native, max_dets):
    gts, dts = _fuzzed(seed)
    got = _metrics(tm, gts, dts, use_native=native, max_dets=max_dets)
    want = _metrics(jm, gts, dts, use_native=native, max_dets=max_dets)
    if max_dets == jm.MAX_DETS:
        assert got.summarize() == want.summarize()
    acc_g, acc_w = got.accumulate(), want.accumulate()
    for key in ("precision", "recall"):
        np.testing.assert_array_equal(acc_g[key], acc_w[key])
    for iou in (None, 0.5, 0.75):
        a, b = (m.per_class_ap(iou=iou, max_det=max_dets[-1]) for m in (got, want))
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(np.asarray(list(a.values())),
                                      np.asarray(list(b.values())))


@pytest.mark.parametrize("native", [True, False])
def test_stats_against_oracle(native):
    gts, dts = _fuzzed(5)
    got = _metrics(tm, gts, dts, use_native=native).summarize()
    want = cocoeval_oracle.evaluate(gts, dts)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_native_matcher_equals_plain_and_jax():
    rs = np.random.RandomState(0)
    thrs = tm.IOU_THRS
    for trial in range(30):
        nd, ng = rs.randint(0, 12), rs.randint(0, 9)
        ious = np.round(rs.rand(nd, ng), 2)  # ties between GTs
        ign = np.sort(rs.rand(ng) < 0.3)     # ignore-last
        crowd = ign & (rs.rand(ng) < 0.5)
        got = tfce.match_image(ious, ign, crowd, thrs)
        for want in (tm.match_image(ious, ign, crowd, thrs),
                     jfce.match_image(ious, ign, crowd, thrs)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_native_accumulate_equals_jax():
    rs = np.random.RandomState(1)
    for nd in (0, 1, 7, 50):
        matched = rs.rand(nd) < 0.6
        ignored = rs.rand(nd) < 0.1
        npig = int(matched.sum()) + 3
        got = tfce.accumulate_pr(matched, ignored, npig, tm.RECALL_THRS)
        want = jfce.accumulate_pr(matched, ignored, npig, jm.RECALL_THRS)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_box_iou_equals_jax():
    rs = np.random.RandomState(2)
    d, g = rs.uniform(0, 50, (7, 4)), rs.uniform(0, 50, (5, 4))
    crowd = np.asarray([0, 1, 0, 0, 1])
    np.testing.assert_array_equal(tm.box_iou_xywh(d, g, crowd), jm.box_iou_xywh(d, g, crowd))
    assert tm.box_iou_xywh(d[:0], g, crowd).shape == (0, 5)


def test_score_detections_json_equals_jax(tmp_path):
    gts, dts = _fuzzed(6)
    images = [{"id": i, "file_name": f"img_{i}.png", "width": 500, "height": 500}
              for i in range(8)]
    # string ids (the harness's non-numeric names), a header, a dummy record
    dts = [dict(d, image_id=f"img_{d['image_id']}") if k % 3 == 0 else d
           for k, d in enumerate(dts)]
    dts = [{"framework": "x", "parameters": 1}] + dts + [{"image_id": "unknown.png",
                                                           "category_id": 1, "score": 0.0}]
    gt_path, det_path = tmp_path / "gt.json", tmp_path / "det.json"
    gt_path.write_text(json.dumps({"images": images, "annotations": gts, "categories": []}))
    det_path.write_text(json.dumps(dts))
    got = tm.score_detections_json(str(gt_path), str(det_path))
    want = jm.score_detections_json(str(gt_path), str(det_path))
    assert got == want
    assert got == tm.score_detections_json(json.loads(gt_path.read_text()), str(det_path))
