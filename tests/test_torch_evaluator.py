"""The port's COCO evaluator (cocodet_tpu_torch/evaluators/coco_evaluator.py,
entry.build_evaluator) against the JAX package's.

- The crafted model of chip_smoke.py (head maps that decode to each
  image's ground truth) through the whole chain (PNG read, resize,
  letterbox, forward, decode, NMS, scale-back, 80 -> 91 ids, mAP): AP50 is
  1.0 and AP at least 0.99; every box moved gives AP50 below 0.2, the
  conditions of tests/test_evaluator_e2e.py.
- The evaluators side by side over the same JAX ``COCODataset`` items (so
  the resize is out of the comparison): with a depth 0.33 / width 0.125
  YOLOX-P6 at 128 px replayed as fixed head maps, the records agree as the
  postprocess does (tests/test_torch_postprocess.py: ids and classes
  exact, scores and box corners within 4 f32 ulps, rtol 5e-7, a width or
  height within 4 ulps of its larger corner) and the 12 stats
  are equal; with the model run by each framework, the records are the
  same sets at tests/test_torch_entry.py's tolerances (boxes 0.01 px +
  1e-3 relative, scores 1e-4; the convs sum in another order) and the
  stats are equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cocodet_tpu.data.coco import COCODataset as JaxDataset
from cocodet_tpu.data.transforms import ValTransform as JaxVal
from cocodet_tpu.evaluators import COCOEvaluator as JaxEvaluator
from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.ops.fuse import fuse_batchnorm as jax_fuse_batchnorm
from cocodet_tpu_torch import entry
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.evaluators.coco_evaluator import COCOEvaluator
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.ops.cuda import nms_kernels as nk
from cocodet_tpu_torch.utils.convert import random_variables
from torch_port_utils import private_native_builds


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native letterbox and COCO matcher, built for this process before any JAX
    reference runs (tests/torch_port_utils.py::private_native_builds)."""
    with private_native_builds(tmp_path_factory.mktemp("jax_native"), coco_eval=True) as paths:
        yield paths

SIZE = 128
STRIDES = (8, 16, 32, 64)


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("val"))
    return make_synthetic_coco(root, n_train=0, n_val=6, size_range=(64, 200), seed=11)


@pytest.mark.parametrize("moved", [False, True])
def test_crafted_model(val_set, moved):
    ev = entry.build_evaluator(val_set, img_size=SIZE, batch_size=4)
    assert (ev.conf_threshold, ev.nms_threshold, ev.pre_nms_topk, ev.max_det) == \
        (0.001, 0.65, 2000, 300)
    model = chip_smoke.crafted_model(chip_smoke.crafted_boxes(ev.dataset, SIZE, moved), "cpu")
    ap, ap50, summary = ev.evaluate(entry.Predictor(model))
    assert model.dropped == 0 and model.served == 8
    if moved:
        assert ap50 < 0.2, summary
    else:
        assert ap50 == pytest.approx(1.0), summary
        assert ap >= 0.99, summary
    assert ev.stats == ev.evaluate_prediction(ev.records, use_native=False)


def test_build_evaluator_defaults(val_set):
    """The competition exp's point (exps/p6/yolox_m_p6.py:37-39) and the
    evaluator's top-K and max_det."""
    ev = entry.build_evaluator(val_set)
    assert ev.img_size == (768, 768) and ev.batch_size == 16
    assert ev.postprocess_config == entry.PostprocessConfig(
        conf_threshold=0.001, nms_threshold=0.65, pre_nms_topk=2000, max_det=300)
    assert ev.dataset[0][0].shape == (768, 768, 3)


class _Replay(torch.nn.Module):
    """Returns fixed head maps (one batch)."""

    def __init__(self, maps):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))
        self.strides = STRIDES
        self.maps = maps

    def forward(self, images):
        return [{k: torch.from_numpy(v) for k, v in m.items()} for m in self.maps]


class _JaxReplay:
    def __init__(self, maps):
        self.maps = maps

    def apply(self, variables, images):
        return [{k: jnp.asarray(v) for k, v in m.items()} for m in self.maps]


class _Exp:
    strides = STRIDES


def _small_model():
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    variables = random_variables(shapes, seed=2)
    jm = jax_build_model("yolox-p6", depth=0.33, width=0.125, fused=True)
    return variables, jm, jax_fuse_batchnorm(variables)


def _records_by_image(records):
    out = {}
    for r in records:
        out.setdefault(r["image_id"], []).append(r)
    return out


def _assert_records_match(got, want, rtol, atol, as_sets=False):
    g, w = _records_by_image(got), _records_by_image(want)
    assert g.keys() == w.keys()
    for img, wr in w.items():
        gr = g[img]
        assert len(gr) == len(wr)
        gb = np.asarray([r["bbox"] + [r["score"]] for r in gr])
        wb = np.asarray([r["bbox"] + [r["score"]] for r in wr])
        gc = np.asarray([r["category_id"] for r in gr])
        wc = np.asarray([r["category_id"] for r in wr])
        if not as_sets:
            # a width is x2 - x1: its error is ulps of the corners, not of itself
            corner = np.abs(np.concatenate([wb[:, :2], wb[:, :2] + wb[:, 2:4]], 1)).max(1)
            tol = np.concatenate([np.repeat(rtol * corner[:, None], 4, 1),
                                  rtol * np.abs(wb[:, 4:])], 1) + atol
            np.testing.assert_array_equal(gc, wc)
            assert (np.abs(gb - wb) <= tol).all(), np.abs(gb - wb).max()
            continue
        tol = np.concatenate([atol[0] + atol[1] * np.abs(wb[:, :4]),
                              np.full((len(wb), 1), atol[2])], 1)
        close = (np.abs(gb[:, None] - wb[None]) <= tol[None]).all(-1) & (gc[:, None] == wc[None])
        assert close.any(1).all() and close.any(0).all()


def test_evaluator_matches_jax_on_replayed_maps(val_set, tmp_path):
    variables, jm, fused = _small_model()
    ds = JaxDataset(val_set, json_file="instances_val2017.json", name="val2017",
                    img_size=(SIZE, SIZE), preproc=JaxVal())
    kw = dict(img_size=(SIZE, SIZE), conf_threshold=0.001, nms_threshold=0.65,
              batch_size=8, pre_nms_topk=2000, max_det=300)
    want_ev, got_ev = JaxEvaluator(ds, **kw), COCOEvaluator(ds, **kw)
    imgs = next(iter(got_ev._batches()))[0]  # one batch: 6 images, 2 of padding
    maps = [{k: np.array(v, np.float32) for k, v in m.items()}
            for m in jax.jit(jm.apply)(fused, jnp.asarray(imgs))]
    want_json = tmp_path / "want.json"
    want = want_ev.evaluate(_Exp(), {}, model=_JaxReplay(maps), output_json=str(want_json))
    nk.reset_launch_counts()
    got = got_ev.evaluate(entry.Predictor(_Replay(maps)))
    assert nk.overlap_matrix.launches == 0  # the CPU takes the plain versions
    want_recs = json.loads(want_json.read_text())
    assert len(want_recs) > 100
    _assert_records_match(got_ev.records, want_recs, rtol=5e-7, atol=1e-6)
    assert got[:2] == want[:2]
    assert got_ev.stats == want_ev.evaluate_prediction(want_recs)
    assert all(isinstance(v, float) for v in got_ev.records[0]["bbox"])


def test_evaluator_matches_jax_with_the_model(val_set, tmp_path):
    variables, jm, fused = _small_model()
    ds = JaxDataset(val_set, json_file="instances_val2017.json", name="val2017",
                    img_size=(SIZE, SIZE), preproc=JaxVal())
    kw = dict(img_size=(SIZE, SIZE), conf_threshold=0.001, nms_threshold=0.65,
              batch_size=4, pre_nms_topk=2000, max_det=300)
    want_ev, got_ev = JaxEvaluator(ds, **kw), COCOEvaluator(ds, **kw)
    want_json, got_json = tmp_path / "want.json", tmp_path / "got.json"
    want = want_ev.evaluate(_Exp(), fused, model=jm, output_json=str(want_json))
    predictor = entry.build_predictor(variables, depth=0.33, width=0.125,
                                      dtype=torch.float32, device="cpu")
    got = got_ev.evaluate(predictor, output_json=str(got_json))
    want_recs = json.loads(want_json.read_text())
    assert got_ev.records == json.loads(got_json.read_text())
    assert len(want_recs) == 6 * 300
    _assert_records_match(got_ev.records, want_recs, None, (1e-2, 1e-3, 1e-4), as_sets=True)
    assert got[:2] == want[:2]
    assert got_ev.stats == want_ev.evaluate_prediction(want_recs)
