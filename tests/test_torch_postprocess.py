"""Port parity: cocodet_tpu_torch/ops/postprocess.py against
cocodet_tpu/ops/postprocess.py on the dense scene of
tests/test_topk_equivalence.py (~8k candidates above conf 0.001 per image).

On f32 head maps every discrete output is exact: which candidates are kept,
their order, classes and validity. The floats (boxes, scores, obj) agree to
4 f32 ulps (rtol 5e-7): XLA and PyTorch ship different exp and sigmoid
implementations, which differ in the last bit on ~10% (exp) and ~0.4%
(sigmoid) of inputs; everything after them is the same f32 arithmetic. With
identical f32 candidates, NMSResult is bit-exact (tests/test_torch_nms.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.ops.postprocess import PostprocessConfig as JaxConfig
from cocodet_tpu.ops.postprocess import postprocess as jax_postprocess
from cocodet_tpu_torch.ops.cuda import nms_kernels as tk
from cocodet_tpu_torch.ops.decode import level_grid
from cocodet_tpu_torch.ops.postprocess import (PostprocessConfig, postprocess,
                                               topk_stable)
from test_topk_equivalence import STRIDES, _dense_scene

ULP4 = dict(rtol=5e-7, atol=1e-6)


def _scene(seeds=(0, 1)):
    """Dense-scene head maps, one image per seed, as numpy NHWC arrays."""
    levels = [_dense_scene(seed)[0] for seed in seeds]
    return [{k: np.concatenate([np.asarray(lv[i][k]) for lv in levels])
             for k in ("reg", "obj", "cls")} for i in range(len(STRIDES))]


def _run_both(maps, topk, nms=0.55, dtype=np.float32, max_det=300):
    jcfg = JaxConfig(conf_threshold=0.001, nms_threshold=nms, pre_nms_topk=topk,
                     max_det=max_det)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jax.jit(lambda o: jax_postprocess(o, STRIDES, jcfg))(
        [{k: jnp.asarray(v).astype(jdt) for k, v in m.items()} for m in maps])
    tcfg = PostprocessConfig(conf_threshold=0.001, nms_threshold=nms,
                             pre_nms_topk=topk, max_det=max_det)
    got = postprocess([{k: torch.from_numpy(v).to(tdt) for k, v in m.items()}
                       for m in maps], STRIDES, tcfg)
    return got, jax.device_get(want)


def _assert_matches(got, want, tol):
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    for field in ("boxes", "scores", "obj"):
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field),
                                   err_msg=field, **tol)


@pytest.mark.parametrize("topk", [1024, 384])
def test_dense_scene_f32(topk):
    """K=1024 is the JAX tile-sequential keep path, K=384 the fixpoint."""
    maps = _scene()
    tk.reset_launch_counts()
    got, want = _run_both(maps, topk)
    assert got.boxes.shape == (2, 300, 4)
    assert int(want.valid.sum()) > 200  # the cap and the NMS both bite
    _assert_matches(got, want, ULP4)
    assert tk.overlap_matrix.launches == 0 and tk.greedy_keep.launches == 0


def test_dense_scene_bf16():
    """bf16 head maps: the ranking runs on the bf16 product of sigmoids,
    which the two frameworks round differently (a bf16 ulp is 2**-8
    relative), so near-equal candidates can swap at the top-K edge. Stated
    tolerance: the same number of detections, and the sorted final scores
    agree within 1% relative."""
    got, want = _run_both(_scene(), 1024, dtype="bf16")
    np.testing.assert_array_equal(got.valid.numpy().sum(1), want.valid.sum(1))
    np.testing.assert_allclose(np.sort(got.scores.numpy(), 1), np.sort(want.scores, 1),
                               rtol=1e-2, atol=1e-6)


def _tie_maps(size=160, n_classes=80):
    """Every anchor ties: logit 0 gives sigmoid 0.5 exactly in both
    frameworks (score 0.25), and every class logit ties too (argmax takes
    the first). Zero box logits decode to stride-wide boxes that only touch
    their neighbours, so NMS keeps all of them and the cap decides."""
    maps = []
    for s in STRIDES:
        h = size // s
        maps.append({"reg": np.zeros((1, h, h, 4), np.float32),
                     "obj": np.zeros((1, h, h, 1), np.float32),
                     "cls": np.zeros((1, h, h, n_classes), np.float32)})
    maps[1]["cls"][0, 0, 1, 5] = 1e-3  # one anchor of level 1 leads (class 5)
    return maps


def test_ties_take_lowest_index_first():
    got, want = _run_both(_tie_maps(), topk=384, max_det=300)
    for field in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    _assert_matches(got, want, ULP4)  # sigmoid(1e-3) of the leader: libm
    assert int(got.classes[0, 0]) == 5 and int(got.classes[0, 1]) == 0
    # the 299 tied survivors are the lowest anchor indices: level 0 row-major
    x1 = got.boxes[0, 1:, 0].numpy()
    np.testing.assert_array_equal(x1[:20], (np.arange(20) - 0.5) * 8)


def test_topk_stable_ties():
    vals = torch.tensor([[.5, .7, .5, .7, -1., -1., .5]])
    top, idx = topk_stable(vals, 5)
    want_top, want_idx = jax.lax.top_k(jnp.asarray(vals.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
    assert idx.tolist() == [[1, 3, 0, 2, 6]]


def test_argmax_first_of_tied_classes():
    logits = np.zeros((3, 80), np.float32)
    logits[1, [7, 9]] = 1.0
    assert torch.from_numpy(logits).argmax(-1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(logits), -1)).tolist() == [0, 7, 0]


def test_level_grid_x_fastest():
    from cocodet_tpu.ops.decode import level_grid as jax_level_grid

    np.testing.assert_array_equal(level_grid(3, 5, device="cpu").numpy(),
                                  np.asarray(jax_level_grid(3, 5)))


@pytest.mark.parametrize("cfg", [PostprocessConfig(multi_class=True),
                                 PostprocessConfig(rmmop=(1.0, 0.01))])
def test_other_filters_not_ported(cfg):
    """The multi-class and RMMOP filters (select_candidates), which raised
    until they were ported, against JAX on the dense scene: every discrete
    output exact, the floats within 4 ulps. RMMOP applies no conf
    threshold, multi-class ranks every (anchor, class) pair."""
    maps = _scene()
    kw = dict(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=1024, max_det=300,
              multi_class=cfg.multi_class, rmmop=cfg.rmmop)
    want = jax.device_get(jax.jit(lambda o: jax_postprocess(o, STRIDES, JaxConfig(**kw)))(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in maps]))
    tk.reset_launch_counts()
    got = postprocess([{k: torch.from_numpy(v) for k, v in m.items()} for m in maps],
                      STRIDES, PostprocessConfig(**kw))
    assert int(want.valid.sum()) > 200
    _assert_matches(got, want, ULP4)
    assert tk.overlap_matrix.launches == 0


@pytest.mark.parametrize("case", ["rmmop_no_conf", "multi_class_small_k", "max_class"])
def test_select_candidates_matches_jax(case):
    """select_candidates alone, batched, on decoded random scores: RMMOP
    keeps candidates below the conf threshold; multi-class at a K that
    cuts the (anchor, class) pairs; max-class."""
    from cocodet_tpu.ops.postprocess import select_candidates as jax_select
    from cocodet_tpu_torch.ops.postprocess import select_candidates

    rs = np.random.RandomState(3)
    b, a, c = 2, 300, 6
    boxes = rs.uniform(0, 100, (b, a, 4)).astype(np.float32)
    obj = rs.uniform(0, 1, (b, a, 1)).astype(np.float32)
    cls = (np.round(rs.uniform(0, 1, (b, a, c)), 2) * obj).astype(np.float32)  # ties
    kw = {"rmmop_no_conf": dict(rmmop=(1.2, 0.5), conf_threshold=0.9, pre_nms_topk=64),
          "multi_class_small_k": dict(multi_class=True, conf_threshold=0.2, pre_nms_topk=100),
          "max_class": dict(conf_threshold=0.3, pre_nms_topk=128)}[case]
    want = jax.vmap(lambda x, o, k: jax_select(x, o, k, JaxConfig(**kw)))(
        jnp.asarray(boxes), jnp.asarray(obj), jnp.asarray(cls))
    got = select_candidates(torch.from_numpy(boxes), torch.from_numpy(obj),
                            torch.from_numpy(cls), PostprocessConfig(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "rmmop_no_conf":
        assert bool(((got[1] < 0.9) & got[4]).any())


def test_soft_nms_not_ported():
    """Soft-NMS is ported (the name is the test's from before): the dense
    scene through ``postprocess`` with ``soft`` against JAX's, K=256,
    max_det 100. The decoded candidates differ by up to 4 ulps and the
    decay multiplies up to K factors, so the decayed scores are held at
    2 * 2**-23 * (K + 1) relative on top of ULP4; the kept rows, their
    order and classes exactly, after a check that no two kept rows' scores
    lie within twice the largest score difference (no near-tie)."""
    maps = _scene()
    jcfg = JaxConfig(conf_threshold=0.001, nms_threshold=0.55, pre_nms_topk=256,
                     max_det=100, soft=True)
    want = jax.device_get(jax.jit(lambda o: jax_postprocess(o, STRIDES, jcfg))(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in maps]))
    got = postprocess([{k: torch.from_numpy(v) for k, v in m.items()} for m in maps],
                      STRIDES, PostprocessConfig(conf_threshold=0.001, nms_threshold=0.55,
                                                 pre_nms_topk=256, max_det=100, soft=True))
    diff = np.max(np.abs(got.scores.numpy() - want.scores))
    for b in range(2):
        s = want.scores[b][want.valid[b]]
        assert len(s) == 100 and (s[:-1] - s[1:] > 2 * diff).all()
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    for field in ("boxes", "obj"):
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field),
                                   err_msg=field, **ULP4)
    np.testing.assert_allclose(got.scores.numpy(), want.scores,
                               rtol=ULP4["rtol"] + 2 * 2.0 ** -23 * 257, atol=ULP4["atol"])


def test_chip_smoke_scene_is_the_dense_scene():
    """chip_smoke.py checks the kernels on a numpy copy of this scene."""
    import chip_smoke

    for seed in (0, 3):
        want = _dense_scene(seed)[0]
        got = chip_smoke.dense_scene(seed)
        for g, w in zip(got, want):
            for key in ("reg", "obj", "cls"):
                np.testing.assert_array_equal(g[key], np.asarray(w[key]))
