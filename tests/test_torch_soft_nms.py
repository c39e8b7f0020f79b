"""Port parity: the Gaussian soft-NMS of cocodet_tpu_torch (ops/cuda/
soft_nms.py::soft_decay_plain, ops/nms.py::batched_nms(soft=True)) against
cocodet_tpu/ops/nms.py (``_soft_keep_scores`` and the soft branch of
``nms_single``), on f32 candidates on the CPU.

Tolerance of the decayed scores: XLA's f32 ``exp`` and torch's differ in the
last bit on ~13% of this chain's inputs, and each row's score is a product
of one factor per valid row before it, each product rounded. So row j is
held at a relative 2 * 2**-23 * (n_j + 1), n_j the valid rows before it
(measured: 4.6e-7 at 54 factors, inside 1.3e-5). Every discrete output (the
kept rows, their order, classes, boxes, obj) is exact on inputs whose
decayed scores have no near-tie, which each test checks on JAX's output
before it compares.

Subnormals: XLA flushes them to zero on the CPU (and the TPU has none); the
port flushes each product below FLT_MIN the same way, so in a dense cluster
whose products leave the normal range the kept rows are JAX's exactly
(without the flush, torch on the CPU kept 10 rows of an 80-row cluster that
JAX drops).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.ops import nms as jnms
from cocodet_tpu_torch.ops import nms as tnms
from cocodet_tpu_torch.ops.boxes import pairwise_iou
from cocodet_tpu_torch.ops.cuda import soft_nms as sk

ULP = 2.0 ** -23
FLT_MIN = float(np.finfo(np.float32).tiny)


def _candidates(batch, k, seed, n_classes=3, spread=120.0):
    """Score-sorted candidates in a small scene, so that many pairs overlap."""
    rs = np.random.RandomState(seed)
    centers = rs.rand(batch, k, 2) * spread
    wh = rs.rand(batch, k, 2) * 40 + 4
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rs.uniform(0.001, 1.0, (batch, k)).astype(np.float32), axis=1)[:, ::-1]
    classes = rs.randint(0, n_classes, (batch, k)).astype(np.int32)
    obj = rs.rand(batch, k).astype(np.float32)
    valid = rs.rand(batch, k) > 0.15
    return boxes, np.ascontiguousarray(scores), classes, obj, valid


def _cluster(k=80, seed=0):
    """One image: ``k`` near-copies of one box, one class, all valid: the
    products of the later rows leave the normal f32 range."""
    rs = np.random.RandomState(seed)
    boxes = (np.array([[10, 10, 50, 50]], np.float32)
             + rs.uniform(0, 3, (k, 4)).astype(np.float32))[None]
    scores = np.sort(rs.uniform(0.3, 0.9, k).astype(np.float32))[::-1][None].copy()
    return (boxes, scores, np.zeros((1, k), np.int32), rs.rand(1, k).astype(np.float32),
            np.ones((1, k), bool))


def _jax_decay(boxes, scores, valid):
    fn = jax.jit(jax.vmap(lambda b, s, v: jnms._soft_keep_scores(b, s, v, 0.5)))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))


def _rtol(valid):
    """Each row's relative tolerance: 2 ulp per factor, one factor per valid
    row before it."""
    before = np.cumsum(valid, axis=1) - valid
    return 2 * ULP * (before + 1)


def _assert_decay_close(got, want, valid):
    rtol = _rtol(valid)
    # no JAX value sits where the flush could go either way
    nonzero = want != 0
    assert not (nonzero & (np.abs(want) < FLT_MIN * (1 + rtol))).any()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (np.abs(got - want) <= rtol * np.abs(want)).all(), \
        np.max(np.abs(got - want) / np.maximum(np.abs(want), FLT_MIN) / rtol)


def _offset(boxes, classes, valid):
    return tnms.class_offset_boxes(torch.from_numpy(boxes), torch.from_numpy(classes),
                                   torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("k", [64, 200, 1024, 2000])
def test_soft_decay_plain_matches_jax(k):
    """K = 64, a ragged 200, the int8 config's 1024, the evaluator's 2000."""
    boxes, scores, classes, _, valid = _candidates(2, k, seed=k)
    boxes = _offset(boxes, classes, valid)
    want = _jax_decay(boxes, scores, valid)
    got = sk.soft_decay(*(torch.from_numpy(a) for a in (boxes, valid, scores))).numpy()
    assert sk.soft_decay.launches == 0  # the CPU takes the plain version
    assert (want < scores).mean() > 0.5  # most rows decay
    _assert_decay_close(got, want, valid)


def _assert_tie_free(want, boxes, scores, valid):
    """No two kept rows' decayed scores, in JAX's order, lie closer than
    twice the largest difference between the two sides' decayed scores of
    the same candidates: the order is decided, not a near-tie."""
    got_d = sk.soft_decay_plain(*(torch.from_numpy(a) for a in (boxes, valid, scores))).numpy()
    diff = np.max(np.abs(got_d - _jax_decay(boxes, scores, valid)))
    for b in range(want.scores.shape[0]):
        s = want.scores[b][want.valid[b]]
        assert (s[:-1] - s[1:] > 2 * diff).all(), "near-tie in the decayed scores"


def _assert_result_matches(got, want, valid_in):
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_array_equal(got.boxes.numpy(), want.boxes)
    np.testing.assert_array_equal(got.obj.numpy(), want.obj)
    tol = 2 * ULP * (valid_in.sum(1, keepdims=True) + 1)
    np.testing.assert_array_less(np.abs(got.scores.numpy() - want.scores),
                                 tol * np.abs(want.scores) + 1e-45)


@pytest.mark.parametrize("k,agnostic", [(64, False), (200, False), (200, True),
                                        (1024, False), (2048, True)])
def test_batched_soft_nms_matches_jax(k, agnostic):
    """The whole soft path: decay, keep, the stable re-sort and the
    compaction to max_det, class-offset and agnostic, ragged K included."""
    boxes, scores, classes, obj, valid = _candidates(2, k, seed=k + agnostic,
                                                     spread=60.0 * k ** 0.5)
    want = jax.device_get(jax.jit(lambda *a: jnms.batched_nms(
        *a, iou_threshold=0.55, max_det=100, class_agnostic=agnostic, soft=True))(
        *(jnp.asarray(a) for a in (boxes, scores, classes, obj, valid))))
    _assert_tie_free(want, boxes if agnostic else _offset(boxes, classes, valid), scores,
                     valid)
    got = tnms.batched_nms(*(torch.from_numpy(a) for a in (boxes, scores, classes, obj, valid)),
                           iou_threshold=0.55, max_det=100, class_agnostic=agnostic,
                           soft=True)
    assert got.boxes.shape == (2, 100, 4) and int(want.valid.sum()) > 100
    _assert_result_matches(got, want, valid)


def test_iou_threshold_is_not_read():
    boxes, scores, classes, obj, valid = (torch.from_numpy(a) for a in _candidates(1, 96, 3))
    a = tnms.batched_nms(boxes, scores, classes, obj, valid, iou_threshold=0.1, soft=True)
    b = tnms.batched_nms(boxes, scores, classes, obj, valid, iou_threshold=0.9, soft=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_subnormal_cluster_matches_jax():
    """80 near-copies of one box: from about the 55th row on, the products
    leave the normal range. XLA flushes them to zero, and so does the port;
    an unflushed torch chain keeps subnormal scores that JAX does not."""
    boxes, scores, classes, obj, valid = _cluster()
    want = _jax_decay(boxes, scores, valid)
    got = sk.soft_decay_plain(*(torch.from_numpy(a) for a in (boxes, valid, scores))).numpy()
    _assert_decay_close(got, want, valid)
    n_zero = int((want == 0).sum())
    assert 10 <= n_zero < 80

    # the chain without the flush, as torch's CPU arithmetic gives it
    tb = torch.from_numpy(boxes[0])
    iou = pairwise_iou(tb, tb)
    d = torch.exp(-(iou * iou) / 0.5)
    s = torch.from_numpy(scores[0].copy())
    for i in range(s.numel() - 1):
        s[i + 1:] = s[i + 1:] * d[i, i + 1:]
    unflushed = s.numpy()
    assert ((unflushed != 0) & (want[0] == 0)).sum() > 0  # what the flush decides

    jres = jax.device_get(jax.jit(lambda *a: jnms.batched_nms(*a, max_det=100, soft=True))(
        *(jnp.asarray(a) for a in (boxes, scores, classes, obj, valid))))
    tres = tnms.batched_nms(*(torch.from_numpy(a) for a in (boxes, scores, classes, obj, valid)),
                            max_det=100, soft=True)
    assert int(jres.valid.sum()) == 80 - n_zero
    _assert_result_matches(tres, jres, valid)


def test_all_invalid_and_empty_images():
    boxes, scores, classes, obj, valid = _candidates(2, 40, seed=9)
    valid[1] = False
    got = tnms.batched_nms(*(torch.from_numpy(a) for a in (boxes, scores, classes, obj, valid)),
                           max_det=50, soft=True)
    assert not got.valid[1].any() and (got.classes[1] == -1).all()
    assert (got.scores[1] == 0).all() and int(got.valid[0].sum()) > 0
    empty = sk.soft_decay(torch.zeros(0, 5, 4), torch.zeros(0, 5, dtype=torch.bool),
                          torch.zeros(0, 5))
    assert empty.shape == (0, 5)


def test_cuda_tensor_without_kernel_raises():
    """The wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel or raises (here: no device to launch on)."""
    with pytest.raises(ValueError):
        sk.soft_decay(torch.zeros(1, 8, 4, device="meta"),
                      torch.zeros(1, 8, dtype=torch.bool, device="meta"),
                      torch.zeros(1, 8, device="meta"))


# --------------------------------------------------------------------------
# the kernel's own source on the CPU
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    import torch_cuda_emu

    return torch_cuda_emu.build(tmp_path_factory.mktemp("soft_nms_emu"), "soft_nms")


def _nonfinite(k=96, seed=5):
    """Two images of class-offset candidates with non-finite boxes near
    their ends: image 0 a NaN x1 (every later row's product turns NaN),
    image 1 boxes of infinite area (their pairs take the full path: union
    inf, IoU 0, factor 1) and two bands of infinite height side by side
    (iw 0, ih inf: the intersection NaN, never skipped); image 1's row 2, of
    NaN area, has only invalid rows before it (it keeps its score: an
    invalid row decays nothing, not even with a NaN union)."""
    boxes, scores, classes, _, valid = _candidates(2, k, seed=seed)
    boxes = _offset(boxes, classes, valid)
    valid[:, k - 12:] = True
    valid[1, :3] = False
    boxes[1, 2] = [np.inf, 0, np.inf, 10]
    boxes[0, k - 10, 0] = np.nan
    boxes[1, k - 12] = [10, 10, np.inf, 60]
    boxes[1, k - 11] = [-np.inf, 20, 50, 70]
    boxes[1, k - 6] = [0, -np.inf, 10, np.inf]
    boxes[1, k - 3] = [20, -np.inf, 30, np.inf]
    return boxes, scores, valid


def _dense(batch=2, k=160, seed=4):
    """``batch`` images of ``k`` near-copies of three overlapping boxes of
    one class, all valid: every pair overlaps, so no factor is 1, and the
    products leave the normal range."""
    rs = np.random.RandomState(seed)
    base = np.array([[100, 100, 300, 300], [120, 110, 310, 290], [90, 130, 280, 320]],
                    np.float32)
    boxes = (base[rs.randint(0, 3, (batch, k))]
             + rs.uniform(0, 3, (batch, k, 4))).astype(np.float32)
    scores = np.sort(rs.uniform(0.3, 0.9, (batch, k)).astype(np.float32), axis=1)[:, ::-1]
    return boxes, np.ascontiguousarray(scores), np.ones((batch, k), bool)


@pytest.mark.parametrize("case", ["k64", "ragged_k300", "k600_invalid_image", "cluster",
                                  "nonfinite", "dense_k160", "tile_edges_k97_b3"])
def test_kernel_source_emulated(emu, case):
    """csrc/soft_nms.cu's kernel compiled by g++ against tests/cuda_emu/
    (a block's 288 threads as std::threads at its barriers, a warp's 32 at
    each ballot) against the plain version: the same zeros (the flush), NaNs
    and infinities, the rest within 2 ulp a factor (the C library's expf is
    not torch's). K = 97 (B = 3), 300 and 600 end inside a 32-column tile
    and a 128-row chunk; the dense case has no factor of 1 (every chunk's
    marks full), the non-finite case NaN and inf boxes."""
    import torch_cuda_emu

    if case == "cluster":
        boxes, scores, classes, _, valid = _cluster()
    elif case == "nonfinite":
        boxes, scores, valid = _nonfinite()
    elif case == "dense_k160":
        boxes, scores, valid = _dense()
        iou = pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))
        above = torch.ones(160, 160, dtype=torch.bool).triu(1)
        assert (torch.exp(-(iou * iou) / 0.5)[:, above] != 1).all()
    else:
        b, k = {"k64": (2, 64), "ragged_k300": (2, 300), "k600_invalid_image": (2, 600),
                "tile_edges_k97_b3": (3, 97)}[case]
        boxes, scores, classes, _, valid = _candidates(b, k, seed=k)
        if case == "k600_invalid_image":
            valid[1] = False
        boxes = _offset(boxes, classes, valid)
    want = sk.soft_decay_plain(*(torch.from_numpy(a) for a in (boxes, valid, scores))).numpy()
    got = torch_cuda_emu.run(emu, "emu_soft_decay", [boxes, valid, scores], scores.shape,
                             np.float32, [scores.shape[0], scores.shape[1]])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)], want[~finite & ~np.isnan(want)])
    rtol = _rtol(valid)
    assert (np.abs(got - want) <= rtol * np.abs(want))[finite].all()
    assert (want < scores).mean() > 0.3
    if case == "nonfinite":
        assert np.isnan(want[0, -10:]).all() and not np.isnan(want[0, :-10]).any()
        # the two bands' pair alone turns NaN; the infinite areas decay nothing
        assert np.flatnonzero(np.isnan(want[1])).tolist() == [scores.shape[1] - 3]
        assert (want[1, -12:-10] == scores[1, -12:-10]).all() and want[1, 2] == scores[1, 2]
    if case == "dense_k160":
        assert (want == 0).sum() > 100


def _f32_values(n=1 << 20, seed=0):
    """n f32 values from random bit patterns (every exponent: subnormals and
    values near overflow), with the zeros, the extremes and their
    neighbours, both signs; no NaN."""
    rs = np.random.RandomState(seed)
    bits = rs.randint(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0, 1, 2, 0x007FFFFF, 0x00800000, 0x00800001, 0x3F800000, 0x7F7FFFFE,
                      0x7F7FFFFF, 0x7F000000, 0x7EFFFFFF, 0x7F800000], np.uint32)
    bits = np.concatenate([bits, edges, edges | np.uint32(0x80000000)])
    x = bits.view(np.float32)
    return x[~np.isnan(x)]


def test_exact_rewrites_of_the_kernel():
    """The kernel's two rewrites are exact in f32: x / 0.5 equals x * 2 bit
    for bit (subnormals, values near overflow and infinities included), and
    a pair of finite boxes whose intersection is 0 has IoU 0 and factor
    exactly 1 under the plain version's operations, also when its union
    overflows or its coordinates are subnormal."""
    x = torch.from_numpy(_f32_values())
    half = torch.tensor(0.5, dtype=torch.float32)
    np.testing.assert_array_equal((x / half).numpy().view(np.uint32),
                                  (x * 2.0).numpy().view(np.uint32))
    sq = -(x * x)
    np.testing.assert_array_equal((sq / half).numpy().view(np.uint32),
                                  (sq * 2.0).numpy().view(np.uint32))

    # finite boxes from finite coordinates of every scale, most pairs disjoint
    rs = np.random.RandomState(1)
    vals = _f32_values(1 << 16, seed=2)
    vals = vals[np.isfinite(vals)]
    lo = rs.choice(vals, (4096, 2))
    with np.errstate(over="ignore"):
        hi = lo + np.abs(rs.choice(vals, (4096, 2))).astype(np.float32)
    boxes = np.concatenate([lo, hi], 1).astype(np.float32)
    # touching pairs: subnormal, tiny normal, and two areas of 2e38 whose
    # union overflows to inf
    touching = np.array([[0, 0, 1e-45, 1e-45], [1e-45, 0, 2e-45, 1e-45],
                         [1e-38, 1e-38, 2e-38, 2e-38], [2e-38, 1e-38, 3e-38, 2e-38],
                         [0, 0, 2e19, 1e19], [2e19, 0, 4e19, 1e19]], np.float32)
    boxes = np.concatenate([boxes, touching])
    with np.errstate(over="ignore"):
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = np.isfinite(boxes).all(1) & np.isfinite(areas)
    boxes, areas = boxes[keep], areas[keep]
    tb = torch.from_numpy(boxes)
    tl = torch.maximum(tb[:, None, :2], tb[None, :, :2])
    br = torch.minimum(tb[:, None, 2:], tb[None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    zero = (wh[..., 0] * wh[..., 1]) == 0
    iou = pairwise_iou(tb, tb)
    factor = torch.exp(-(iou * iou) / 0.5)
    assert zero.float().mean() > 0.5 and zero.sum() > 10_000_000
    n = len(boxes)
    assert torch.isinf(iou.new_tensor(areas[n - 2]) + iou.new_tensor(areas[n - 1]))
    assert zero[n - 2, n - 1] and zero[n - 6, n - 5] and zero[n - 4, n - 3]
    assert (iou[zero] == 0).all()
    assert (factor[zero] == 1).all()
