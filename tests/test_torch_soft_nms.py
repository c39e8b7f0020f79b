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


@pytest.mark.parametrize("case", ["k64", "ragged_k300", "k600_invalid_image", "cluster"])
def test_kernel_source_emulated(emu, case):
    """csrc/soft_nms.cu's kernel compiled by g++ against tests/cuda_emu/
    (a block's 256 threads as std::threads at its barriers) against the
    plain version: the same zeros (the flush), the rest within 2 ulp a
    factor (the C library's expf is not torch's). K=300 and 600 cross the
    256-row chunks of shared memory and the blocks' triangle."""
    import torch_cuda_emu

    if case == "cluster":
        boxes, scores, classes, _, valid = _cluster()
    else:
        k = {"k64": 64, "ragged_k300": 300, "k600_invalid_image": 600}[case]
        boxes, scores, classes, _, valid = _candidates(2, k, seed=k)
        if case == "k600_invalid_image":
            valid[1] = False
        boxes = _offset(boxes, classes, valid)
    want = sk.soft_decay_plain(*(torch.from_numpy(a) for a in (boxes, valid, scores))).numpy()
    got = torch_cuda_emu.run(emu, "emu_soft_decay", [boxes, valid, scores], scores.shape,
                             np.float32, [scores.shape[0], scores.shape[1]])
    np.testing.assert_array_equal(got == 0, want == 0)
    rtol = _rtol(valid)
    assert (np.abs(got - want) <= rtol * np.abs(want)).all()
    assert (want < scores).mean() > 0.3
