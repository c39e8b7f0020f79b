"""Port parity: cocodet_tpu_torch NMS (overlap matrix, greedy keep,
batched_nms) against cocodet_tpu's, exactly, on f32 inputs on the CPU.

The port's overlap matrix is bit-packed ((B, K, W) int64); unpacked, it and
the keep masks must equal the JAX 0/1 outputs bit for bit; so must every
field of NMSResult when both sides get the same f32 candidates. On the CPU
the wrappers take their plain PyTorch versions and count no launch;
chip_smoke.py holds the kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.ops import nms as jnms
from cocodet_tpu.ops.pallas.nms_kernels import overlap_matrix as jax_overlap_matrix
from cocodet_tpu_torch.ops import nms as tnms
from cocodet_tpu_torch.ops.cuda import nms_kernels as tk

THR = 0.55


def _candidates(batch, k, seed, n_classes=3, near_threshold=True):
    """Score-sorted candidates in a small scene, so many pairs overlap; some
    boxes are shifted copies of others with IoU close to THR."""
    rs = np.random.RandomState(seed)
    centers = rs.rand(batch, k, 2) * 120
    wh = rs.rand(batch, k, 2) * 40 + 4
    if near_threshold:
        # copies of an earlier box shifted so that IoU is within ~1e-3 of THR
        src = rs.randint(0, k, (batch, k // 8))
        dst = rs.randint(0, k, (batch, k // 8))
        for b in range(batch):
            w = wh[b, src[b], 0]
            shift = w * (1 - THR) / (1 + THR) * (1 + rs.uniform(-1e-3, 1e-3, len(w)))
            centers[b, dst[b]] = centers[b, src[b]] + np.stack([shift, 0 * shift], -1)
            wh[b, dst[b]] = wh[b, src[b]]
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
    scores = np.sort(rs.rand(batch, k).astype(np.float32), axis=1)[:, ::-1].copy()
    classes = rs.randint(0, n_classes, (batch, k)).astype(np.int32)
    obj = rs.rand(batch, k).astype(np.float32)
    valid = rs.rand(batch, k) > 0.15
    return boxes, scores, classes, obj, valid


def _offset(boxes, classes, valid):
    """Class-offset boxes, as batched_nms feeds them to the overlap matrix."""
    return tnms.class_offset_boxes(torch.from_numpy(boxes), torch.from_numpy(classes),
                                   torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("k", [256, 1024])
def test_overlap_plain_matches_pallas_interpret(k):
    boxes, _, classes, _, valid = _candidates(1, k, seed=k)
    boxes = _offset(boxes, classes, valid)
    want = np.asarray(jax_overlap_matrix(jnp.asarray(boxes[0]), jnp.asarray(valid[0]),
                                         THR, interpret=True))
    got = tk.overlap_matrix_plain(torch.from_numpy(boxes), torch.from_numpy(valid), THR)
    assert got.dtype == torch.int64 and got.shape == (1, k, k // 64)
    np.testing.assert_array_equal(tk.unpack_overlap(got)[0].numpy(), want)
    assert 0 < want.sum() < k * k / 2


def test_packed_layout_ragged_k():
    """K=200: W=4 words a row (ceil(200/64)=4, even), bit 63 (int64's sign
    bit) set where column 64w+63 overlaps, no bit past K, zero words below
    the diagonal; unpacked, the predicate of the JAX jnp overlap matrix."""
    from cocodet_tpu.ops.boxes import pairwise_iou as jax_iou

    k = 200
    boxes, _, classes, _, valid = _candidates(2, k, seed=11)
    for b, (src, dst) in ((0, (0, 63)), (1, (70, 191))):  # column 64w+63 overlaps
        boxes[b, dst], classes[b, dst] = boxes[b, src], classes[b, src]
        valid[b, [src, dst]] = True
    boxes = _offset(boxes, classes, valid)
    got = tk.overlap_matrix_plain(torch.from_numpy(boxes), torch.from_numpy(valid), THR)
    assert got.shape == (2, k, 4) and got.is_contiguous() and tk.packed_width(k) % 2 == 0
    assert got[0, 0, 0] < 0 and got[1, 70, 2] < 0  # bit 63 set
    assert not (got[..., 3] >> (k - 192)).any()  # bits past K
    for r in range(k):
        assert not got[:, r, : r // 64].any()  # words below the diagonal
    for b in range(2):
        jb = jnp.asarray(boxes[b])
        order = np.arange(k)
        want = (np.asarray(jax_iou(jb, jb)) > THR) & (order[:, None] < order[None, :])
        want &= valid[b][:, None] & valid[b][None, :]
        np.testing.assert_array_equal(tk.unpack_overlap(got)[b].numpy(), want.astype(np.float32))


def test_packed_width_and_keep_limit():
    assert [tk.packed_width(k) for k in (1, 64, 65, 129, 340, 1024, 8500, 8704)] == \
        [2, 2, 2, 4, 6, 16, 134, 136]
    # greedy_keep's shared memory: 64 bytes of barriers, the W removed words
    # and two stages of 64 rows x W words, in 232448 bytes
    smem = lambda k: 64 + 8 * tk.packed_width(k) * (1 + 2 * 64)  # noqa: E731
    assert tk.MAX_KEEP_K >= 8704 and tk.MAX_KEEP_K % 64 == 0
    assert smem(tk.MAX_KEEP_K) <= 232448 < smem(tk.MAX_KEEP_K + 64)


def test_overlap_wrapper_on_cpu_is_plain_and_counts_nothing():
    boxes, _, _, _, valid = _candidates(3, 200, seed=1)
    tk.reset_launch_counts()
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = tk.overlap_matrix(b, v, THR)
    np.testing.assert_array_equal(got.numpy(), tk.overlap_matrix_plain(b, v, THR).numpy())
    keep = tk.greedy_keep(got, v)
    np.testing.assert_array_equal(keep.numpy(), tk.greedy_keep_plain(got, v).numpy())
    assert tk.overlap_matrix.launches == 0 and tk.greedy_keep.launches == 0


@pytest.mark.parametrize("k", [384, 1024])
def test_greedy_keep_plain_matches_jax(k):
    """Both JAX keep paths: the fixpoint (_greedy_keep) at every K, and the
    tile-sequential scan (_greedy_keep_tiled) where K % 512 == 0."""
    boxes, _, classes, _, valid = _candidates(2, k, seed=7 + k)
    boxes = _offset(boxes, classes, valid)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = tk.greedy_keep_plain(tk.overlap_matrix_plain(tb, tv, THR), tv).numpy()
    for i in range(2):
        jb, jv = jnp.asarray(boxes[i]), jnp.asarray(valid[i])
        np.testing.assert_array_equal(got[i], np.asarray(jnms._greedy_keep(jb, jv, THR)))
        if k % 512 == 0:
            np.testing.assert_array_equal(
                got[i], np.asarray(jnms._greedy_keep_tiled(jb, jv, THR)))
    assert 0 < (valid & ~got).sum()  # something was suppressed


def _assert_result_equal(got, want):
    for field in ("boxes", "scores", "classes", "obj", "valid"):
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("k,max_det,agnostic", [(1024, 300, False), (384, 300, False),
                                                (128, 300, False), (384, 100, True)])
def test_batched_nms_matches_jax(k, max_det, agnostic):
    boxes, scores, classes, obj, valid = _candidates(3, k, seed=k + max_det)
    boxes[0, 5] = [np.inf, 0.0, np.inf, 1.0]  # non-finite box: kept out of the span
    want = jnms.batched_nms(*(jnp.asarray(a) for a in (boxes, scores, classes, obj, valid)),
                            iou_threshold=THR, max_det=max_det, class_agnostic=agnostic)
    got = tnms.batched_nms(*(torch.from_numpy(a) for a in (boxes, scores, classes, obj, valid)),
                           iou_threshold=THR, max_det=max_det, class_agnostic=agnostic)
    _assert_result_equal(got, want)
    assert got.classes.dtype == torch.int32 and got.valid.dtype == torch.bool


def test_nms_single_matches_jax():
    boxes, scores, classes, obj, valid = (a[0] for a in _candidates(1, 256, seed=3))
    want = jnms.nms_single(*(jnp.asarray(a) for a in (boxes, scores, classes, obj, valid)),
                           iou_threshold=THR, max_det=50)
    got = tnms.nms_single(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (boxes, scores, classes, obj, valid)),
                          iou_threshold=THR, max_det=50)
    _assert_result_equal(got, want)


def test_soft_nms_not_ported():
    boxes, scores, classes, obj, valid = (torch.from_numpy(a) for a in _candidates(1, 16, 0))
    with pytest.raises(NotImplementedError):
        tnms.batched_nms(boxes, scores, classes, obj, valid, soft=True)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; other devices raise."""
    with pytest.raises(ValueError):
        tk.overlap_matrix(torch.zeros(1, 8, 4, device="meta"),
                          torch.zeros(1, 8, dtype=torch.bool, device="meta"), THR)
    with pytest.raises(ValueError):
        tk.greedy_keep(torch.zeros(1, 8, 2, dtype=torch.int64, device="meta"),
                       torch.zeros(1, 8, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("fn", ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "xyxy_to_xywh"])
def test_box_conversions_match_jax(fn):
    from cocodet_tpu.ops import boxes as jboxes
    from cocodet_tpu_torch.ops import boxes as tboxes

    boxes = _candidates(2, 64, seed=2)[0]
    want = np.asarray(getattr(jboxes, fn)(jnp.asarray(boxes)))
    np.testing.assert_array_equal(getattr(tboxes, fn)(torch.from_numpy(boxes)).numpy(), want)


@pytest.mark.parametrize("xyxy", [True, False])
def test_pairwise_iou_matches_jax(xyxy):
    from cocodet_tpu.ops.boxes import pairwise_iou as jax_iou
    from cocodet_tpu_torch.ops.boxes import pairwise_iou

    a, b = _candidates(2, 96, seed=5)[0], _candidates(2, 40, seed=6)[0]
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), xyxy=xyxy))
    got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b), xyxy=xyxy).numpy()
    np.testing.assert_array_equal(got, want)
