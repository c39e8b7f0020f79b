"""Port parity: cocodet_tpu_torch/ops/simota.py against
cocodet_tpu/ops/simota.py, on numpy-seeded head maps and labels.

The assignment is exact: the fg mask and each anchor's matched ground truth
equal JAX's, and so do the box targets (copies of the labels) and the class
targets (one-hot times the same f32 IoU). The L1 targets take a log, which
XLA and ATen may round one ulp apart: 1e-6. One scene has constructed cost
ties (identical predictions, a duplicated ground truth), which both break
to the lowest index.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.ops import simota as js
from cocodet_tpu_torch.ops import simota as ts
from cocodet_tpu_torch.ops.decode import (attach_strides, concat_levels,
                                          decode_center_format)

STRIDES = (8, 16, 32, 64)
NUM_CLASSES = 80


def _scene(seed, size=128, batch=2, g=12, ties=False):
    """Head maps (NHWC numpy, per level), labels (B, G, 5)."""
    rs = np.random.RandomState(seed)
    maps = []
    for s in STRIDES:
        h = size // s
        reg = rs.normal(0, 0.5, (batch, h, h, 4)).astype(np.float32)
        obj = rs.normal(-2, 1.5, (batch, h, h, 1)).astype(np.float32)
        cls = rs.normal(-3, 1.5, (batch, h, h, NUM_CLASSES)).astype(np.float32)
        if ties:  # every anchor predicts the same scores and a box of its own cell's size
            reg[..., :2], reg[..., 2:] = 0.0, 1.0
            obj[:], cls[:] = -1.0, -2.0
        maps.append({"reg": reg, "obj": obj, "cls": cls})
    labels = np.zeros((batch, g, 5), np.float32)
    for b in range(batch):
        n = rs.randint(3, g - 1)
        wh = rs.uniform(6, size * 0.6, (n, 2))
        c = rs.uniform(wh / 2, size - wh / 2)
        labels[b, :n] = np.concatenate([rs.randint(0, NUM_CLASSES, (n, 1)), c, wh], 1)
        if ties:  # a duplicate gt: equal cost rows, the first one keeps each anchor
            labels[b, n] = labels[b, 0]
    return maps, labels


def _inputs(maps):
    preds, grids, strides = concat_levels(attach_strides(
        [{k: torch.from_numpy(v) for k, v in m.items()} for m in maps], STRIDES))
    decoded = decode_center_format(preds, grids, strides)
    centers = (grids + 0.5) * strides[:, None]
    return (decoded[..., :4], preds[..., 5:], preds[..., 4:5], centers, strides)


def _assign_both(maps, labels, dtype="float32"):
    boxes, cls, obj, centers, strides = _inputs(maps)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                         jnp.bfloat16)
    got = ts.simota_assign(torch.from_numpy(labels), boxes, cls, obj, centers, strides,
                           NUM_CLASSES, compute_dtype=tdt)
    fn = jax.jit(lambda *a: js.simota_assign(*a, NUM_CLASSES, compute_dtype=jdt))
    want = jax.device_get(fn(jnp.asarray(labels), *(jnp.asarray(t.numpy()) for t in (
        boxes, cls, obj, centers, strides))))
    return got, want


def _matched_gt(reg_target, labels, fg):
    """JAX's matched gt of each fg anchor: the first label row whose box is
    the anchor's box target (the scenes' boxes are distinct, but for the
    constructed duplicate, which matches no anchor)."""
    eq = (reg_target[:, :, None, :] == labels[:, None, :, 1:5]).all(-1)
    return np.where(fg, eq.argmax(-1), 0)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, False), (3, True)],
                         ids=["scene0", "scene1", "scene2", "ties"])
def test_simota_assign_matches_jax(seed, ties):
    maps, labels = _scene(seed, ties=ties)
    got, want = _assign_both(maps, labels)
    fg = np.asarray(want.fg_mask)
    assert fg.sum() > 8
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  _matched_gt(np.asarray(want.reg_target), labels, fg))
    np.testing.assert_array_equal(got.reg_target.numpy(), np.asarray(want.reg_target))
    np.testing.assert_array_equal(got.cls_target.numpy(), np.asarray(want.cls_target))
    np.testing.assert_allclose(got.l1_target.numpy(), np.asarray(want.l1_target),
                               rtol=1e-6, atol=1e-6)
    assert float(got.num_fg) == float(want.num_fg)
    assert float(got.num_gts) == float(want.num_gts)
    if ties:  # the duplicate gt (row n) keeps no anchor: the first copy wins every tie
        n = (labels.sum(-1) > 0).sum(-1) - 1
        for b in range(labels.shape[0]):
            assert not (got.matched_gt[b][got.fg_mask[b]] == int(n[b])).any()


def test_simota_bf16_option_matches_jax():
    """simota_bf16: the IoU and gathered BCE terms in bf16, the final cost
    sum and the targets in f32; the same assignment as JAX's bf16 option.
    XLA rounds the bf16 IoU's intermediates at other places than ATen, so
    the class targets (one-hot times the matched IoU) may differ by a few
    bf16 steps: 2e-2 relative."""
    maps, labels = _scene(4)
    got, want = _assign_both(maps, labels, "bfloat16")
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.reg_target.numpy(), np.asarray(want.reg_target))
    np.testing.assert_allclose(got.cls_target.numpy(), np.asarray(want.cls_target),
                               rtol=2e-2, atol=1e-6)


def test_topk_small_first_index_wins():
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9], [1.0, 1.0, 1.0, 1.0, 1.0]])
    vals, idx = ts._topk_small(x, 4)
    np.testing.assert_array_equal(idx.numpy(), [[1, 2, 4, 0], [0, 1, 2, 3]])
    jv, ji = js._topk_small(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_binary_cross_entropy_terms_match_jax():
    sp = np.concatenate([np.linspace(0, 1, 1001), [1e-30, 1 - 1e-7]]).astype(np.float32)
    got = ts._binary_cross_entropy_terms(torch.from_numpy(sp))
    want = js._binary_cross_entropy_terms(jnp.asarray(sp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
