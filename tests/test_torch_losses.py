"""Port parity: cocodet_tpu_torch/ops/losses.py (and the decode and box
helpers it uses) against cocodet_tpu/ops/losses.py, on numpy-seeded head
maps and labels.

The SimOTA assignment inside is exact (tests/test_torch_simota.py); the
loss sums and the log-sigmoid, exp and log of the two frameworks round
otherwise in the last bits: the losses to 1e-5 relative, their gradients
with respect to the head maps to 1e-5 * (1 + |g| / max|g|) of the largest
gradient. The box helpers are the same ops in the same order: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cocodet_tpu.ops import boxes as jbx
from cocodet_tpu.ops import decode as jd
from cocodet_tpu.ops import losses as jl
from cocodet_tpu_torch.ops import boxes as tbx
from cocodet_tpu_torch.ops import decode as td
from cocodet_tpu_torch.ops import losses as tl
from test_torch_simota import NUM_CLASSES, STRIDES, _scene

KEYS = ("reg", "obj", "cls")


@pytest.fixture(scope="module")
def scene():
    return _scene(5, size=128, batch=2)


def _jax_losses(maps, labels, use_l1, iou_type):
    def total(m):
        losses, _ = jl.yolox_losses(m, labels, STRIDES, NUM_CLASSES, use_l1=use_l1,
                                    iou_type=iou_type)
        return losses.total, losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in maps])
    return jax.device_get(losses), jax.device_get(grads)


@pytest.mark.parametrize("use_l1,iou_type", [(False, "iou"), (True, "iou"),
                                             (False, "giou"), (True, "giou")])
def test_yolox_losses_and_grads_match_jax(scene, use_l1, iou_type):
    maps, labels = scene
    want, want_grads = _jax_losses(maps, jnp.asarray(labels), use_l1, iou_type)
    tmaps = [{k: torch.from_numpy(v).requires_grad_() for k, v in m.items()} for m in maps]
    got, tgt = tl.yolox_losses(tmaps, torch.from_numpy(labels), STRIDES, NUM_CLASSES,
                               use_l1=use_l1, iou_type=iou_type)
    got.total.backward()
    assert float(tgt.num_fg) > 8
    for name in tl.DetectionLosses._fields:
        np.testing.assert_allclose(float(getattr(got, name).detach()), float(getattr(want, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    if not use_l1:
        assert float(got.l1) == 0.0
    scale = max(float(np.abs(g[k]).max()) for g in want_grads for k in KEYS)
    for tm, wg in zip(tmaps, want_grads):
        for k in KEYS:
            g, w = tm[k].grad.numpy(), np.asarray(wg[k])
            assert (np.abs(g - w) <= 1e-5 * (scale + np.abs(w))).all(), k


@pytest.mark.parametrize("loss_type", ["iou", "giou"])
def test_iou_loss_matches_jax(loss_type):
    rs = np.random.RandomState(6)
    pred = np.concatenate([rs.uniform(0, 100, (512, 2)), rs.uniform(1, 50, (512, 2))], 1)
    target = pred + rs.normal(0, 8, pred.shape)
    target[:, 2:] = np.abs(target[:, 2:]) + 1
    target[:64] = 0.0  # background rows: a zero box
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    want = np.asarray(jl.iou_loss(jnp.asarray(pred), jnp.asarray(target), loss_type))
    got = tl.iou_loss(torch.from_numpy(pred), torch.from_numpy(target), loss_type).numpy()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(tbx.iou_cxcywh(torch.from_numpy(pred), torch.from_numpy(target)),
                    jbx.iou_cxcywh(jnp.asarray(pred), jnp.asarray(target))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("wh_logit", [88.0, 89.0])
def test_iou_loss_gradient_past_the_exp_range_matches_jax(wh_logit):
    """A background anchor whose wh logit decodes past f32's largest value
    (exp overflows above 88.72): the loss stays finite in both frameworks,
    and its gradient with respect to that anchor's logits is 0 * inf = NaN
    in both, as it is for a step that trains far enough from random
    weights; at 88 both are finite. The foreground anchor's gradient is
    the same in both either way."""
    raw = np.array([[3.0, 4.0, wh_logit, 1.0], [5.0, 5.0, 1.5, 2.0]], np.float32)
    target = np.array([[0.0, 0.0, 0.0, 0.0], [44.0, 40.0, 40.0, 60.0]], np.float32)
    fg = np.array([0.0, 1.0], np.float32)

    def jax_loss(r):
        pred = jnp.concatenate([r[:, :2] * 8.0, jnp.exp(r[:, 2:]) * 8.0], 1)
        return (jl.iou_loss(pred, jnp.asarray(target)) * jnp.asarray(fg)).sum()

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(raw))
    r = torch.from_numpy(raw).requires_grad_()
    pred = torch.cat([r[:, :2] * 8.0, torch.exp(r[:, 2:]) * 8.0], 1)
    got = (tl.iou_loss(pred, torch.from_numpy(target)) * torch.from_numpy(fg)).sum()
    got.backward()
    got_grad, want_grad = r.grad.numpy(), np.asarray(want_grad)
    assert np.isfinite(got.item()) and np.isfinite(float(want))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    overflow = wh_logit > np.log(np.finfo(np.float32).max)
    assert np.isnan(got_grad[0, 2:]).all() == overflow
    assert np.isnan(want_grad[0, 2:]).all() == overflow
    np.testing.assert_allclose(got_grad[1], want_grad[1], rtol=1e-5)


def test_sigmoid_bce_matches_optax():
    import optax

    rs = np.random.RandomState(7)
    x = rs.normal(0, 6, 4096).astype(np.float32)
    y = rs.uniform(0, 1, 4096).astype(np.float32)
    want = np.asarray(optax.sigmoid_binary_cross_entropy(jnp.asarray(x), jnp.asarray(y)))
    got = tl.sigmoid_binary_cross_entropy(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decode_helpers_match_jax(scene):
    maps, _ = scene
    want = jd.concat_levels(jd.attach_strides(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in maps], STRIDES))
    got = td.concat_levels(td.attach_strides(
        [{k: torch.from_numpy(v) for k, v in m.items()} for m in maps], STRIDES))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(td.flatten_level({k: torch.from_numpy(v) for k, v in
                                                    maps[1].items()}).numpy(),
                                  np.asarray(jd.flatten_level(maps[1])))
    dec_w = np.asarray(jd.decode_center_format(*want))
    dec_g = td.decode_center_format(*got).numpy()
    np.testing.assert_allclose(dec_g, dec_w, rtol=1e-6, atol=0)
