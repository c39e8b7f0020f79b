"""The anchor-based family (cocodet_tpu_torch/models/anchor_zoo.py) against
the JAX package's (cocodet_tpu/models/anchor_zoo.py), on the CPU.

Weights cross as the JAX module's flax variables through
``utils/convert.py`` (one rule per leaf; a fused Affine gate's ``weight``
is the port's ``gain``), drawn from numpy seeds; each test first checks
that the port's flax layout is the JAX module's own, names and shapes, for
the fused (conv biases, Affine gates) and the BN trees. Tolerances: f32
within 1e-4 * (1 + |v|) (the convs sum in another order; observed ~1e-7);
bf16 within 0.25 * (1 + |v|) with a mean relative error of at most 2%
(tests/test_torch_split_cat.py's: every op rounds to bf16, in another
order). The decode matches JAX's golden values and its f32 outputs within
1e-6 * (1 + |v|) (f32 ``exp`` differs in the last bit between XLA and
PyTorch); decode -> ``batched_nms`` gives the same records (classes and
validity exact, boxes and scores within 1e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocodet_tpu.models import anchor_zoo as jaz
from cocodet_tpu.ops.nms import batched_nms as jax_batched_nms
from cocodet_tpu_torch.models import anchor_zoo as paz
from cocodet_tpu_torch.ops.nms import batched_nms
from cocodet_tpu_torch.ops.postprocess import topk_stable
from cocodet_tpu_torch.utils.convert import load_variables
from torch_port_utils import nchw, nhwc, shared_variables

F32 = dict(rtol=1e-4, atol=1e-4)


def _image(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


def _load(module, variables):
    module = module.to(memory_format=torch.channels_last)
    load_variables(module, variables)
    return module.eval()


def _assert_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0.25, atol=0.25)
    rel = np.abs(got - want) / (1 + np.abs(want))
    assert rel.mean() <= 0.02, rel.mean()


def test_mish_and_make_divisible():
    x = np.linspace(-30, 30, 4097).astype(np.float32)
    np.testing.assert_allclose(paz.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jaz.mish(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert float(paz.mish(torch.tensor([1.0]))[0]) == pytest.approx(
        math.tanh(math.log(1 + math.e)), rel=1e-6)
    for v in (1024 * 0.75, 256 * 0.75, 63, 8, 1.0):
        assert paz.make_divisible(v) == jaz.make_divisible(v)


# each block: (JAX module, port module), its input channels and spatial size
BLOCKS = {
    "VConv k6 s2": (lambda f: jaz.VConv(32, 6, 2, act="silu", fused=f),
                    lambda f: paz.VConv(3, 32, 6, 2, act="silu", fused=f), 3, 16),
    "AffineGate": (lambda f: jaz.AffineGate(16, fused=f),
                   lambda f: paz.AffineGate(16, fused=f), 16, 8),
    "VBottleneck": (lambda f: jaz.VBottleneck(16, act="silu", fused=f),
                    lambda f: paz.VBottleneck(16, 16, act="silu", fused=f), 16, 8),
    "C3": (lambda f: jaz.C3(32, n=2, act="silu", fused=f),
           lambda f: paz.C3(24, 32, n=2, act="silu", fused=f), 24, 8),
    "C3 no shortcut": (lambda f: jaz.C3(32, n=1, shortcut=False, act="silu", fused=f),
                       lambda f: paz.C3(32, 32, n=1, shortcut=False, act="silu", fused=f),
                       32, 8),
    "SPPF": (lambda f: jaz.SPPF(24, act="silu", fused=f),
             lambda f: paz.SPPF(32, 24, act="silu", fused=f), 32, 12),
    "BottleneckCSP": (lambda f: jaz.BottleneckCSP(32, n=2, fused=f),
                      lambda f: paz.BottleneckCSP(16, 32, n=2, fused=f), 16, 8),
    "BottleneckCSP2": (lambda f: jaz.BottleneckCSP2(16, n=2, fused=f),
                       lambda f: paz.BottleneckCSP2(24, 16, n=2, fused=f), 24, 8),
    "SPPCSP": (lambda f: jaz.SPPCSP(16, fused=f),
               lambda f: paz.SPPCSP(24, 16, fused=f), 24, 14),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "bn"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, fused):
    make_jax, make_port, cin, size = BLOCKS[name]
    x = _image((2, size, size, cin), seed=len(name), scale=4.0) - 2.0
    jm = make_jax(fused)
    port = make_port(fused)
    variables = shared_variables(jm, port, x, seed=3)
    port = _load(port, variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **F32)


def _models(name, width=None, fused=True, dtype=torch.float32, jdtype=None, size=128):
    cfg = jaz.ANCHOR_MODELS[name]
    jm = jaz.AnchorDetector(spec=cfg["spec"], num_anchors=cfg["num_anchors"],
                            depth_multiple=cfg["depth_multiple"],
                            width_multiple=width or cfg["width_multiple"], act=cfg["act"],
                            fused=fused, dtype=jdtype)
    with torch.device("meta"):
        port, anchors, strides = paz.build_anchor_model(name, fused=fused, dtype=dtype,
                                                        width_multiple=width)
    x = _image((1, size, size, 3), seed=5)
    variables = shared_variables(jm, port, x, seed=1)
    port = _load(port.to_empty(device="cpu"), variables)
    return jm, port, variables, x, anchors, strides


@pytest.mark.parametrize("name,width,fused", [
    ("yolov5m6", None, True), ("yolov4-csp", None, True), ("yolov4-p5", 0.25, True),
    ("yolov4-p6", 0.25, True), ("yolov4-p6", 0.25, False), ("yolov4-p7", 0.25, True)],
    ids=["yolov5m6", "yolov4-csp", "p5 w0.25", "p6 w0.25", "p6 w0.25 bn", "p7 w0.25"])
def test_model_matches_jax(name, width, fused):
    """The published-width YOLOv5m6 and YOLOv4-CSP, and P5/P6/P7 at width
    0.25 (the P6 also with BN), at 128 px on images in [0, 1]: every level's
    raw map within the f32 tolerance."""
    jm, port, variables, x, _, strides = _models(name, width, fused)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == len(strides)
    for g, w, s in zip(got, want, strides):
        assert tuple(g.shape) == tuple(w.shape) and g.shape[1] == 128 // s
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_yolov5m6_bf16_matches_jax():
    jm, port, variables, x, _, _ = _models("yolov5m6", dtype=torch.bfloat16,
                                           jdtype=jnp.bfloat16)
    port = port.to(torch.bfloat16)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _assert_bf16(g.float().numpy(), w)


def test_decode_golden():
    """JAX's golden case (tests/test_anchor_zoo.py): a zero map decodes to
    boxes of the anchor's size at the cell centres, obj 0.5, cls 0.25."""
    boxes, obj, cls = paz.decode_anchor_outputs([torch.zeros(1, 2, 2, 85)], [(10, 20)], [8], 80)
    assert tuple(boxes.shape) == (1, 4, 4)
    cx = (0.5 + 0) * 8
    np.testing.assert_allclose(boxes[0, 0].numpy(), [cx - 5, cx - 10, cx + 5, cx + 10],
                               atol=1e-5)
    np.testing.assert_allclose(boxes[0, 3].numpy(), [12 - 5, 12 - 10, 12 + 5, 12 + 10],
                               atol=1e-5)
    np.testing.assert_allclose(obj.numpy(), 0.5, atol=1e-6)
    np.testing.assert_allclose(cls.numpy(), 0.25, atol=1e-6)


def _raw_maps(seed=0, b=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, 6, 5, 3 * 85).astype(np.float32) * 2,
            rs.randn(b, 3, 3, 3 * 85).astype(np.float32) * 2]


ANCHORS = [(10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119)]


def test_decode_matches_jax():
    maps = _raw_maps()
    want = jaz.decode_anchor_outputs([jnp.asarray(m) for m in maps], ANCHORS, [8, 16], 80)
    got = paz.decode_anchor_outputs([torch.from_numpy(m) for m in maps], ANCHORS, [8, 16], 80)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_decode_feeds_nms_like_jax():
    """decode -> class max -> top 100 (of 117) at conf 0.3 -> batched_nms at IoU 0.65
    to 30 detections (the predictor's step, harness/predict_yolov5.py:
    52-63): the same records as JAX's."""
    maps = _raw_maps(seed=1)
    boxes, obj, cls = jaz.decode_anchor_outputs([jnp.asarray(m) for m in maps], ANCHORS,
                                                [8, 16], 80)
    score, klass = jnp.max(cls, -1), jnp.argmax(cls, -1).astype(jnp.int32)
    top, order = jax.lax.top_k(jnp.where(score >= 0.3, score, -1.0), 100)
    take = jax.vmap(lambda a, o: a[o])
    want = jax_batched_nms(take(boxes, order), top, take(klass, order),
                           take(obj[..., 0], order), top >= 0.0, iou_threshold=0.65, max_det=30)

    boxes, obj, cls = paz.decode_anchor_outputs([torch.from_numpy(m) for m in maps], ANCHORS,
                                                [8, 16], 80)
    score, klass = cls.amax(-1), cls.argmax(-1).to(torch.int32)
    top, order = topk_stable(torch.where(score >= 0.3, score, torch.full_like(score, -1.0)), 100)

    def gather(t):
        return torch.gather(t, 1, order if t.dim() == 2 else
                            order[..., None].expand(-1, -1, t.shape[-1]))

    got = batched_nms(gather(boxes), top, gather(klass), gather(obj[..., 0]), top >= 0.0,
                      iou_threshold=0.65, max_det=30)
    assert int(got.valid.sum()) > 10
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    for field in ("boxes", "scores", "obj"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=1e-5, atol=1e-5)


def test_registry_matches_jax():
    assert sorted(paz.ANCHOR_MODELS) == sorted(jaz.ANCHOR_MODELS)
    for name, cfg in jaz.ANCHOR_MODELS.items():
        mine = paz.ANCHOR_MODELS[name]
        for key in ("spec", "anchors", "strides", "depth_multiple", "width_multiple", "act",
                    "num_anchors"):
            assert mine[key] == cfg[key], (name, key)
    with pytest.raises(ValueError, match="unknown module"):
        paz.AnchorDetector(spec=((-1, 1, "Focus", (8,)),))
    with pytest.raises(ValueError, match="no Detect"):
        paz.AnchorDetector(spec=((-1, 1, "Conv", (8, 3, 1)),))
