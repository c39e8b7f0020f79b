"""Port parity: YOLOv3 (Darknet-53 + YOLOFPN + the lrelu decoupled head,
cocodet_tpu_torch/models/{darknet,yolo_fpn,yolox}.py) against
cocodet_tpu/models/, with the same numpy-drawn weights carried through
cocodet_tpu_torch/utils/convert.py, and the lrelu activation against
``jax.nn.leaky_relu``.

Tolerances. The random weights have unit gain and the eval-mode BN random
statistics, so the activations grow through Darknet-53's residual adds to
|v| ~ 2e4 at 64 px: a map is held to a fraction of its largest magnitude,
``|d| <= tol * max|v|`` (XLA:CPU and oneDNN sum each conv in another order;
observed 1.6-2.0e-6 of the largest magnitude for the Darknet features and
the FPN outputs, elementwise cancellation up to 2e-3 * (1 + |v|)). The
Darknet features and ResLayer: tol 1e-5; the FPN outputs and the head maps:
1e-4. The detections: the same sets (classes and counts exactly, boxes
within 1e-2 px + 1e-3 relative, scores within 1e-4). The train step is in
tests/test_torch_yolov3_step.py (each file under a minute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from cocodet_tpu.models import build_model as jax_build_model
from cocodet_tpu.models import blocks as jb
from cocodet_tpu.models.darknet import Darknet as JaxDarknet
from cocodet_tpu.ops.postprocess import PostprocessConfig as JaxConfig
from cocodet_tpu.ops.postprocess import postprocess as jax_postprocess
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX, Darknet, ResLayer, build_model
from cocodet_tpu_torch.models import blocks as tb
from cocodet_tpu_torch.ops.postprocess import PostprocessConfig, postprocess
from cocodet_tpu_torch.utils.convert import (export_variables, flatten_tree, jax_layout,
                                             load_variables)
from torch_port_utils import (assert_same_detections, head_maps, images, nchw,
                              shared_variables)

STRIDES = (8, 16, 32)


def assert_scaled(got, want, tol):
    """|got - want| <= tol * max|want| (see the module docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------
# lrelu
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrelu_matches_jax_with_its_gradient(dtype):
    """``get_activation("lrelu")`` against ``jax.nn.leaky_relu(x, 0.1)``, the
    forward and the gradient bit for bit, at 0, -0.0, +-1e-45 (subnormals,
    which XLA:CPU compares as zero: they pass with gradient 1) and random
    values. At 0 the gradient is 1 (``F.leaky_relu``'s is 0.1); in bf16 the
    slope is bf16(0.1) and the product rounds once, as in XLA."""
    rs = np.random.RandomState(5)
    x = np.concatenate([[0.0, -0.0, 1e-45, -1e-45, -1e-40, 3.0, -3.0],
                        rs.normal(0, 3, 4096)]).astype(np.float32)
    g = np.concatenate([np.ones(7), rs.normal(0, 2, 4096)]).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    fn = jb.get_activation("lrelu")
    y_jax, vjp = jax.vjp(jax.jit(fn), xj)
    (dx_jax,) = vjp(gj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = tb.get_activation("lrelu")(xt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == xt.grad.dtype == tdt

    def bits(a):
        return np.asarray(a.astype(jnp.float32) if isinstance(a, jax.Array)
                          else a.detach().float().numpy()).view(np.int32)

    np.testing.assert_array_equal(bits(y), bits(y_jax))
    np.testing.assert_array_equal(bits(xt.grad), bits(dx_jax))
    assert float(xt.grad[0]) == float(xt.grad[1]) == 1.0
    assert np.signbit(y[1].item())  # -0.0 maps to -0.0


# --------------------------------------------------------------------------
# blocks, backbone, FPN, model
# --------------------------------------------------------------------------


def test_reslayer_matches_jax():
    x = images(16, batch=2, seed=1)[..., :1].repeat(32, -1) / 64.0
    jm = jb.ResLayer(32)
    tm = ResLayer(32).eval()
    variables = shared_variables(jm, tm, x, seed=2)
    load_variables(tm, variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert_scaled(_nhwc(got), want, 1e-5)


def test_darknet21_features_match_jax():
    x = images(64, batch=2, seed=2)
    jm = JaxDarknet(depth=21)
    tm = Darknet(depth=21).eval()
    variables = shared_variables(jm, tm, x, seed=4)
    load_variables(tm, variables)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.float32)
    assert set(got) == set(want) == {"dark3", "dark4", "dark5"}
    for k in want:
        assert_scaled(_nhwc(got[k]), want[k], 1e-5)


def _filter(mdl, name):
    return name == "__call__" and type(mdl).__name__ in ("Darknet", "YOLOFPN")


@pytest.fixture(scope="module")
def yolov3():
    """Full-width YOLOv3 at 64 px, B=2, one forward each: the head maps and
    the Darknet and YOLOFPN outputs (JAX's captured as intermediates, the
    port's by forward hooks), the shared variables and the port model."""
    x = images(64, batch=2, seed=0)
    jm = jax_build_model("yolov3")
    tm = build_model("yolov3", device="cpu")
    variables = shared_variables(jm, tm, x, seed=3)
    load_variables(tm, variables)
    maps, inter = jax.jit(lambda v, xx: jm.apply(v, xx, capture_intermediates=_filter,
                                                 mutable=["intermediates"]))(
        variables, jnp.asarray(x))
    inter = jax.device_get(inter)["intermediates"]["backbone"]
    want = {"darknet": inter["backbone"]["__call__"][0], "fpn": inter["__call__"][0],
            "maps": maps}
    got = {}
    hooks = [m.register_forward_hook(lambda mod, args, out, key=key: got.update({key: out}))
             for key, m in (("darknet", tm.backbone.backbone), ("fpn", tm.backbone))]
    with torch.no_grad():
        got["maps"] = tm(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return variables, tm, got, want


def test_darknet53_features_match_jax(yolov3):
    _, tm, got, want = yolov3
    assert tm.backbone.backbone.num_blocks == (2, 8, 8, 4)
    for k in ("dark3", "dark4", "dark5"):
        assert_scaled(_nhwc(got["darknet"][k]), want["darknet"][k], 1e-5)


def test_yolo_fpn_matches_jax(yolov3):
    """The concat is [up, x] in that order: the weights meet their channels."""
    _, _, got, want = yolov3
    assert [t.shape[1] for t in got["fpn"]] == [128, 256, 512]
    for g, w in zip(got["fpn"], want["fpn"]):
        assert_scaled(_nhwc(g), w, 1e-4)


def test_head_maps_and_records_match_jax(yolov3):
    _, _, got, want = yolov3
    got, want = got["maps"], want["maps"]
    assert [m["cls"].shape[1:3] for m in got] == [(8, 8), (4, 4), (2, 2)]
    for g, w in zip(head_maps(got), head_maps(want)):
        for k in ("reg", "obj", "cls"):
            assert_scaled(g[k], w[k], 1e-4)
    point = dict(conf_threshold=0.01, nms_threshold=0.65, pre_nms_topk=128, max_det=100)
    res = postprocess(got, STRIDES, PostprocessConfig(**point))
    ref = jax.device_get(jax_postprocess(want, STRIDES, JaxConfig(**point)))
    assert int(res.valid.sum()) > 0
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(ref.valid))
    assert_same_detections(res, ref)


def test_parameter_count_and_layout():
    """build_model("yolov3") has JAX's 63,724,767 parameters (upstream
    YOLOX-Darknet53 publishes 63.7M), every flax leaf in its shape."""
    jm = jax_build_model("yolov3")
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    ref_layout = {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(ref).items()}
    with torch.device("meta"):
        tm = YOLOX(MODEL_SPECS["yolov3"])
    assert jax_layout(tm) == ref_layout
    assert sum(p.numel() for p in tm.parameters()) == 63_724_767


def test_weights_carried_both_ways(yolov3):
    """convert.py: the flax tree into the port model and back, leaf for leaf."""
    variables, tm, _, _ = yolov3
    back = flatten_tree(export_variables(tm))
    want = flatten_tree(variables)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_refuses_what_jax_does_not_take(yolov3):
    """The branch takes fused and quant only (yolox.py:88-98); JAX asserts
    on the distillation taps."""
    with pytest.raises(ValueError, match="use_mask"):
        with torch.device("meta"):
            YOLOX(MODEL_SPECS["yolov3"], use_mask=True)
    with torch.device("meta"):
        fused = YOLOX(MODEL_SPECS["yolov3"], fused=True)
    assert not any(".bn." in n for n in fused.state_dict())
    with pytest.raises(ValueError, match="taps"):
        yolov3[1](torch.zeros(1, 64, 64, 3), return_taps=True)
