"""Checkpoints across the two packages: the port's msgpack codec
(cocodet_tpu_torch/utils/msgpack.py) against flax.serialization, the port's
utils/checkpoint.py against cocodet_tpu/utils/checkpoint.py, and the
optimizer and EMA state (utils/convert.py) against optax and the JAX EMA.

Exact: the bytes of a serialized tree, the trees read back either way,
``load_matched``'s result and warnings, the optimizer state's layout and
count. The SGD arithmetic of two steps agrees with optax's within 1e-5
relative or 1e-7 absolute (both compute g + wd * p, buf = g + momentum *
buf and the nesterov g + momentum * buf in f32, but torch's multi-tensor
kernels may fuse a product into the sum: after two steps one weight of a
1024-value kernel was an ulp off, 3e-8 absolute)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cocodet_tpu.utils import checkpoint as jck
from cocodet_tpu.utils.ema import ema_init
from cocodet_tpu_torch.core.train_state import build_optimizer
from cocodet_tpu_torch.models import MODEL_SPECS, YOLOX
from cocodet_tpu_torch.models.yolox import build_model
from cocodet_tpu_torch.utils import checkpoint as pck
from cocodet_tpu_torch.utils import msgpack as mp
from cocodet_tpu_torch.utils.convert import (ema_variables, export_variables, flatten_tree,
                                             load_ema, load_optimizer_state, optimizer_state_dict,
                                             random_variables)
from cocodet_tpu_torch.utils.ema import ModelEMA


def _trees():
    rs = np.random.RandomState(0)
    return [
        {},
        {"a": 0, "b": -1, "c": 127, "d": 128, "e": -32, "f": -33, "g": 255, "h": 256,
         "i": 65535, "j": 65536, "k": 2 ** 32 - 1, "l": 2 ** 32, "m": -129, "n": -32769,
         "o": -(2 ** 31) - 1, "p": 2 ** 63 - 1, "q": -(2 ** 63)},
        {"s": {str(n): "x" * n for n in (0, 31, 32, 255, 256, 65535, 65536)},
         "b": {str(n): bytes(range(256)) * (n // 256) + bytes(n % 256) for n in (0, 5, 300)},
         "f": [0.0, -1.5, 1e300, float("inf")], "t": [True, False, None], "e": {"x": {}}},
        {f"k{n}": np.arange(n, dtype=np.uint8) for n in (0, 1, 2, 4, 8, 16, 17, 300, 70000)},
        {d: rs.randn(3, 2).astype(d) for d in ("float32", "float64", "int8", "int32", "int64",
                                              "uint8", "bool", "float16")},
        {"zero_d": np.asarray(3, np.int32), "f64": np.asarray(0.25), "np_scalar": np.float32(2.5),
         "wide": {str(i): {"kernel": rs.rand(1, 1, 2, 3).astype(np.float32)} for i in range(20)}},
    ]


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(a, np.generic):
        assert type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


@pytest.mark.parametrize("k", range(6))
def test_codec_bytes_equal_flax_and_round_trip(k):
    tree = _trees()[k]
    data = mp.dumps_tree(tree)
    assert data == serialization.msgpack_serialize(tree)
    _same(mp.loads_tree(data), serialization.msgpack_restore(data))
    _same(mp.loads_tree(data), serialization.msgpack_restore(mp.dumps_tree(tree)))


def test_codec_chunks_as_flax_reads_them(monkeypatch):
    """Arrays above the chunk size are split as flax splits them."""
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(50, dtype=np.float32)
    data = mp.dumps_tree({"w": arr})
    assert data == serialization.msgpack_serialize({"w": arr})
    assert list(mp.unpackb(data)["w"]) == ["__msgpack_chunked_array__", "shape", "chunks"]
    np.testing.assert_array_equal(serialization.msgpack_restore(data)["w"], arr)
    np.testing.assert_array_equal(mp.loads_tree(data)["w"], arr)


def _small_model(seed=0):
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.33, width=0.125)
    return build_model("yolox-p6", depth=0.33, width=0.125, device="cpu",
                       variables=random_variables(shapes, seed, prior_prob=0.01))


def _jax_tx(lr=0.01):
    def mask(params):
        from flax import traverse_util

        flat = traverse_util.flatten_dict(params)
        return traverse_util.unflatten_dict({k: k[-1] == "kernel" for k in flat})

    return optax.chain(optax.add_decayed_weights(5e-4, mask=mask),
                       optax.sgd(learning_rate=lambda count: lr, momentum=0.9, nesterov=True))


def _trainer_state(model, opt, ema):
    return {"start_epoch": 3, "model": ema_variables(ema), "raw_model": export_variables(model),
            "opt_state": optimizer_state_dict(opt, model), "best_ap": 0.125}


def _steps(model, opt, ema, n, seed):
    rs = np.random.RandomState(seed)
    grads = []
    for _ in range(n):
        g = {name: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
             for name, p in model.named_parameters()}
        for name, p in model.named_parameters():
            p.grad = g[name].clone()
        opt.step()
        ema.update()
        grads.append(g)
    return grads


def test_jax_checkpoint_reads_in_the_port_and_back(tmp_path):
    model = _small_model()
    opt = build_optimizer(model, 0.01)
    ema = ModelEMA(model, 0.9999)
    _steps(model, opt, ema, 2, seed=1)
    state = _trainer_state(model, opt, ema)

    jpath = jck.save_checkpoint(state, True, str(tmp_path / "jax"), "latest")
    ppath = pck.save_checkpoint(state, True, str(tmp_path / "port"), "latest")
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    assert (tmp_path / "port" / "best_ckpt.msgpack").read_bytes() == open(ppath, "rb").read()
    _same(pck.load_checkpoint(jpath), jck.load_checkpoint(jpath))
    _same(jck.load_checkpoint(ppath), pck.load_checkpoint(ppath))
    loaded = pck.load_checkpoint(ppath)
    assert int(loaded["start_epoch"]) == 3 and float(loaded["best_ap"]) == 0.125
    assert loaded["start_epoch"].dtype == np.int64 and loaded["best_ap"].dtype == np.float64


def test_optimizer_state_maps_to_optax_and_back():
    """Two SGD steps in the port and in optax from the same weights and
    gradients: the same trace, count and weights; the port's state dict
    restores into optax's state (flax from_state_dict), and optax's into a
    fresh port optimizer, after which a third step agrees again."""
    model = _small_model()
    params = jax.tree_util.tree_map(jnp.asarray, export_variables(model)["params"])
    opt = build_optimizer(model, 0.01)
    ema = ModelEMA(model, 0.9999)
    grads = _steps(model, opt, ema, 2, seed=2)

    tx = _jax_tx()
    jstate = tx.init(params)
    for g in grads:
        gtree = jax.tree_util.tree_map(jnp.asarray, _as_flax(model, g))
        upd, jstate = tx.update(gtree, jstate, params)
        params = optax.apply_updates(params, upd)

    port_sd = optimizer_state_dict(opt, model)
    jax_sd = serialization.to_state_dict(jstate)
    assert jax.tree_util.tree_structure(port_sd) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jax_sd))
    assert int(port_sd["1"]["1"]["count"]) == int(jax_sd["1"]["1"]["count"]) == 2
    _close(port_sd["1"]["0"]["trace"], jax_sd["1"]["0"]["trace"])
    _close(export_variables(model)["params"], params)
    restored = serialization.from_state_dict(jstate, port_sd)
    _close(restored[1][0].trace, jstate[1][0].trace)

    fresh = _small_model()
    with torch.no_grad():
        for p, q in zip(fresh.parameters(), model.parameters()):
            p.copy_(q)
    opt2 = build_optimizer(fresh, 0.01)
    load_optimizer_state(opt2, fresh, jax.tree_util.tree_map(np.asarray, jax_sd))
    assert opt2.count == 2
    g3 = _steps(fresh, opt2, ModelEMA(fresh, 0.9999), 1, seed=3)[0]
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, _as_flax(fresh, g3)), jstate, params)
    _close(export_variables(fresh)["params"], optax.apply_updates(params, upd))


def test_ema_maps_to_the_jax_shadow():
    model = _small_model()
    ema = ModelEMA(model, 0.9998)
    shadow = ema_variables(ema)
    want = ema_init({k: v for k, v in export_variables(model).items()}).shadow
    _close(shadow, want, rtol=0)
    other = ModelEMA(_small_model(seed=5), 0.9998)
    load_ema(other, shadow)
    _same(ema_variables(other), shadow)


def test_load_matched_equals_jax(caplog):
    rs = np.random.RandomState(0)
    target = {"params": {"a": {"kernel": rs.rand(3, 3, 2, 4).astype(np.float32),
                               "bias": rs.rand(4).astype(np.float32)},
                         "b": {"kernel": rs.rand(1, 1, 4, 4).astype(np.float32)},
                         "q": {"kernel": rs.rand(2, 2).astype(np.float32)}}}
    ckpt = {"params": {"a": {"kernel": rs.rand(3, 3, 2, 4).astype(np.float64),
                             "bias": rs.rand(5).astype(np.float32)},
                       "q": {"kernel": rs.randint(-9, 9, (2, 2)).astype(np.int8)},
                       "extra": {"kernel": np.zeros(3, np.float32)}}}
    # the port's (and JAX's) logger stops propagating once a trainer in this
    # process has set it up (utils/logger.py): capture on the port's directly
    port_logger = logging.getLogger("cocodet_tpu_torch")
    port_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            got = pck.load_matched(target, ckpt)
    finally:
        port_logger.removeHandler(caplog.handler)
    want = jax.tree_util.tree_map(np.asarray, jck.load_matched(target, ckpt))
    _same(_sorted(got), _sorted(want))
    text = caplog.text
    assert "ckpt missing params/b/kernel" in text and "shape mismatch for params/a/bias" in text


def test_int4_checkpoints_raise(tmp_path):
    """Named when every int4 checkpoint raised; the port now unpacks them
    (tests/test_torch_int4.py). A packed leaf without its shape (a truncated
    save) raises JAX's error in both readers."""
    path = pck.save_checkpoint({"model": {"params": {"c": {"kernel": {
        "__int4_packed__": np.zeros(4, np.uint8)}}}}}, False, str(tmp_path))
    with pytest.raises(ValueError, match="corrupt int4-packed checkpoint") as got:
        pck.load_checkpoint(path)
    with pytest.raises(ValueError) as want:
        jck.load_checkpoint(path)
    assert str(got.value) == str(want.value)


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def _as_flax(model, named):
    from cocodet_tpu_torch.utils.convert import export_tensors

    return export_tensors(named)["params"]


def _close(got, want, rtol=1e-5):
    fg, fw = flatten_tree(got), flatten_tree(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(fg) == sorted(fw)
    for k in fg:
        np.testing.assert_allclose(np.asarray(fg[k]), fw[k], rtol=rtol, atol=rtol * 1e-2,
                                   err_msg="/".join(k))
