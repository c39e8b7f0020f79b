"""The port's experiment configs (cocodet_tpu_torch/exp/, exps/p6/) against
the JAX package's: the same attributes for the phase-1 exp file and every
registry name, the same ``merge`` of CLI overrides, the same multiscale
buckets and seeded draws, the same decayed-parameter set, the same
evaluator point. All exact."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cocodet_tpu import exp as jexp
from cocodet_tpu_torch import exp as pexp
from cocodet_tpu_torch.utils.convert import jax_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FILE = os.path.join(REPO, "exps", "p6", "yolox_m_p6.py")
PORT_FILE = os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py")
OPTS = ["max_epoch", "3", "device_mosaic", "True", "input_size", "(640, 640)",
        "data_dir", "/data/coco", "--basic_lr_per_img", "0.001", "multiscale_range", "(-2, 1)",
        "ema_momentum", "0.99", "seed", "7", "print_interval", "2", "test_conf", "0.01"]


def attributes(exp):
    return {k: getattr(exp, k) for k in dir(exp)
            if not k.startswith("_") and not callable(getattr(exp, k))}


def test_phase1_exp_file_equals_jax():
    assert attributes(pexp.get_exp_by_file(PORT_FILE)) == attributes(
        jexp.get_exp_by_file(JAX_FILE))


@pytest.mark.parametrize("name", sorted(jexp.base_exp._NAME_REGISTRY))
def test_registry_equals_jax(name):
    assert sorted(pexp.base_exp._NAME_REGISTRY) == sorted(jexp.base_exp._NAME_REGISTRY)
    assert attributes(pexp.get_exp_by_name(name)) == attributes(jexp.get_exp_by_name(name))


def test_merge_parses_equally():
    a, b = pexp.get_exp_by_file(PORT_FILE), jexp.get_exp_by_file(JAX_FILE)
    a.merge(OPTS)
    b.merge(OPTS)
    assert attributes(a) == attributes(b)
    assert a.input_size == (640, 640) and a.device_mosaic is True and a.seed == 7
    for exp in (a, b):
        with pytest.raises(AttributeError):
            exp.merge(["no_such_attribute", "1"])


@pytest.mark.parametrize("seed", [0, 1, 1234, 99991])
def test_multiscale_sizes_and_stream_equal_jax(seed):
    for name in ("yolox-s", "yolox-m-p6", "yolox-tiny"):
        a, b = pexp.get_exp_by_name(name), jexp.get_exp_by_name(name)
        assert a.multiscale_sizes() == b.multiscale_sizes()
        ra, rb = random.Random(seed + 1234), random.Random(seed + 1234)
        assert ([a.random_input_size(ra) for _ in range(50)]
                == [b.random_input_size(rb) for _ in range(50)])
    a, b = pexp.get_exp_by_file(PORT_FILE), jexp.get_exp_by_file(JAX_FILE)
    assert a.multiscale_sizes() == b.multiscale_sizes() == [(s, s) for s in range(640, 833, 32)]


def test_decayed_parameter_set_equals_jax():
    """JAX's decay mask, read off optax's update of zero gradients (only
    decayed leaves move), against the port's SGD group with weight decay."""
    j = jexp.get_exp_by_file(JAX_FILE)
    j.depth, j.width, j.warmup_epochs = 0.33, 0.125, 0
    model = j.get_model()
    params = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))["params"]
    j.get_lr_scheduler(0.01, 10)
    tx = j.get_optimizer(16)
    upd, _ = jax.jit(lambda p: tx.update(jax.tree_util.tree_map(jnp.zeros_like, p),
                                         tx.init(p), p))(params)
    flat = jax.tree_util.tree_flatten_with_path(upd)[0]
    want = {("params",) + tuple(k.key for k in path) for path, v in flat
            if bool(jnp.any(v != 0))}

    p = pexp.get_exp_by_file(PORT_FILE)
    p.depth, p.width = 0.33, 0.125
    model = p.get_model(device="cpu")
    opt = p.get_optimizer(16, model)
    decayed = {id(t) for g in opt.param_groups if g["weight_decay"] > 0 for t in g["params"]}
    got = {jax_path(n, t)[0] for n, t in model.named_parameters() if id(t) in decayed}
    assert got == want
    assert {g["weight_decay"] for g in opt.param_groups} == {0.0, j.weight_decay}
    assert opt.defaults["nesterov"] and opt.defaults["momentum"] == j.momentum


def test_model_and_evaluator_follow_the_exp(tmp_path):
    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    root = make_synthetic_coco(str(tmp_path), n_train=2, n_val=2, size_range=(64, 96))
    p, j = pexp.get_exp_by_file(PORT_FILE), jexp.get_exp_by_file(JAX_FILE)
    for exp in (p, j):
        exp.merge(["data_dir", root, "depth", "0.33", "width", "0.125",
                   "compute_dtype", "float32"])
    model = p.get_model(device="cpu")
    assert model.dtype == torch.float32 and model.strides == j.strides
    assert (model.depth, model.width, model.num_classes) == (0.33, 0.125, 80)
    pe, je = p.get_evaluator(batch_size=4), j.get_evaluator(batch_size=4)
    for k in ("img_size", "conf_threshold", "nms_threshold", "num_classes", "batch_size"):
        assert getattr(pe, k) == getattr(je, k), k
    assert len(pe.dataset) == len(je.dataset) == 2


def test_host_mosaic_path_raises(tmp_path):
    """Named when device_aug without device_mosaic raised; now the exp
    builds JAX's device-aug loader for it (yolox_exp.py:196-227): the host
    mosaic without its TrainTransform, wrapped in DeviceAugDataset, collated
    into K4's static uint8 buffers with the host extents
    (tests/test_torch_device_aug.py holds them against JAX). Masked models
    no longer raise: get_model(use_mask=True) builds the ChannelMask model,
    every gate open (tests/test_torch_channel_mask.py)."""
    from cocodet_tpu_torch.data.device_aug import DeviceAugDataset
    from cocodet_tpu_torch.data.synthetic import make_synthetic_coco

    root = make_synthetic_coco(str(tmp_path), n_train=2, n_val=1, size_range=(64, 96))
    exp = pexp.get_exp_by_file(PORT_FILE)
    exp.merge(["device_aug", "True", "input_size", "(128, 128)", "data_num_workers", "1",
               "data_dir", root])
    loader = exp.get_data_loader(batch_size=2)
    assert isinstance(loader.dataset, DeviceAugDataset) and loader.dataset.preproc is None
    it = iter(loader)
    batch, labels, _, _ = next(it)
    it.close()
    assert labels is None and batch["images_u8"].shape == (2, 128, 128, 3)
    assert sorted(batch) == ["boxes_xyxy", "classes", "hw", "images_u8", "nhw", "nvalid",
                             "randoms"]
    exp.merge(["depth", "0.33", "width", "0.125", "compute_dtype", "float32"])
    model = exp.get_model(device="cpu", use_mask=True)
    gates = [m.mask for m in model.modules() if getattr(m, "mask", None) is not None]
    assert gates and all(bool((g.scale == 1).all()) for g in gates)
