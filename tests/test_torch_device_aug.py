"""The device-aug path, ``device_aug`` without ``device_mosaic``
(cocodet_tpu_torch/data/device_aug.py, exp/yolox_exp.py): the host mosaic
without its TrainTransform, ``DeviceAugDataset``, ``pack_items``,
``make_device_collate``, ``DeviceTrainAug`` and ``mixup_batch``, against
cocodet_tpu/data/device_aug.py:298-498 and the JAX exp's wiring
(cocodet_tpu/exp/yolox_exp.py:196-227).

Tolerances:
- the host side (``fetch``'s randoms, which draw nothing for an item with
  no labels; ``pack_items``'s buffers and host-f64 extents; the exp's
  collated batches): exact;
- K4 and the label math (the plain version of ``train_aug_batch``) on the
  exp's batch: exact against JAX run op by op (``jax.disable_jit``);
  against JAX's jitted program at tests/test_torch_device_mosaic.py's
  bounds (its docstring says why): classes exact, boxes within 1e-3 px,
  images within 1 grey level, at most 0.7% of values more than 1e-3 apart;
- ``mixup_batch``: labels exact, images within 1 f32 ulp (JAX's jitted
  ``0.5 a + 0.5 b`` may be contracted into an FMA)."""

import os
import random
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_device_mosaic import FakeDataset  # noqa: E402
from torch_port_utils import private_native_builds  # noqa: E402

from cocodet_tpu.data import device_aug as jda  # noqa: E402
from cocodet_tpu.data import mosaic as jmosaic  # noqa: E402
from cocodet_tpu.exp import get_exp_by_file as jax_exp  # noqa: E402
from cocodet_tpu_torch.data import device_aug as pda  # noqa: E402
from cocodet_tpu_torch.data import mosaic as pmosaic  # noqa: E402
from cocodet_tpu_torch.data.synthetic import make_synthetic_coco  # noqa: E402
from cocodet_tpu_torch.exp import get_exp_by_file as port_exp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("images_u8", "hw", "boxes_xyxy", "classes", "nvalid", "randoms", "nhw")
OPTS = ["device_aug", "True", "depth", "0.33", "width", "0.125", "input_size", "(128, 128)",
        "test_size", "(128, 128)", "compute_dtype", "float32", "data_num_workers", "1"]


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    with private_native_builds(tmp_path_factory.mktemp("jax_native")) as paths:
        yield paths


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """The first two batches of each exp's loader, and two after
    ``close_mosaic`` (the batches in flight at the switch left out, as
    tests/test_torch_host_mosaic.py leaves them: JAX's threads decide
    whether their items saw the mixup switch)."""
    root = make_synthetic_coco(str(tmp_path_factory.mktemp("synth")), n_train=8, n_val=1,
                               size_range=(64, 160), seed=3)
    out = {}
    for name, factory, path in (
            ("port", port_exp, os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6",
                                            "yolox_m_p6.py")),
            ("jax", jax_exp, os.path.join(REPO, "exps", "p6", "yolox_m_p6.py"))):
        exp = factory(path)
        exp.merge(OPTS + ["data_dir", root])
        loader = exp.get_data_loader(batch_size=2, seed=6)
        it, got = iter(loader), []
        for step in range(6):
            if step == 2:
                loader.close_mosaic()
            b = next(it)
            if step not in (2, 3):
                got.append(b)
        it.close()
        out[name] = (exp, got)
    return out


def test_exp_loader_collates_as_jax(batches):
    (_, port), (_, jax_b) = batches["port"], batches["jax"]
    for (pb, pl, pinfo, pid), (jb, jl, jinfo, jid) in zip(port, jax_b):
        assert pl is None and jl is None and sorted(pb) == sorted(jb) == sorted(KEYS)
        for k in KEYS:
            assert pb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert pinfo == jinfo and pid == jid
        assert pb["images_u8"].shape == (2, 128, 128, 3)


def test_k4_on_the_exp_batch_matches_jax(batches):
    exp, port = batches["port"]
    jexp, jax_b = batches["jax"]
    for (pb, _, _, _), (jb, _, _, _) in zip(port[:2], jax_b[:2]):
        got = pda.apply_device_preproc(exp, (128, 128), {k: torch.from_numpy(v)
                                                         for k, v in pb.items()})
        with jax.disable_jit():
            op = jda.apply_device_preproc(jexp, (128, 128), dict(jb))
        for g, w in zip(got, op):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jimg, jlab = [np.asarray(x) for x in jda.apply_device_preproc(jexp, (128, 128), dict(jb))]
        img, lab = got[0].numpy(), got[1].numpy()
        assert lab.shape == jlab.shape == (2, exp.max_labels_mosaic, 5)
        np.testing.assert_array_equal(lab[..., 0], jlab[..., 0])
        np.testing.assert_allclose(lab[..., 1:], jlab[..., 1:], rtol=0, atol=1e-3)
        d = np.abs(img.astype(np.float64) - jimg)
        assert d.max() <= 1.0 and (d > 1e-3).mean() <= 7e-3


def test_fetch_draws_as_jax_and_nothing_without_labels():
    rs = np.random.RandomState(4)
    ds = FakeDataset(rs, n=6, img_size=(64, 64), empty_every=2)
    kw = dict(mosaic=False, img_size=(64, 64), preproc=None)
    p = pda.DeviceAugDataset(pmosaic.MosaicDetection(ds, **kw), hsv_prob=0.5)
    j = jda.DeviceAugDataset(jmosaic.MosaicDetection(ds, **kw), hsv_prob=0.5)
    for i in range(len(ds)):
        ra, rb = random.Random(50 + i), random.Random(50 + i)
        a, b = p.fetch(i, ra), j.fetch(i, rb)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
            assert np.asarray(x).dtype == np.asarray(y).dtype
        assert a[3:] == b[3:]
        assert ra.getstate() == rb.getstate()
        if len(a[1]) == 0:
            np.testing.assert_array_equal(a[2], [1, 0, 0, 0, 0, 0, 0, 1])
            assert ra.getstate() == random.Random(50 + i).getstate()  # no draw
    assert len(p) == len(ds)
    p.close_mosaic()
    assert not p.enable_mosaic


def test_pack_items_equal_jax(capsys):
    rs = np.random.RandomState(8)
    items = []
    for h, w, n in ((40, 50, 3), (64, 64, 0), (70, 33, 5), (17, 63, 130)):
        tg = np.zeros((n, 5), np.float32)
        tg[:, :2] = rs.uniform(0, 20, (n, 2))
        tg[:, 2:4] = tg[:, :2] + rs.uniform(1, 20, (n, 2))
        tg[:, 4] = rs.randint(0, 80, n)
        items.append((rs.randint(0, 256, (h, w, 3)).astype(np.uint8), tg))
    pda._PACK_WARNED[0] = jda._PACK_WARNED[0] = False
    for out_size in (None, (61, 77)):
        got = pda.pack_items(items, (64, 64), 120, out_size=out_size)
        want = jda.pack_items(items, (64, 64), 120, out_size=out_size)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    err = capsys.readouterr().out
    assert err.count("[device_aug] WARNING: 70x33 image cropped") == 2  # once each package
    collate = pda.make_device_collate((64, 64), 120)
    jcollate = jda.make_device_collate((64, 64), 120)
    rand = [(img, tg, np.full(8, 0.25, np.float32), (1, 2), k) for k, (img, tg) in
            enumerate(items)]
    (pb, _, pi, pid), (jb, _, ji, jid) = collate(rand), jcollate(rand)
    assert sorted(pb) == sorted(jb) and "nhw" not in pb and (pi, pid) == (ji, jid)
    for k in pb:
        np.testing.assert_array_equal(pb[k], jb[k])


def test_device_train_aug_matches_jax():
    rs = np.random.RandomState(2)
    items = []
    for h, w in ((100, 128), (128, 90)):
        tg = np.zeros((4, 5), np.float32)
        tg[:, :2] = rs.uniform(0, 40, (4, 2))
        tg[:, 2:4] = tg[:, :2] + rs.uniform(8, 40, (4, 2))
        tg[:, 4] = rs.randint(0, 80, 4)
        items.append((rs.randint(0, 256, (h, w, 3)).astype(np.uint8), tg))
    kw = dict(max_labels=120, max_boxes=120)
    p = pda.DeviceTrainAug((128, 128), (128, 128), device="cpu", **kw)
    j = jda.DeviceTrainAug((128, 128), (128, 128), **kw)
    for pa, ja in zip(p.collate(items, random.Random(3)), j.collate(items, random.Random(3))):
        np.testing.assert_array_equal(pa, ja)
    img, lab = [x.numpy() for x in p(items, random.Random(3))]
    jimg, jlab = [np.asarray(x) for x in j(items, random.Random(3))]
    np.testing.assert_array_equal(lab[..., 0], jlab[..., 0])
    np.testing.assert_allclose(lab[..., 1:], jlab[..., 1:], rtol=0, atol=1e-3)
    d = np.abs(img.astype(np.float64) - jimg)
    assert d.max() <= 1.0 and (d > 1e-3).mean() <= 7e-3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pda.DeviceTrainAug((128, 128), (128, 128))


def test_mixup_batch_matches_jax():
    rs = np.random.RandomState(1)
    a = rs.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    b = rs.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    la, lb = np.zeros((3, 6, 5), np.float32), np.zeros((3, 6, 5), np.float32)
    for lab, n in ((la, (2, 0, 6)), (lb, (3, 4, 1))):
        for i, k in enumerate(n):
            lab[i, :k] = rs.uniform(1, 30, (k, 5))
    lb[0, 1, 3] = 0.0  # a dead row between live ones: stably compacted away
    img, lab = pda.mixup_batch(*[torch.from_numpy(x) for x in (a, la, b, lb)])
    jimg, jlab = [np.asarray(x) for x in jda.mixup_batch(a, la, b, lb)]
    np.testing.assert_array_equal(lab.numpy(), jlab)
    np.testing.assert_array_max_ulp(img.numpy(), jimg, maxulp=1)
