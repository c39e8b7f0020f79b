"""``DetectionLoader(mode="process")`` (cocodet_tpu_torch/data/samplers.py;
JAX's process workers, cocodet_tpu/data/samplers.py:72-146): the exp's
loaders, the host mosaic path and the device-mosaic path, give the same
batches in worker processes as on threads, bit for bit, across a
``close_mosaic`` (which restarts the process pool) and including the
batches in flight at the switch; and a data row of a batch (``rows``) is
that row's slice of the whole batch."""

import os

import numpy as np
import pytest

from cocodet_tpu_torch.data.synthetic import make_synthetic_coco
from cocodet_tpu_torch.exp import get_exp_by_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["depth", "0.33", "width", "0.125", "input_size", "(128, 128)", "test_size",
        "(128, 128)", "data_num_workers", "2"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("synth")), n_train=8, n_val=1,
                               size_range=(64, 160), seed=9)


def batches(root, mode, extra=(), rows=(0, 1), n=5):
    exp = get_exp_by_file(os.path.join(REPO, "cocodet_tpu_torch", "exps", "p6", "yolox_m_p6.py"))
    exp.merge(OPTS + list(extra) + ["data_dir", root])
    loader = exp.get_data_loader(batch_size=4, seed=2)
    loader.mode, loader.rows = mode, rows
    it, out = iter(loader), []
    for step in range(n):
        if step == 1:
            loader.close_mosaic()
        out.append(next(it))
    it.close()
    return out


def leaves(batch):
    imgs, labels, infos, ids = batch
    arrays = list(imgs.values()) if isinstance(imgs, dict) else [imgs, labels]
    return arrays, (infos, ids)


@pytest.mark.parametrize("path", ["host_mosaic", "device_mosaic"])
def test_process_workers_equal_threads(root, path):
    extra = ["device_mosaic", "True"] if path == "device_mosaic" else []
    threads, procs = batches(root, "thread", extra), batches(root, "process", extra)
    for k, (a, b) in enumerate(zip(threads, procs)):
        (xa, ma), (xb, mb) = leaves(a), leaves(b)
        assert ma == mb, k
        for x, y in zip(xa, xb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y, err_msg=f"batch {k}")


def test_a_row_is_its_slice_of_the_batch(root):
    whole = batches(root, "thread", n=3)
    halves = [batches(root, "thread", rows=(r, 2), n=3) for r in (0, 1)]
    for k in range(3):
        (wi, wl, winfo, wid) = whole[k]
        parts = [h[k] for h in halves]
        np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), wi)
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), wl)
        assert parts[0][3] + parts[1][3] == wid


def test_unknown_mode_and_uneven_rows_raise(root):
    from cocodet_tpu_torch.data.samplers import DetectionLoader, InfiniteSampler, YoloBatchSampler

    sampler = YoloBatchSampler(InfiniteSampler(4), 3)
    with pytest.raises(ValueError, match="mode"):
        DetectionLoader([], sampler, mode="fork")
    loader = DetectionLoader(list(range(4)), sampler)
    loader.rows = (0, 2)
    with pytest.raises(ValueError, match="does not split over 2 data rows"):
        next(iter(loader))
