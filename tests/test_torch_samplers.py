"""The port's samplers and loader (cocodet_tpu_torch/data/samplers.py)
against cocodet_tpu/data/samplers.py: the index stream, the batches of
(mosaic flag, index), the per-item seeds and what a loader yields, for
several seeds, ranks and world sizes; exact. And the prefetcher on the CPU
(the card's stream path runs in chip_smoke.py phase j)."""

import itertools
import random

import numpy as np
import pytest
import torch

from cocodet_tpu.data import samplers as js
from cocodet_tpu_torch.data import samplers as ps

CASES = [(0, 0, 1), (0, 1, 2), (7, 0, 4), (7, 3, 4), (1234, 2, 3)]


@pytest.mark.parametrize("seed,rank,world", CASES)
@pytest.mark.parametrize("size", [1, 5, 64])
def test_infinite_sampler_equals_jax(seed, rank, world, size):
    for shuffle in (True, False):
        a = ps.InfiniteSampler(size, shuffle=shuffle, seed=seed, rank=rank, world_size=world)
        b = js.InfiniteSampler(size, shuffle=shuffle, seed=seed, rank=rank, world_size=world)
        assert list(itertools.islice(a, 300)) == list(itertools.islice(b, 300))


@pytest.mark.parametrize("seed,rank,world", CASES)
def test_batch_sampler_equals_jax(seed, rank, world):
    a = ps.YoloBatchSampler(ps.InfiniteSampler(10, seed=seed, rank=rank, world_size=world), 4)
    b = js.YoloBatchSampler(js.InfiniteSampler(10, seed=seed, rank=rank, world_size=world), 4)
    ia, ib = iter(a), iter(b)
    assert [next(ia) for _ in range(5)] == [next(ib) for _ in range(5)]
    a.mosaic = b.mosaic = False
    assert [next(ia) for _ in range(5)] == [next(ib) for _ in range(5)]


class _Draws:
    """A dataset whose items are draws from the item's rng."""

    def __init__(self, n=10):
        self.n = n
        self.closed = False

    def __len__(self):
        return self.n

    def close_mosaic(self):
        self.closed = True

    def fetch(self, item, rng):
        flag, idx = item
        return np.asarray([idx, flag, rng.random(), rng.randint(0, 99)], np.float64)


def _collate(items):
    return {"x": np.stack(items)}, None, [int(i[0]) for i in items], None


@pytest.mark.parametrize("seed,rank,world", CASES)
def test_loader_stream_equals_jax(seed, rank, world):
    """Item seeds ((seed + 1) * 1_000_003 + position) and the batches a
    loader yields, across close_mosaic, with 1 and 3 workers."""
    pa = ps.DetectionLoader(_Draws(), ps.YoloBatchSampler(
        ps.InfiniteSampler(10, seed=seed, rank=rank, world_size=world), 3),
        num_workers=3, seed=seed, collate_fn=_collate)
    ja = js.DetectionLoader(_Draws(), js.YoloBatchSampler(
        js.InfiniteSampler(10, seed=seed, rank=rank, world_size=world), 3),
        num_workers=1, seed=seed, collate_fn=_collate)
    assert [pa._item_seed(c) for c in range(20)] == [ja._item_seed(c) for c in range(20)]
    ia, ib = iter(pa), iter(ja)
    for k in range(6):
        if k == 3:
            pa.close_mosaic()
            ja.close_mosaic()
        a, b = next(ia), next(ib)
        np.testing.assert_array_equal(a[0]["x"], b[0]["x"])
        assert a[2] == b[2]
    assert pa.dataset.closed and not pa.batch_sampler.mosaic
    ia.close()
    ib.close()


def test_prefetcher_on_the_cpu_hands_over_the_batches():
    loader = ps.DetectionLoader(_Draws(), ps.YoloBatchSampler(ps.InfiniteSampler(10), 4),
                                num_workers=2, collate_fn=_collate)
    ref = iter(ps.DetectionLoader(_Draws(), ps.YoloBatchSampler(ps.InfiniteSampler(10), 4),
                                  num_workers=2, collate_fn=_collate))
    pf = ps.DevicePrefetcher(loader, torch.device("cpu"))
    for _ in range(4):
        imgs, labels, infos, _ = pf.next()
        want = next(ref)
        assert isinstance(imgs["x"], torch.Tensor) and labels is None
        np.testing.assert_array_equal(imgs["x"].numpy(), want[0]["x"])
        assert infos == want[2]
    assert pf.bytes >= 4 * 128 and pf.bytes % 128 == 0  # it runs a batch or two ahead
    pf.close()
    ref.close()


def test_loader_takes_the_device_collate_only():
    with pytest.raises(NotImplementedError):
        ps.DetectionLoader(_Draws(), ps.YoloBatchSampler(ps.InfiniteSampler(10), 2))
