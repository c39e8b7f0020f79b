"""Samplers, the batch loader and the card prefetcher (cocodet_tpu/data/
samplers.py).

``InfiniteSampler`` is the seeded numpy permutation stream, strided by rank;
``YoloBatchSampler`` yields batches of (mosaic flag, index);
``DetectionLoader`` fetches each item on a thread pool with its own
``random.Random`` seeded from (loader seed, stream position), so the
augmentation stream does not depend on the worker count or the scheduling,
and hands the items to a collate function.

``DevicePrefetcher`` keeps the next batch on its way to the card while the
current one trains: once a batch is taken, a thread collates the next, copies each numpy array into
pinned host memory (PyTorch's caching host allocator reuses the blocks) and
queues the host-to-card copy on a side CUDA stream with an event after it.
The consumer's stream waits on that event, and each tensor is
``record_stream``-ed on it, so the allocator does not hand its memory to the
side stream before the consumer is done. On the CPU it hands the arrays over
as tensors.
"""

from __future__ import annotations

import itertools
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch


class InfiniteSampler:
    """Seeded infinite shuffled index stream, strided by (rank, world)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        assert size > 0
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite(), self.rank, None, self.world_size)

    def _infinite(self):
        g = np.random.default_rng(self.seed)
        while True:
            if self.shuffle:
                yield from g.permutation(self.size).tolist()
            else:
                yield from range(self.size)


class YoloBatchSampler:
    """Batches of (mosaic_flag, idx) tuples (ref samplers.py:14-27)."""

    def __init__(self, sampler: InfiniteSampler, batch_size: int, mosaic: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.mosaic = mosaic

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append((self.mosaic, idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []


class DetectionLoader:
    """Batch assembler over a dataset with a ``fetch(item, rng)`` (or
    ``__getitem__``) on thread workers, yielding ``collate_fn(items)``.
    ``close_mosaic()`` flips the batch sampler's flag and the dataset's own
    switch (ref dataloading.py:42-114). The JAX loader's process workers are
    not ported: the device path leaves the host decode and draws only."""

    def __init__(self, dataset, batch_sampler: YoloBatchSampler, num_workers: int = 2,
                 seed: int = 0, prefetch: int = 2, collate_fn=None):
        if collate_fn is None:
            raise NotImplementedError("the host path's float collate is not ported: the loader "
                                      "takes the device-mosaic collate")
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self._counter = 0

    def close_mosaic(self):
        self.batch_sampler.mosaic = False
        if hasattr(self.dataset, "close_mosaic"):
            self.dataset.close_mosaic()

    def _item_seed(self, counter: int) -> int:
        return (self.seed + 1) * 1_000_003 + counter

    def _fetch(self, item, counter):
        rng = random.Random(self._item_seed(counter))
        if hasattr(self.dataset, "fetch"):
            return self.dataset.fetch(item, rng)
        return self.dataset[item]

    def __iter__(self):
        batches = iter(self.batch_sampler)
        pending = queue.Queue()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:

            def submit_next():
                batch = next(batches)
                futs = []
                for it in batch:
                    futs.append(pool.submit(self._fetch, it, self._counter))
                    self._counter += 1
                pending.put(futs)

            for _ in range(self.prefetch):
                submit_next()
            try:
                while True:
                    futures = pending.get()
                    submit_next()
                    yield self.collate_fn([f.result() for f in futures])
            finally:
                while not pending.empty():
                    for f in pending.get():
                        f.cancel()


def _to_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


class DevicePrefetcher:
    """Keeps one batch on its way to ``device`` while the current one trains
    (ref data_prefetcher.py:8-51). ``next()`` returns (images, labels, infos,
    ids) with the numpy arrays as tensors on ``device``; ``bytes`` counts
    what it copied."""

    def __init__(self, loader, device: torch.device):
        self.device = torch.device(device)
        self._it = iter(loader)
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        # the first batch is loaded here, and the thread pulls batch k + 1
        # only once batch k is taken, so the loader has submitted as many
        # batches as JAX's prefetcher makes it submit (the taken ones + 3):
        # a close_mosaic() between two batches switches the same batches
        self._taken = threading.Semaphore(0)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.bytes = 0
        self._queue.put(self._load())  # the first batch before the first step, as JAX's
        self._thread = threading.Thread(target=self._work, name="prefetch", daemon=True)
        self._thread.start()

    def _put_on_card(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        self.bytes += host.numel() * host.element_size()
        if not self._cuda:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _load(self):
        """The next batch with its copy to the card queued on the side stream
        (None at the end of the loader)."""
        try:
            imgs, labels, infos, ids = next(self._it)
        except StopIteration:
            return None
        event = None
        if self._cuda:
            with torch.cuda.stream(self._stream):
                imgs = _to_tensors(imgs, self._put_on_card)
                labels = _to_tensors(labels, self._put_on_card)
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            imgs = _to_tensors(imgs, self._put_on_card)
            labels = _to_tensors(labels, self._put_on_card)
        return imgs, labels, infos, ids, event

    def _work(self):
        try:
            while True:
                self._taken.acquire()
                if self._stop.is_set():
                    return
                batch = self._load()
                self._queue.put(batch)
                if batch is None:
                    return
        except BaseException as exc:  # surfaced by next()
            self._queue.put(exc)

    def next(self):
        item = self._queue.get()
        self._taken.release()
        if item is None:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        imgs, labels, infos, ids, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _leaves(imgs) + _leaves(labels):
                t.record_stream(stream)
        return imgs, labels, infos, ids

    def __iter__(self):
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self):
        """Stop the thread (it finishes the batch it is on) and drop what is
        queued."""
        self._stop.set()
        while self._thread.is_alive():
            self._taken.release()
            try:
                self._queue.get(timeout=0.1)
            except queue.Empty:
                pass
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


def _leaves(tree: Any) -> list:
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
