"""Start the ranks of a data-parallel run on one host: one process a rank
(``torch.multiprocessing``, spawned), joined through a ``file://``
rendezvous in a fresh temporary directory, so no port is fixed.

Each rank runs ``fn(rank, device, *args)`` on its device and hands back what
it returns. A rank that raises, or a run that outlasts ``timeout``, stops
every rank and raises here.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import initialize_distributed


def rank_device(device: Union[str, torch.device], rank: int) -> torch.device:
    """The device of ``rank``: ``"cpu"``, or card ``rank % count`` for
    ``"cuda"`` (ranks share cards when there are more ranks than cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"ranks run on cpu or cuda, not {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device='cuda' but no CUDA card is visible")
    return torch.device("cuda", rank % count)


def _rank_main(rank: int, fn: Callable, world: int, args: Sequence[Any], device: str,
               tmp: str) -> None:
    dev = rank_device(device, rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank, dev)
    try:
        result = fn(rank, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(fn: Callable, world: int, *args: Any, device: Union[str, torch.device] = "cuda",
              timeout: float = 600.0) -> List[Any]:
    """``[fn(rank, device, *args) for each rank]``, each in its own process
    in the default process group of ``world`` ranks. ``fn`` and ``args``
    must pickle (``fn`` by its import path)."""
    with tempfile.TemporaryDirectory(prefix="cocodet_ranks_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, world, tuple(args), str(device), tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish in "
                                   f"{timeout:.0f} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False)
                for r in range(world)]
