"""Start the ranks of a data-parallel run on this host: one process a rank
(``torch.multiprocessing``, spawned). On one host they join through a
``file://`` rendezvous in a fresh temporary directory, so no port is fixed;
across hosts each host starts its own ranks and all of them join the
``tcp://`` rendezvous of ``init_method``.

Each rank runs ``fn(rank, device, *args)`` on its device and hands back what
it returns. A rank that raises, or a run that outlasts ``timeout``, stops
every rank of this host and raises here.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import initialize_distributed


def rank_device(device: Union[str, torch.device], local_rank: int) -> torch.device:
    """The device of a host's ``local_rank``: ``"cpu"``, or card
    ``local_rank % count`` for ``"cuda"`` (ranks share cards when there are
    more ranks than cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"ranks run on cpu or cuda, not {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device='cuda' but no CUDA card is visible")
    return torch.device("cuda", local_rank % count)


def _rank_main(local: int, fn: Callable, nprocs: int, args: Sequence[Any], device: str,
               tmp: str, init_method: str, world_size: int, rank_offset: int) -> None:
    dev = rank_device(device, local)
    rank = rank_offset + local
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    initialize_distributed(init_method, world_size, rank, dev)
    try:
        result = fn(rank, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(tmp, f"rank{local}.pt"))


def run_ranks(fn: Callable, world: int, *args: Any, device: Union[str, torch.device] = "cuda",
              timeout: Optional[float] = 600.0, init_method: Optional[str] = None,
              world_size: Optional[int] = None, rank_offset: int = 0) -> List[Any]:
    """``[fn(rank, device, *args) for each of this host's ranks]``, each in
    its own process. ``world`` ranks start here, numbered ``rank_offset`` on,
    in the default process group of ``world_size`` ranks (default
    ``world``) at ``init_method`` (default: a ``file://`` rendezvous of its
    own). ``fn`` and ``args`` must pickle (``fn`` by its import path);
    ``timeout`` None waits as long as the ranks run."""
    with tempfile.TemporaryDirectory(prefix="cocodet_ranks_") as tmp:
        init = init_method or f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, tuple(args), str(device), tmp, init,
                              world_size or world, rank_offset),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=5.0 if deadline is None
                           else max(0.0, min(5.0, deadline - time.monotonic()))):
            if deadline is not None and time.monotonic() >= deadline:
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
