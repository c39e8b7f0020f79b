"""Process groups and batch sharding over ``torch.distributed``
(cocodet_tpu/parallel/mesh.py).

JAX runs one program over a device mesh and lets GSPMD insert the
collectives. Here each rank is one process with one device, and a ``Mesh``
is that rank's view of the grid: its (data, space) coordinates, its device
and the three process groups its collectives use. Ranks are laid out as
JAX's ``make_mesh_2d`` reshapes its devices: rank = data * n_space + space.

- ``world``: every rank; BN's batch statistics and the gradient are summed
  over it.
- ``data``: the ranks with this rank's space coordinate, one for each data
  row; the loss normaliser (``num_fg``) and the reported losses are summed
  over it.
- ``space``: the ranks with this rank's data coordinate, which hold the
  rows of the same images; conv halos and the head maps travel over it.
  ``None`` on a 1-D mesh.

The backend follows the device the caller names: NCCL where each rank owns
a card, gloo on the CPU and where ranks share a card (NCCL refuses two ranks
on one device). A gloo group given CUDA tensors stages them through host
memory (``collectives.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .collectives import broadcast

DATA_AXIS = "data"
SPACE_AXIS = "space"

# how long a collective may wait for its peers before the rank fails
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of an (n_data x n_space) mesh."""

    device: torch.device
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    world: Any            # process groups
    data: Any
    space: Any            # None on a 1-D mesh

    @property
    def size(self) -> int:
        return self.n_data * self.n_space


def backend_for(device: torch.device, world_size: int) -> str:
    """NCCL when every rank can own a card, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device: torch.device) -> str:
    """Join the ranks' default process group (``jax.distributed.initialize``
    in JAX) at ``init_method`` (``file://...`` or ``tcp://host:port``).
    Returns the backend, chosen by ``backend_for``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device, world_size)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT,
                            **({"device_id": device} if backend == "nccl" else {}))
    return backend


def _new_groups(members: Sequence[Sequence[int]], rank: int):
    """Create a group for each list of ranks (every rank creates every group,
    in the same order, as ``new_group`` requires) and return this rank's."""
    mine = None
    for ranks in members:
        group = dist.new_group(list(ranks), timeout=COLLECTIVE_TIMEOUT)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(device: torch.device) -> Mesh:
    """The 1-D data mesh over every rank of the default group."""
    world = dist.group.WORLD
    return Mesh(torch.device(device), dist.get_world_size(), 1, dist.get_rank(), 0, world,
                world, None)


def make_mesh_2d(n_space: int, device: torch.device) -> Mesh:
    """(data, space) mesh: batch over rows, image height over columns.
    Collective: every rank of the default group calls it."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_space < 1 or world % n_space:
        raise ValueError(f"{world} ranks not divisible by n_space={n_space}")
    n_data = world // n_space
    data = _new_groups([[d * n_space + s for d in range(n_data)] for s in range(n_space)],
                       rank)
    space = _new_groups([[d * n_space + s for s in range(n_space)] for d in range(n_data)],
                        rank)
    return Mesh(torch.device(device), n_data, n_space, rank // n_space, rank % n_space,
                dist.group.WORLD, data, space if n_space > 1 else None)


def check_spatial_sizes(sizes: Sequence[Tuple[int, int]], n_space: int,
                        max_stride: int) -> None:
    """Refuse training sizes whose deepest map would not keep at least two
    evenly divided rows on each space rank: ``H % (max_stride * n_space)``
    must be 0 and ``H >= 2 * n_space * max_stride``, the rule of
    cocodet_tpu/core/trainer.py::Trainer._check_spatial_sizes. The port's
    halos need every map divided evenly over the space ranks."""
    for h, _ in sizes:
        if h % (max_stride * n_space) or h < 2 * n_space * max_stride:
            raise ValueError(
                f"spatial_devices={n_space}: training size {h} is in the unsafe sharding "
                f"regime (need H % {max_stride * n_space} == 0 and H >= "
                f"{2 * n_space * max_stride} so every feature map keeps >=2 "
                f"evenly-divided rows per space device)")


# --------------------------------------------------------------------------
# the mesh a forward runs under
# --------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "cocodet_mesh", default=None)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``use_mesh``, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Run the model's layers sharded over ``mesh``: BN in train mode on the
    statistics of the global batch, and on a space axis the convs with
    halos and the pools on the whole height."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


# --------------------------------------------------------------------------
# batch sharding: each rank keeps its slice of a host batch
# --------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]


def data_sharding(mesh: Mesh, ndim: int, axis_name: str = DATA_AXIS) -> Spec:
    """Split dim 0 (batch) over the data axis."""
    return (axis_name,) + (None,) * (ndim - 1)


def image_sharding(mesh: Mesh) -> Spec:
    """NHWC images: batch over data, height over space on a 2-D mesh."""
    if mesh.n_space > 1:
        return (DATA_AXIS, SPACE_AXIS, None, None)
    return (DATA_AXIS,)


def replicated(mesh: Mesh) -> Spec:
    return ()


def batch_sharding_fn(mesh: Mesh) -> Callable[[Any], Spec]:
    """The spec of each leaf of a mixed batch: only leaves that look like
    NHWC images (rank 4, a 1- or 3-wide channel axis last, a height that the
    space axis divides) are height-split; everything else splits on the
    batch only (cocodet_tpu/parallel/mesh.py::batch_sharding_fn)."""
    def choose(x) -> Spec:
        shape = tuple(x.shape)
        if (len(shape) == 4 and mesh.n_space > 1 and shape[-1] in (1, 3)
                and shape[1] % mesh.n_space == 0):
            return image_sharding(mesh)
        return data_sharding(mesh, len(shape))
    return choose


def _local_slice(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = ((mesh.n_data, mesh.data_index) if axis == DATA_AXIS
                else (mesh.n_space, mesh.space_index))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over the "
                             f"{n} ranks of the {axis} axis")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of a host batch (arrays or tensors, alone or in
    tuples, lists and dicts) on the mesh's device."""
    choose = batch_sharding_fn(mesh)

    def local(x):
        x = torch.as_tensor(x)
        return _local_slice(x, choose(x), mesh).contiguous().to(mesh.device)
    return _tree_map(local, batch)


@torch.no_grad()
def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast the module's parameters and buffers from rank 0 over the
    world, so every rank starts from the same state."""
    for t in list(module.parameters()) + list(module.buffers()):
        broadcast(t.data, 0, mesh.world)
    return module


def process_allgather_detections(records):
    """Every rank's python detection records, concatenated in rank order
    (the reference gathered pickles over gloo). Only rank 0's return value
    matters."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return records
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, records)
    return [r for part in gathered for r in part]


def sync_global_devices(name: str = "barrier") -> None:
    """Barrier over every rank."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
