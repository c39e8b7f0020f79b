"""Differentiable collectives: what GSPMD inserts into JAX's sharded train
step, written out for ``torch.distributed``.

- ``all_reduce_sum``: the sum over a group; its backward sums the
  cotangents over the group. (BN's batch statistics are summed with
  ``all_reduce_`` inside BN's own autograd Function, models/blocks.py::
  _BatchNormAct, whose backward sums its cotangent sums the same way.)
- ``gather_rows``: the whole height from the space ranks' rows (equal, or
  each rank's own count where a serving batch's height does not split
  evenly); its backward
  keeps this rank's rows of the cotangent, which is right where every rank of
  the group computes the same function of the gathered tensor (the loss).
- ``halo_exchange``: a rank's rows with ``top`` rows of the ranks above and
  ``bottom`` rows of the ranks below, ``fill`` beyond the map's edge (a
  conv's zero padding, a max pool's -inf); its backward sends each halo's
  cotangent back to the rows it came from and adds it there.

A gloo group cannot be handed every collective on CUDA tensors, so for a
gloo group the tensors of every collective are staged through host memory
explicitly (gloo's own CUDA paths copy through the host as well). NCCL
groups take CUDA tensors directly.

Each collective counts its calls (``calls``), the calls staged through the
host (``host_staged``) and the host's seconds inside it (``host_seconds``,
which for a staged call includes waiting for the card to finish the work
queued before it), by name.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import time
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

calls: collections.Counter = collections.Counter()
host_staged: collections.Counter = collections.Counter()
host_seconds: collections.Counter = collections.Counter()


def reset_counts() -> None:
    for counter in (calls, host_staged, host_seconds):
        counter.clear()


@contextlib.contextmanager
def _counted(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        calls[name] += 1
        host_seconds[name] += time.perf_counter() - t0


def _staged(t: torch.Tensor, group, name: str) -> bool:
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host_staged[name] += 1
        return True
    return False


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place sum (or ``op``) of ``t`` over ``group`` (not
    differentiable)."""
    with _counted("all_reduce"):
        if _staged(t, group, "all_reduce"):
            host = t.cpu()
            dist.all_reduce(host, op=op, group=group)
            return t.copy_(host)
        dist.all_reduce(t, op=op, group=group)
        return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of ``t`` from global rank ``src``."""
    with _counted("broadcast"):
        if _staged(t, group, "broadcast"):
            host = t.cpu()
            dist.broadcast(host, src, group=group)
            return t.copy_(host)
        dist.broadcast(t, src, group=group)
        return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in group-rank order, contiguous."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    with _counted("all_gather"):
        if _staged(t, group, "all_gather"):
            host = t.cpu()
            out = [torch.empty_like(host) for _ in range(n)]
            dist.all_gather(out, host, group=group)
            return [o.to(t.device) for o in out]
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
        return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        rows = x.shape[dim]
        i = dist.get_rank(group)
        sizes = sizes or (rows,) * dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rows, ctx.start = group, dim, rows, sum(sizes[:i])
        top = max(sizes)
        if top == rows and min(sizes) == rows:
            return torch.cat(all_gather(x, group), dim)
        # uneven rows: every rank sends max(sizes) rows, its own first
        padded = torch.cat([x, x.new_zeros(x.shape[:dim] + (top - rows,) + x.shape[dim + 1:])],
                           dim)
        parts = all_gather(padded, group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.rows), None, None, None


def gather_rows(x: torch.Tensor, group, dim: int = 2,
                sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Concatenate the group's ``x`` along ``dim`` in rank order; ``sizes``,
    each rank's rows, where they differ (default: all ``x``'s). The backward
    returns this rank's slice of the cotangent: use it only where every rank
    of the group computes the same function of the result."""
    return _GatherRows.apply(x, group, dim, tuple(sizes) if sizes else None)


def _ranges(lo: int, hi: int, starts: Sequence[int]):
    """(rank, first local row, count) runs covering global rows [lo, hi) of
    a map whose rank q holds rows [starts[q], starts[q + 1]), and (None, 0,
    count) for rows outside [0, starts[-1])."""
    out, g = [], lo
    while g < hi:
        if g < 0 or g >= starts[-1]:
            end = min(hi, 0) if g < 0 else hi
            out.append((None, 0, end - g))
        else:
            q = bisect.bisect_right(starts, g) - 1
            end = min(hi, starts[q + 1])
            out.append((q, g - starts[q], end - g))
        g = end
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, group, dim, fill, sizes):
        n, i, h = dist.get_world_size(group), dist.get_rank(group), x.shape[dim]
        sizes = sizes or (h,) * n
        starts = [0, *itertools.accumulate(sizes)]
        ctx.args = (top, bottom, group, dim, i, h, starts)
        # each rank q sends the rows any neighbour's halo can reach: its first
        # min(bottom, h_q) rows (for the ranks above) and its last min(top,
        # h_q) (for the ranks below), each block padded to the largest rank's
        b_max, t_max = min(bottom, max(sizes)), min(top, max(sizes))
        b, t = min(bottom, h), min(top, h)

        def pad(block, rows):
            shape = list(block.shape)
            shape[dim] = rows - block.shape[dim]
            return torch.cat([block, block.new_zeros(shape)], dim) if shape[dim] else block

        sent = all_gather(torch.cat([pad(x.narrow(dim, 0, b), b_max),
                                     pad(x.narrow(dim, h - t, t), t_max)], dim), group)

        def rows(q, first, count, below):
            if q is None:
                shape = list(x.shape)
                shape[dim] = count
                return x.new_full(shape, fill)
            # a halo above this rank takes from the sender's last t_q rows
            offset = first if below else b_max + first - (sizes[q] - min(top, sizes[q]))
            return sent[q].narrow(dim, offset, count)

        lo, hi = starts[i], starts[i + 1]
        parts = [rows(q, f, c, False) for q, f, c in _ranges(lo - top, lo, starts)]
        parts.append(x)
        parts += [rows(q, f, c, True) for q, f, c in _ranges(hi, hi + bottom, starts)]
        out = torch.cat(parts, dim)
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, g):
        top, bottom, group, dim, i, h, starts = ctx.args
        gx = g.narrow(dim, top, h).clone()
        halos = all_gather(torch.cat([g.narrow(dim, 0, top), g.narrow(dim, top + h, bottom)],
                                     dim), group)
        lo = starts[i]
        for j, sent in enumerate(halos):
            # rank j's halos cover global rows [start_j - top, start_j) and
            # [start_j+1, start_j+1 + bottom); add what falls on this rank
            for first, offset, size in ((starts[j] - top, 0, top), (starts[j + 1], top, bottom)):
                a, z = max(first, lo), min(first + size, lo + h)
                if a < z:
                    gx.narrow(dim, a - lo, z - a).add_(sent.narrow(dim, offset + a - first, z - a))
        return gx, None, None, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group, dim: int = 2,
                  fill: float = 0.0, sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x`` with ``top`` rows of the ranks above and ``bottom`` rows of the
    ranks below along ``dim`` (several ranks' rows where a halo is deeper than
    one rank's share), and ``fill`` where the halo passes the map's edge.
    ``sizes``: each rank's rows, where they differ (default: every rank
    holds as many rows as ``x``)."""
    if top == 0 and bottom == 0:
        return x
    return _HaloExchange.apply(x, top, bottom, group, dim, fill,
                               tuple(sizes) if sizes else None)
