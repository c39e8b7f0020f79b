"""LR schedules as plain functions of the global iteration
(cocodet_tpu/utils/lr_scheduler.py:20-85): cos, warmcos, yoloxwarmcos
(quadratic warmup, cosine decay to ``min_lr_ratio * lr``, a flat floor over
the no-aug tail), yoloxsemiwarmcos and multistep. The optimizer reads them
on the host, with no device work."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Sequence


def cos_lr(lr: float, total_iters: int, iters: int) -> float:
    return lr * 0.5 * (1.0 + math.cos(math.pi * iters / total_iters))


def warm_cos_lr(lr: float, total_iters: int, warmup_iters: int,
                warmup_lr_start: float, iters: int) -> float:
    if iters < warmup_iters:
        return warmup_lr_start + (lr - warmup_lr_start) * iters / max(warmup_iters, 1)
    return lr * 0.5 * (1.0 + math.cos(
        math.pi * (iters - warmup_iters) / max(total_iters - warmup_iters, 1)))


def yolox_warm_cos_lr(lr: float, min_lr_ratio: float, total_iters: int,
                      warmup_iters: int, warmup_lr_start: float,
                      no_aug_iters: int, iters: int) -> float:
    """Quadratic warmup -> cosine -> flat min over the no-aug tail
    (ref lr_scheduler.py:113-131)."""
    min_lr = lr * min_lr_ratio
    if iters < warmup_iters:
        return (lr - warmup_lr_start) * (iters / max(warmup_iters, 1)) ** 2 + warmup_lr_start
    if iters >= total_iters - no_aug_iters:
        return min_lr
    span = max(total_iters - warmup_iters - no_aug_iters, 1)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * (iters - warmup_iters) / span))


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float, iters: int) -> float:
    return lr * gamma ** sum(iters >= m for m in milestones)


def build_lr_schedule(
    name: str,
    lr: float,
    iters_per_epoch: int,
    total_epochs: int,
    warmup_epochs: int = 5,
    warmup_lr_start: float = 0.0,
    no_aug_epochs: int = 15,
    min_lr_ratio: float = 0.05,
    milestones: Sequence[int] = (),
    gamma: float = 0.1,
) -> Callable[[int], float]:
    """Schedule factory keyed like ref LRScheduler.__init__ (:9-60)."""
    total_iters = iters_per_epoch * total_epochs
    warmup_iters = iters_per_epoch * warmup_epochs
    no_aug_iters = iters_per_epoch * no_aug_epochs
    if name == "cos":
        return partial(cos_lr, lr, total_iters)
    if name == "warmcos":
        return partial(warm_cos_lr, lr, total_iters, warmup_iters, warmup_lr_start)
    if name in ("yoloxwarmcos", "yoloxsemiwarmcos"):
        return partial(yolox_warm_cos_lr, lr, min_lr_ratio, total_iters,
                       warmup_iters, warmup_lr_start, no_aug_iters)
    if name == "multistep":
        return partial(multistep_lr, lr, [int(m * iters_per_epoch) for m in milestones], gamma)
    raise ValueError(f"unknown scheduler {name!r}")
