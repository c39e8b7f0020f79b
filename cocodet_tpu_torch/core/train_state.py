"""The training step (cocodet_tpu/core/train_state.py:53-136) and its
optimizer (cocodet_tpu/exp/yolox_exp.py:232-250), with gradient
accumulation (``optax.MultiSteps``, cocodet_tpu/core/trainer.py:106-110)
and remat (``jax.checkpoint`` of the forward, train_state.py:92-93).

One call of the step runs the model forward in train mode (BN on the batch
statistics, which it folds into the running ones), SimOTA and the losses,
the backward, the SGD step and the EMA update: JAX's jitted ``train_step``,
run eagerly. The model keeps f32 parameters and computes in its ``dtype``
(bf16 on the card), as the flax model does; the gradients arrive in f32.

The state is the model itself (parameters and BN statistics, updated in
place), the optimizer's momentum buffers and the EMA shadow. Nothing in the
step reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
import contextlib
from typing import Callable, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.losses import yolox_losses
from ..parallel.collectives import all_reduce_, gather_rows
from ..parallel.mesh import Mesh, check_spatial_sizes, replicate, use_mesh
from ..utils.ema import ModelEMA

Schedule = Union[float, Callable[[int], float]]


class SGD(torch.optim.SGD):
    """``optax.chain(add_decayed_weights(wd, mask), sgd(schedule, momentum,
    nesterov=True))``: the learning rate of a step is ``schedule(count)`` at
    the count before the step (optax's ``scale_by_schedule``), then the
    count goes up by one. A step computes optax's elementwise ops in optax's
    order, each rounded on its own (multi-tensor ops, a few launches a
    step): ``g + wd * p``, ``t = g + momentum * t``, ``u = g + momentum *
    t``, ``p + (-lr) * u``; torch's own SGD rounds ``p - lr * u`` once.
    ``state[p]["momentum_buffer"]`` is optax's trace.

    With ``every_k > 1`` (``multi_steps``) it is ``optax.MultiSteps`` of
    that chain (``use_grad_mean=True``): each ``step`` folds the gradients
    into their running mean ``acc + (g - acc) / (mini_step + 1)`` (optax
    0.2.6 ``transforms/_accumulation.py:301``, in that order, in f32), and
    only the k-th hands the mean to the chain above, then resets the mean
    and ``mini_step``; the others leave the parameters as they are.
    ``count`` is the chain's own count, optax's ``gradient_step``, so the
    schedule advances once every k steps."""

    def __init__(self, param_groups, schedule: Schedule, momentum: float = 0.9):
        self.schedule = schedule if callable(schedule) else (lambda _, lr=schedule: lr)
        self.count = 0
        self.every_k = 1
        self.mini_step = 0
        self.acc = {}  # parameter -> f32 running mean of its gradient
        super().__init__(param_groups, lr=self.schedule(0), momentum=momentum,
                         nesterov=True)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the step takes no closure")
        if self.every_k > 1 and not self._accumulate():
            return None
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["lr"] = lr
            self._update(group, lr)
        self.count += 1
        if self.every_k > 1:  # optax's (1 - emit) * acc
            torch._foreach_mul_(list(self.acc.values()), 0.0)
        return None

    def _update(self, group, lr: float) -> None:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_mul(params, group["weight_decay"])
            torch._foreach_add_(grads, [p.grad for p in params])  # wd p + g == g + wd p
        momentum = group["momentum"]
        traces = []
        for p, g in zip(params, grads):
            state = self.state[p]
            if "momentum_buffer" not in state:
                state["momentum_buffer"] = torch.zeros_like(g)
            traces.append(state["momentum_buffer"])
        torch._foreach_mul_(traces, momentum)
        torch._foreach_add_(traces, grads)
        updates = torch._foreach_mul(traces, momentum)
        torch._foreach_add_(updates, grads)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)

    def _accumulate(self) -> bool:
        """Fold this step's gradients into the running mean; True on the
        k-th step, with the mean in place of each gradient."""
        n = self.mini_step
        params = [p for group in self.param_groups for p in group["params"]]
        for p in params:
            if p not in self.acc:
                self.acc[p] = torch.zeros_like(p, dtype=torch.float32)
        accs = [self.acc[p] for p in params]
        grads = [torch.zeros_like(a) if p.grad is None else p.grad.float()
                 for p, a in zip(params, accs)]
        delta = torch._foreach_sub(grads, accs)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(accs, delta)
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return False
        self.mini_step = 0
        for p in params:
            p.grad = self.acc[p].to(p.dtype).clone()
        return True


def multi_steps(optimizer: SGD, every_k: int) -> SGD:
    """``optax.MultiSteps(optimizer, every_k_schedule=every_k)``: the
    optimizer takes a step of its own every ``every_k`` calls, on the mean
    of their gradients."""
    if every_k < 1:
        raise ValueError(f"every_k must be at least 1, not {every_k}")
    optimizer.every_k = int(every_k)
    return optimizer


def build_optimizer(model: nn.Module, schedule: Schedule, weight_decay: float = 5e-4,
                    momentum: float = 0.9) -> SGD:
    """SGD with nesterov momentum; weight decay on the conv kernels only
    (flax leaf ``kernel``: the 4-D weights), none on the BN scales and the
    biases (ref yolox_base.py:224-251)."""
    decay, rest = [], []
    for p in model.parameters():
        (decay if p.dim() == 4 else rest).append(p)
    return SGD([{"params": decay, "weight_decay": weight_decay},
                {"params": rest, "weight_decay": 0.0}], schedule, momentum)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer (whose
    ``count`` is the number of steps taken) and the EMA."""

    model: nn.Module
    optimizer: SGD
    ema: Optional[ModelEMA]


def create_train_state(model: nn.Module, optimizer: SGD, use_ema: bool = True,
                       ema_decay: float = 0.9998, mesh: Optional[Mesh] = None) -> TrainState:
    """The state of a step; on a ``mesh`` the model is first broadcast from
    rank 0, so every rank starts from the same parameters and statistics."""
    if mesh is not None:
        replicate(mesh, model)
    return TrainState(model=model.train(), optimizer=optimizer,
                      ema=ModelEMA(model, ema_decay) if use_ema else None)


@torch.no_grad()
def _sum_gradients(model: nn.Module, group) -> None:
    """Each parameter's gradient summed over ``group``, in one flat bucket:
    the gradient of the global batch's loss, whose parts the ranks hold."""
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        if p.grad is None:
            p.grad = g.view_as(p).clone()
        else:
            p.grad.copy_(g.view_as(p))


@contextlib.contextmanager
def keep_bn_statistics(model: nn.Module) -> Iterator[None]:
    """Leave the BN running statistics as they were on entry: train-mode BN
    folds the batch statistics into them in place, and the recomputation of
    a remat forward must not fold them a second time (JAX's mutable
    ``batch_stats`` come from the first forward only)."""
    stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    saved = [b.clone() for b in stats]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(stats, saved):
                b.copy_(v)


def make_forward(model: nn.Module, mesh: Optional[Mesh] = None,
                 remat: bool = False) -> Callable[[torch.Tensor], list]:
    """The train-mode forward of a step: the model under ``use_mesh(mesh)``,
    with ``remat`` under ``torch.utils.checkpoint`` (no activation kept for
    the backward, which runs the forward again, under the same mesh, with
    the BN running statistics left alone)."""
    def forward(images: torch.Tensor):
        with use_mesh(mesh):
            return model(images)

    if not remat:
        return forward
    if getattr(model, "split_cat", False):
        # cocodet_tpu/models/yolox.py:81-87
        raise ValueError("split_cat cannot be combined with remat")

    def rematerialized(images: torch.Tensor):
        return torch.utils.checkpoint.checkpoint(
            forward, images, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), keep_bn_statistics(model)))
    return rematerialized


def make_train_step(state: TrainState, strides: Sequence[int], num_classes: int = 80,
                    iou_type: str = "iou", simota_bf16: bool = False,
                    mesh: Optional[Mesh] = None, remat: bool = False) -> Callable:
    """The train step over ``state``, updated in place:

        step(images, labels, use_l1=False, mark=None, return_targets=False)

    ``images`` (B, H, W, 3) f32 NHWC on the model's device, ``labels`` (B,
    G, 5) [class, cx, cy, w, h] zero-padded. Returns the metrics dict of
    JAX's step as device tensors (and the SimOTA targets if asked). ``mark``,
    if given, is called with "forward", "losses", "backward" and "update"
    as each part ends (a caller's timer).

    On a ``mesh`` each rank passes its slice of the global batch
    (``parallel.shard_batch``): its images, and on a space axis its rows of
    them. The step is JAX's step on the global batch: BN on the global
    batch's statistics, the head maps gathered over the space ranks before
    SimOTA (the anchor grid is global), each loss term over the global
    ``num_fg``, and the gradients summed over every rank before the same SGD
    and EMA on each. The metrics are the global batch's, equal on every
    rank; the targets are this rank's images'.

    ``remat`` recomputes the forward in the backward (``make_forward``).
    With an optimizer under ``multi_steps`` a call is one mini-step: the
    parameters move every k calls, the BN statistics and the EMA every
    call (cocodet_tpu/core/train_state.py:103-111)."""
    simota_dtype = torch.bfloat16 if simota_bf16 else torch.float32
    space = None if mesh is None else mesh.space
    forward = make_forward(state.model, mesh, remat)

    def step(images: torch.Tensor, labels: torch.Tensor, use_l1: bool = False,
             mark: Optional[Callable[[str], None]] = None, return_targets: bool = False):
        model, opt = state.model, state.optimizer
        model.train()
        if space is not None:
            check_spatial_sizes([(images.shape[1] * mesh.n_space, images.shape[2])],
                                mesh.n_space, max(strides))
        outputs = forward(images)
        if space is not None:
            outputs = [{k: gather_rows(v, space, dim=1) for k, v in level.items()}
                       for level in outputs]
        if mark:
            mark("forward")
        losses, targets = yolox_losses(outputs, labels, strides=strides,
                                       num_classes=num_classes, use_l1=use_l1,
                                       iou_type=iou_type, simota_dtype=simota_dtype,
                                       group=None if mesh is None else mesh.data)
        if mark:
            mark("losses")
        opt.zero_grad(set_to_none=True)
        losses.total.backward()
        if mesh is not None:
            _sum_gradients(model, mesh.world)
        if mark:
            mark("backward")
        opt.step()
        if state.ema is not None:
            state.ema.update()
        if mark:
            mark("update")
        terms = torch.stack([losses.total, losses.iou, losses.obj, losses.cls,
                             losses.l1]).detach()
        if mesh is not None:
            all_reduce_(terms, mesh.data)
        metrics = dict(zip(("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss"), terms))
        metrics.update(num_fg_per_gt=losses.num_fg_per_gt, num_fg=targets.num_fg)
        return (metrics, targets) if return_targets else metrics

    return step


def resize_batch(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC images to a multiscale bucket, as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, and when it
    shrinks, a triangle filter widened by the scale (antialiasing)."""
    b, h, w, c = images.shape
    if (h, w) == tuple(size):
        return images
    x = images.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()

