"""The Pruner (cocodet_tpu/core/pruner.py): iterative structured channel
pruning with attention-transfer distillation, on the port's trainer.

- The student, the ChannelMask model, trains on the detection loss plus the
  distillation loss from a frozen teacher, the init weights without masks
  (``make_distill_train_step``; pruner.py:43-103).
- Every ``prune_interval`` of an epoch, the per-channel Taylor importance
  ``(bn.scale * d bn.scale + bn.bias * d bn.bias)^2`` of every masked conv
  is summed over ``prune_score_batches`` batches (``make_score_step``: the
  model in eval mode, the gradients of the detection loss with respect to
  the BN parameters only), and the globally least important
  ``prune_channels`` are masked (``apply_channel_prune``): ``scale *=
  keep``, ``offset += bn.bias`` on the channels removed now (pruner.py:
  106-292). Residual streams prune as one site (``find_residual_groups``).
- The EMA is off (pruner.py:326).

The selection is numpy on the host on flax-layout trees, as in JAX: the
same importance gives the same masks. On a mesh of ranks (JAX's
``_setup_mesh``, pruner.py:333-372) the steps are JAX's steps on the
global batch, as ``core/train_state.py::make_train_step(mesh=)``'s: the
student's BN over the global batch, the head maps gathered over the space
ranks, the detection loss over the global ``num_fg``, the distillation
loss's shares (``models/distill.py``), every gradient summed over the
world; the importance squares the BN parameters' gradients summed over the
world (a sum of per-rank importances would be another number). Rank 0
selects and broadcasts the gates, so every rank holds them bit for bit.
The steps run eagerly on the card:
the student's train-mode BN through the BN+act kernels with the gates
folded into their vectors, the teacher's and the score step's eval-mode BN
with the standalone hard-swish kernel, forward and (the score step)
backward.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.samplers import DevicePrefetcher
from ..models.distill import distiller_loss
from ..ops.losses import yolox_losses
from ..parallel.collectives import all_reduce_, broadcast
from ..parallel.mesh import Mesh, use_mesh
from ..utils.checkpoint import load_checkpoint
from ..utils.convert import export_variables, flatten_tree, load_masks, unflatten_tree
from .train_state import TrainState, backward, create_train_state, gather_head_maps
from .trainer import Trainer

logger = logging.getLogger("cocodet_tpu_torch")

Scope = Tuple[str, ...]
METRICS = ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss", "dis_loss",
           "dis_backbone_loss", "dis_fpn_loss")


def make_distill_train_step(state: TrainState, teacher: nn.Module, strides: Sequence[int],
                            num_classes: int = 80, iou_type: str = "iou",
                            distill_coefficient: float = 1.0,
                            simota_bf16: bool = False, mesh: Optional[Mesh] = None) -> Callable:
    """The train step with the detection and distillation losses
    (pruner.py:43-103) over ``state``, updated in place:

        step(images, labels, use_l1=False, step_optimizer=True, mark=None)

    The student (``state.model``) runs in train mode with its taps; the
    ``teacher`` in eval mode without gradients. ``step_optimizer=False``
    leaves the parameters and the optimizer's count as they are (the BN
    statistics and the EMA still move), as JAX's gate does. Returns the
    metrics as device tensors; ``mark`` is called with "forward", "losses",
    "backward" and "update" as each part ends.

    On a ``mesh`` each rank passes its slice of the global batch, as to
    ``make_train_step(mesh=)``; the teacher runs on the rank's rows, and
    the metrics are the global batch's, equal on every rank."""
    simota_dtype = torch.bfloat16 if simota_bf16 else torch.float32
    teacher.eval().requires_grad_(False)
    group = None if mesh is None else mesh.data

    def step(images: torch.Tensor, labels: torch.Tensor, use_l1: bool = False,
             step_optimizer: bool = True, mark: Optional[Callable[[str], None]] = None):
        model, opt = state.model, state.optimizer
        model.train()
        with use_mesh(mesh):
            outputs, s_taps = model(images, return_taps=True)
            with torch.no_grad():
                _, t_taps = teacher(images, return_taps=True)
        outputs = gather_head_maps(outputs, mesh)
        if mark:
            mark("forward")
        det, _ = yolox_losses(outputs, labels, strides=strides, num_classes=num_classes,
                              use_l1=use_l1, iou_type=iou_type, simota_dtype=simota_dtype,
                              group=group)
        dis = distiller_loss(s_taps, t_taps, mesh)
        total = det.total + distill_coefficient * dis["dis_loss"]
        if mark:
            mark("losses")
        backward(model, opt, total, mesh)
        if mark:
            mark("backward")
        if step_optimizer:
            opt.step()
        if state.ema is not None:
            state.ema.update()
        if mark:
            mark("update")
        terms = torch.stack([det.total, det.iou, det.obj, det.cls, det.l1, dis["dis_loss"],
                             dis["dis_backbone_loss"], dis["dis_fpn_loss"]]).detach()
        if mesh is not None:
            # the detection terms are equal on a data row's space ranks, the
            # distillation shares sum over the world: one sum over it
            terms[:5] /= mesh.n_space
            all_reduce_(terms, mesh.world)
        return dict(zip(METRICS, terms))

    return step


# --------------------------------------------------------------------------
# channel importance and mask surgery
# --------------------------------------------------------------------------


def masked_sites(model: nn.Module) -> Dict[Scope, nn.Module]:
    """``{flax scope: ConvBnAct}`` of every conv with a ChannelMask gate."""
    return {tuple(name.split(".")): m for name, m in model.named_modules()
            if getattr(m, "mask", None) is not None and getattr(m, "bn", None) is not None}


def make_score_step(model: nn.Module, strides: Sequence[int], num_classes: int = 80,
                    iou_type: str = "iou", mesh: Optional[Mesh] = None) -> Callable:
    """``score(images, labels) -> {scope: importance}`` (pruner.py:106-122):
    the model in eval mode, the gradients of the detection loss with respect
    to each masked conv's BN scale and bias (autograd walks only what they
    need), and ``channel_importance`` of them, as device tensors. On a
    ``mesh`` the images are this rank's share of the global batch: the
    head maps are gathered over the space ranks, the loss is over the
    global ``num_fg``, and the gradients are summed over the world in one
    all-reduce before they are squared, so every rank holds the global
    batch's importance."""
    sites = masked_sites(model)
    leaves = [t for m in sites.values() for t in (m.bn.weight, m.bn.bias)]
    group = None if mesh is None else mesh.data

    def score(images: torch.Tensor, labels: torch.Tensor) -> Dict[Scope, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with use_mesh(mesh):
                outputs = model(images)
            det, _ = yolox_losses(gather_head_maps(outputs, mesh), labels, strides=strides,
                                  num_classes=num_classes, iou_type=iou_type, group=group)
            grads = torch.autograd.grad(det.total, leaves)
        finally:
            model.train(was_training)
        if mesh is not None:
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh.world)
            grads = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]),
                                                   grads)]
        out = {}
        for i, (scope, m) in enumerate(sites.items()):
            g_scale, g_bias = grads[2 * i], grads[2 * i + 1]
            out[scope] = (m.bn.weight.detach() * g_scale
                          + m.bn.bias.detach() * g_bias).square()
        return out

    return score


def channel_importance(variables: Mapping[str, Any], grads: Mapping[str, Any]
                       ) -> Dict[Scope, Any]:
    """``(bn.scale * g_scale + bn.bias * g_bias)^2`` per masked conv of
    flax-layout trees (pruner.py:125-141); keys are the mask scopes."""
    params = flatten_tree(variables["params"])
    gflat = flatten_tree(grads)
    out = {}
    for path in flatten_tree(variables.get("masks", {})):
        if path[-2:] != ("mask", "scale"):
            continue
        scope = path[:-2]
        out[scope] = (params[scope + ("bn", "scale")] * gflat[scope + ("bn", "scale")]
                      + params[scope + ("bn", "bias")] * gflat[scope + ("bn", "bias")]) ** 2
    return out


def find_residual_groups(scopes, params: Mapping[Tuple, Any]) -> Dict[Scope, Tuple[Scope, ...]]:
    """Tied residual-stream mask groups ``{leader: (member, ...)}``
    (pruner.py:144-171): a CSP conv1 with a mask leads (models mask it only
    in a residual chain), its bottlenecks' conv2 masks are the members.
    ``params`` is a flat flax param dict (only its keys are read)."""
    scopes = set(scopes)
    groups = {}
    for s in scopes:
        if s[-1] != "conv1" or len(s) < 2:
            continue
        csp = s[:-1]
        if csp + ("m0", "conv1", "conv", "kernel") not in params:
            continue  # not a CSP bottleneck chain (an SPP conv1)
        members = []
        i = 0
        while csp + (f"m{i}", "conv2") in scopes:
            members.append(csp + (f"m{i}", "conv2"))
            i += 1
        if members:
            groups[s] = tuple(members)
    return groups


def apply_channel_prune(variables: Mapping[str, Any], importance: Mapping[Scope, Any],
                        prune_channels: int, site_floor: int = 1, max_frac: float = 1.0,
                        normalize: Optional[str] = None) -> Tuple[Dict[str, Any], int]:
    """Mask the globally least important ``prune_channels`` channels
    (pruner.py:174-292): returns (variables with the new ``masks``, the
    count pruned now). Already-pruned channels rank +inf; a residual group
    ranks as one site (the sum of its sites' scores) and costs its size;
    ``site_floor`` keeps each site's best alive channels, ``max_frac`` caps
    the share of a site ever pruned, ``normalize="mean"`` divides each
    site's scores by its alive mean; a group pick that would overshoot the
    count is skipped for cheaper sites. The order is a stable argsort of
    the scores in f64."""
    params = flatten_tree(variables["params"])
    masks = dict(flatten_tree(variables["masks"]))
    groups = find_residual_groups(importance.keys(), params)
    member_of = {m: lead for lead, ms in groups.items() for m in ms}

    flat_scores = []
    index = []  # (scope, channel)
    budget: Dict[Scope, int] = {}  # per-site remaining prunable channels
    weight: Dict[Scope, int] = {}  # conv channels zeroed per pruned unit
    for scope, imp in importance.items():
        if scope in member_of:
            continue  # ranked through its group's leader
        scale = np.asarray(masks[scope + ("mask", "scale")])
        alive_mask = scale > 0.0

        def _norm(a):
            a = np.asarray(a, np.float64)
            if normalize == "mean" and alive_mask.any():
                a = a / (a[alive_mask].mean() + 1e-12)
            return a

        imp = _norm(imp)
        for m in groups.get(scope, ()):
            imp = imp + _norm(importance[m])
        weight[scope] = 1 + len(groups.get(scope, ()))
        imp = np.where(~alive_mask, np.inf, imp)
        # protect the site_floor best alive channels: no conv reaches width 0
        alive = np.isfinite(imp)
        n_alive = int(alive.sum())
        floor = max(min(site_floor, n_alive), 1)
        if n_alive:
            top = np.argsort(np.where(alive, imp, -np.inf))[-floor:]
            imp[top] = np.inf
        total = scale.shape[0]
        budget[scope] = max(int(max_frac * total) - (total - n_alive), 0)
        for c in range(imp.shape[0]):
            flat_scores.append(imp[c])
            index.append((scope, c))
    flat_scores = np.asarray(flat_scores)
    order = np.argsort(flat_scores, kind="stable")

    to_prune = []
    n_sel = 0
    n_skip_budget = n_skip_overshoot = 0
    for i in order:
        if n_sel >= prune_channels:
            break
        if not np.isfinite(flat_scores[i]):
            continue
        scope, c = index[i]
        if budget[scope] <= 0:
            n_skip_budget += 1
            continue
        if n_sel + weight[scope] > prune_channels:
            n_skip_overshoot += 1
            continue
        budget[scope] -= 1
        n_sel += weight[scope]
        to_prune.append((scope, c))
    if n_skip_budget or n_skip_overshoot or n_sel < prune_channels:
        logger.info("prune selection: %d/%d channels selected (%d candidates skipped by "
                    "max_frac budget, %d by group-overshoot)", n_sel, prune_channels,
                    n_skip_budget, n_skip_overshoot)

    by_scope: Dict[Scope, list] = {}
    for scope, c in to_prune:
        by_scope.setdefault(scope, []).append(c)
    n_new = 0
    for scope, chans in by_scope.items():
        for site in (scope,) + groups.get(scope, ()):
            scale = np.array(masks[site + ("mask", "scale")], np.float32)
            offset = np.array(masks[site + ("mask", "offset")], np.float32)
            bn_bias = np.asarray(params[site + ("bn", "bias")])
            keep = np.ones_like(scale)
            keep[chans] = 0.0
            newly = (1.0 - keep) * scale  # the channels removed just now
            offset += bn_bias * newly
            scale *= keep
            masks[site + ("mask", "scale")] = scale
            masks[site + ("mask", "offset")] = offset
            n_new += int(newly.sum())
    new_vars = dict(variables)
    new_vars["masks"] = unflatten_tree(masks)
    return new_vars, n_new


def mask_stats(variables: Mapping[str, Any]) -> Dict[str, Tuple[int, int]]:
    """``{"a/b/conv": (kept, total)}`` channels of every gate
    (pruner.py:295-304)."""
    out = {}
    for path, v in flatten_tree(variables.get("masks", {})).items():
        if path[-2:] == ("mask", "scale"):
            arr = np.asarray(v)
            out["/".join(path[:-2])] = (int(arr.sum()), arr.shape[0])
    return out


# --------------------------------------------------------------------------
# the runtime
# --------------------------------------------------------------------------


def distill_epoch(trainer: Trainer, step: Callable, step_optimizer: bool,
                  after_iter: Optional[Callable[[int], None]] = None) -> None:
    """One epoch of ``step`` (a distill step) at the loader's size, with no
    multiscale switch (pruner.py:385-405, tuner.py:69-88): the losses
    checked for finite values on the card, the metrics read every
    ``print_interval`` iterations, the epoch's numbers appended to
    ``trainer.epoch_stats``; ``after_iter(it)`` after each step."""
    exp = trainer.exp
    bad = torch.zeros((), dtype=torch.int64, device=trainer.device)
    waits = []
    t_epoch = time.perf_counter()
    for it in range(trainer.iters_per_epoch):
        t0 = time.perf_counter()
        imgs, labels = trainer._next_batch()
        t1 = time.perf_counter()
        waits.append(t1 - t0)
        metrics = step(imgs, labels, use_l1=trainer.use_l1, step_optimizer=step_optimizer)
        bad += (~torch.isfinite(torch.stack(list(metrics.values())))).sum()
        if (it + 1) % exp.print_interval == 0:
            values = {k: float(v) for k, v in metrics.items()}  # the sync point
            global_iter = trainer.epoch * trainer.iters_per_epoch + it
            trainer.meter.update(data_time=t1 - t0, iter_time=time.perf_counter() - t0,
                                 lr=trainer.lr_schedule(global_iter), **values)
            trainer._log_progress(it, tuple(imgs.shape[1:3]))
        if after_iter is not None:
            after_iter(it)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    wall = time.perf_counter() - t_epoch
    n = trainer.iters_per_epoch
    trainer.epoch_stats.append({"epoch": trainer.epoch + 1, "iterations": n, "seconds": wall,
                                "img_per_s": n * trainer.args.batch_size / wall,
                                "data_wait_ms": 1e3 * float(np.mean(waits)),
                                "use_l1": trainer.use_l1, "nonfinite_losses": int(bad)})
    if int(bad):
        logger.warning("epoch %d: %d non-finite loss values", trainer.epoch + 1, int(bad))


class Pruner(Trainer):
    """Trainer + teacher distillation + periodic channel pruning
    (pruner.py:307-424). ``prune_events`` holds each event's numbers. Its
    optimizer takes no ``num_accumulate``: JAX's Pruner builds
    ``exp.get_optimizer`` with no ``optax.MultiSteps`` (pruner.py:340).
    On several ranks it trains on the Trainer's mesh (a data mesh, or data
    x space with ``spatial_devices``): each rank draws its rows of every
    batch, the score batches too; the checkpoints are rank 0's, the
    evaluation is sharded."""

    def __init__(self, exp, args, device: Any = "cuda"):
        super().__init__(exp, args, device)
        self.prune_interval = getattr(exp, "prune_interval", 0.5)
        self.prune_channels = getattr(exp, "prune_channels", 64)
        self.prune_start_epoch = getattr(exp, "prune_start_epoch", 0)
        # epochs from prune_end_epoch on train without new prune events
        self.prune_end_epoch = getattr(exp, "prune_end_epoch", None)
        self.score_batches = getattr(exp, "prune_score_batches", 8)
        self.prune_site_floor = getattr(exp, "prune_site_floor", 1)
        self.prune_max_frac = getattr(exp, "prune_max_frac", 1.0)
        self.prune_normalize = getattr(exp, "prune_normalize", None)
        self.prune_events = []

    def before_train(self):
        exp, args = self.exp, self.args
        exp.ema = False  # pruner.py:326
        batch_size = args.batch_size
        init_ckpt = getattr(exp, "init_ckpt", None)
        self._init_tree = load_checkpoint(init_ckpt) if init_ckpt else None
        self.use_mask = True
        self.mesh = self._setup_mesh()
        self.model = exp.get_model(device=self.device, use_mask=True)
        self.train_loader = exp.get_data_loader(
            batch_size=batch_size, no_aug=True, cache_img=getattr(args, "cache", False),
            seed=exp.seed or 0)
        if self.mesh is not None:
            self.train_loader.rows = (self.mesh.data_index, self.mesh.n_data)
        self.iters_per_epoch = max(len(self.train_loader.dataset) // batch_size, 1)
        self.lr_schedule = exp.get_lr_scheduler(exp.basic_lr_per_img * batch_size,
                                                self.iters_per_epoch)
        self.optimizer = exp.get_optimizer(batch_size, self.model, self.lr_schedule)
        self.state = create_train_state(self.model, self.optimizer, use_ema=False)
        if init_ckpt:
            self._load_init_ckpt(init_ckpt)
        self._replicate_state()
        # the frozen teacher is the init weights, without the masks (pruner.py:344-349)
        tree = export_variables(self.model)
        self.teacher_model = exp.get_model(device=self.device, variables={
            "params": tree["params"], "batch_stats": tree["batch_stats"]})
        self.train_step = make_distill_train_step(
            self.state, self.teacher_model, exp.strides, num_classes=exp.num_classes,
            iou_type=exp.iou_type, simota_bf16=getattr(exp, "simota_bf16", False),
            mesh=self.mesh)
        self.score_step = make_score_step(self.model, exp.strides, exp.num_classes,
                                          exp.iou_type, mesh=self.mesh)
        self.evaluator = exp.get_evaluator(batch_size=batch_size)
        if self.world > 1:
            self.evaluator.shard = (self.rank, self.world)
        self.size_rng = random.Random((exp.seed or 0) + 1234)
        self.prefetcher = DevicePrefetcher(self.train_loader, self.device)
        self.data_iter = self.prefetcher
        logger.info("Pruner init done; %d iters/epoch", self.iters_per_epoch)

    def train_in_iter(self):
        prune_every = max(int(self.iters_per_epoch * self.prune_interval), 1)
        prune_open = self.prune_end_epoch is None or self.epoch < self.prune_end_epoch

        def after(it):
            if prune_open and (it + 1) % prune_every == 0:
                self.prune()

        distill_epoch(self, self.train_step, self.epoch >= self.prune_start_epoch, after)

    def prune(self):
        """Sum the importance over ``score_batches`` batches, prune globally
        and write the new gates into the model; on several ranks rank 0
        selects and broadcasts the gates."""
        t0 = time.perf_counter()
        acc: Optional[Dict[Scope, torch.Tensor]] = None
        for _ in range(self.score_batches):
            imgs, labels = self._next_batch()
            imp = self.score_step(imgs, labels)
            acc = imp if acc is None else {k: acc[k] + imp[k] for k in imp}
        n_new = 0
        if self.rank == 0:
            importance = {k: v.cpu().numpy() for k, v in acc.items()}
            new_vars, n_new = apply_channel_prune(
                export_variables(self.model), importance, self.prune_channels,
                site_floor=self.prune_site_floor, max_frac=self.prune_max_frac,
                normalize=self.prune_normalize)
            load_masks(self.model, new_vars["masks"])
        if self.mesh is not None:
            gates = [t for n, t in self.model.named_buffers()
                     if n.endswith((".mask.scale", ".mask.offset"))]
            flat = broadcast(torch.cat([g.reshape(-1) for g in gates] + [
                torch.tensor([float(n_new)], device=gates[0].device)]), 0, self.mesh.world)
            for g, v in zip(gates, flat.split([g.numel() for g in gates] + [1])):
                g.copy_(v.view_as(g))
            n_new = int(flat[-1])
            new_vars = export_variables(self.model)
        stats = mask_stats(new_vars)
        kept = sum(k for k, _ in stats.values())
        total = sum(t for _, t in stats.values())
        self.prune_events.append({"epoch": self.epoch + 1, "pruned": n_new, "kept": kept,
                                  "total": total, "seconds": time.perf_counter() - t0})
        logger.info("pruned %d new channels; kept %d/%d (%.1f%%)", n_new, kept, total,
                    100.0 * kept / max(total, 1))
