"""TrainerSynFlow (cocodet_tpu/core/trainer_synflow.py): SynFlow's
unstructured pruning inside training, on the port's trainer.

At ``prune_epoch`` (before its first step), ``prune_iters`` rounds, round i
keeping the fraction ``prune_ratio ** (i / prune_iters)`` of the masked
kernels' weights:

- the score pass (``make_synflow_score_step``): every parameter's |w| (BN's
  too, not the running statistics), the model in eval mode on an all-ones
  (1, H, W, 3) f32 input, the sum of every level's reg, obj and cls maps in
  f32, its gradient with respect to |w|, and the score ``|w * g|``;
- the selection (``synflow_update_masks``): the global top
  ``max(round(N * keep), 1)`` scores of the masked kernels become 1 in their
  ``conv_mask`` buffers, the rest 0.

The model is the ``weight_mask`` model (``_with_weight_mask``: every conv of
the backbone and the PAFPN's CSP layers multiplies its kernel by its
``conv_mask`` at every use), so a masked weight scores exactly 0 from then
on and the kept set only shrinks. The masks take effect in training from
that epoch and go into the evaluated and saved ``model`` variables.

Everything stays on the device: the scores, the selection (a sort) and the
masks; ``synflow_stats`` holds the run's numbers, read back once at its end.

On several ranks the score pass (one all-ones image) is not sharded: rank 0
runs every round unsharded, outside the mesh, and broadcasts the final
masks, so every rank trains with rank 0's masks bit for bit (equal scores
on every rank cannot be trusted: cuDNN's algorithm choice can move a
score's last bit between processes); the other ranks' ``synflow_stats``
carry no output sums. Training then runs the Trainer's step on the mesh.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from ..parallel.collectives import broadcast
from .trainer import Trainer

logger = logging.getLogger("cocodet_tpu_torch")
MAPS = ("reg", "obj", "cls")


def make_synflow_score_step(model: nn.Module, input_size: Sequence[int]):
    """``score_step() -> ({parameter name: |w * g|}, output sum)``, one
    SynFlow scoring pass (trainer_synflow.py:33-51) over the model's current
    weights and masks; the model's train/eval mode is restored after it."""
    params = dict(model.named_parameters())

    def score_step() -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        device = next(iter(params.values())).device
        abs_params = {n: p.detach().abs().requires_grad_(True) for n, p in params.items()}
        ones = torch.ones((1, *input_size, 3), dtype=torch.float32, device=device)
        was_training = model.training
        model.eval()
        try:
            outputs = torch.func.functional_call(model, abs_params, (ones,))
        finally:
            model.train(was_training)
        total = sum(o[k].float().sum() for o in outputs for k in MAPS)
        grads = torch.autograd.grad(total, list(abs_params.values()))
        scores = {n: (w.detach() * g).abs() for (n, w), g in zip(abs_params.items(), grads)}
        return scores, total.detach()

    return score_step


def mask_sites(model: nn.Module) -> Dict[str, nn.Module]:
    """``{module name: Conv2d}`` of every conv with a ``conv_mask``, in the
    model's order."""
    return {name: m for name, m in model.named_modules()
            if getattr(m, "conv_mask", None) is not None}


def keep_count(n: int, keep_fraction: float) -> int:
    """How many of ``n`` scores a round keeps: ``max(round(n * keep), 1)``,
    Python's round (half to even), as trainer_synflow.py:66."""
    return max(int(round(n * keep_fraction)), 1)


def synflow_keep(scores: Sequence[torch.Tensor], keep_fraction: float) -> List[torch.Tensor]:
    """0/1 f32 masks (the shapes of ``scores``, OIHW) keeping the global top
    ``keep_count(N, keep_fraction)`` of the N scores (trainer_synflow.py:
    54-78).

    The rule among ties, which JAX's ``np.argpartition`` leaves unspecified:
    the scores are ranked by a stable sort, highest first, so among equal
    scores at the cut the lower flat index is kept; the flat order is the
    masks' order, each kernel's elements in flax's HWIO order (JAX's
    concatenation). NaN ranks last (as numpy sorts it): it is kept only when
    fewer than the count are not NaN. On tie-free scores this is JAX's
    selection exactly."""
    flat = torch.cat([s.permute(2, 3, 1, 0).reshape(-1) for s in scores])
    n_keep = keep_count(flat.numel(), keep_fraction)
    order = torch.sort(-flat, stable=True).indices  # NaN sorts last, ties by index
    keep = torch.zeros(flat.numel(), dtype=torch.float32, device=flat.device)
    keep[order[:n_keep]] = 1.0
    out, offset = [], 0
    for s in scores:
        o, i, h, w = s.shape
        out.append(keep[offset:offset + s.numel()].view(h, w, i, o).permute(3, 2, 0, 1))
        offset += s.numel()
    return out


@torch.no_grad()
def synflow_update_masks(model: nn.Module, scores: Mapping[str, torch.Tensor],
                         keep_fraction: float) -> int:
    """Write ``synflow_keep`` of the masked kernels' scores into their
    ``conv_mask`` buffers; returns the count kept."""
    sites = mask_sites(model)
    keep = synflow_keep([scores[f"{name}.weight"] for name in sites], keep_fraction)
    for conv, k in zip(sites.values(), keep):
        conv.conv_mask.copy_(k)
    return keep_count(sum(k.numel() for k in keep), keep_fraction)


class TrainerSynFlow(Trainer):
    """The trainer that runs the SynFlow schedule at ``prune_epoch``
    (trainer_synflow.py:81-136), on one rank or several (the module
    docstring)."""

    def __init__(self, exp, args, device: Any = "cuda"):
        super().__init__(exp, args, device)
        self.prune_iters = getattr(exp, "prune_iters", 100)
        self.prune_ratio = getattr(exp, "prune_ratio", 0.5)
        self.prune_epoch = getattr(exp, "prune_epoch", 10)
        self._synflow_done = False
        self.synflow_stats: Dict[str, Any] = {}

    def before_train(self):
        self.exp.get_model = _with_weight_mask(self.exp.get_model)
        super().before_train()
        self.score_step = make_synflow_score_step(self.model, self.exp.input_size)

    def before_epoch(self):
        super().before_epoch()
        if self.epoch >= self.prune_epoch and not self._synflow_done:
            self.apply_synflow()

    def apply_synflow(self):
        logger.info("SynFlow: %d iterations to %.0f%% sparsity", self.prune_iters,
                    100 * (1 - self.prune_ratio))
        t0 = time.perf_counter()
        sums, bad = [], []
        masks = [m.conv_mask for m in mask_sites(self.model).values()]
        n_keep = keep_count(sum(m.numel() for m in masks), self.prune_ratio)
        rounds = range(1, self.prune_iters + 1) if self.rank == 0 else ()  # rank 0 scores
        for i in rounds:
            keep = self.prune_ratio ** (i / self.prune_iters)
            scores, out_sum = self.score_step()
            sums.append(out_sum)
            bad.append((~torch.isfinite(torch.cat([v.reshape(-1) for v in scores.values()])))
                       .sum())
            n_keep = synflow_update_masks(self.model, scores, keep)
        if self.mesh is not None:
            flat = broadcast(torch.cat([m.reshape(-1) for m in masks]), 0, self.mesh.world)
            for m, v in zip(masks, flat.split([m.numel() for m in masks])):
                m.copy_(v.view_as(m))
        kept = int(sum(m.sum() for m in masks))  # the sync point
        total = sum(m.numel() for m in masks)
        self._synflow_done = True
        self.synflow_stats = {
            "iterations": self.prune_iters, "seconds": time.perf_counter() - t0,
            "kept": kept, "total": total, "n_keep": n_keep,
            "output_sums": [float(v) for v in sums],
            "nonfinite_scores": [int(v) for v in bad]}
        logger.info("SynFlow done: kept %d/%d weights (%.1f%%)", kept, total,
                    100.0 * kept / max(total, 1))


def _with_weight_mask(get_model):
    def wrapped(*a, **kw):
        kw.setdefault("weight_mask", True)
        return get_model(*a, **kw)
    return wrapped
