"""Detection losses over head outputs and SimOTA targets
(cocodet_tpu/ops/losses.py:26-103).

The masks stay dense, (B, A) weighted sums, as in JAX: no boolean gathers,
no host sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_
from .boxes import iou_cxcywh
from .decode import attach_strides, concat_levels, decode_center_format
from .simota import SimOTATargets, simota_assign


class DetectionLosses(NamedTuple):
    total: torch.Tensor
    iou: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor
    l1: torch.Tensor
    num_fg_per_gt: torch.Tensor  # fg/gt ratio diagnostic (ref yolo_head.py:380)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "iou") -> torch.Tensor:
    """Elementwise IoU-family loss over aligned cxcywh boxes: ``1 - iou^2``
    or ``1 - clip(giou, -1, 1)`` (ref losses.py:15-40)."""
    iou, union, enclose = iou_cxcywh(pred, target)
    if loss_type == "iou":
        return 1.0 - iou * iou
    if loss_type == "giou":
        giou = iou - (enclose - union) / enclose.clamp_min(1e-12)
        return 1.0 - giou.clamp(-1.0, 1.0)
    raise ValueError(loss_type)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: ``-labels * log_sigmoid(x) -
    (1 - labels) * log_sigmoid(-x)``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def yolox_losses(
    head_outputs: Sequence[dict],
    labels: torch.Tensor,
    strides: Sequence[int],
    num_classes: int = 80,
    use_l1: bool = False,
    iou_type: str = "iou",
    reg_weight: float = 5.0,
    simota_dtype: torch.dtype = torch.float32,
    group: Any = None,
) -> Tuple[DetectionLosses, SimOTATargets]:
    """The YOLOX training loss from raw NHWC head maps; ``labels`` (B, G, 5)
    [class, cx, cy, w, h] zero-padded. Each term is summed and divided by
    the number of positives (at least 1).

    With a process ``group`` (the data ranks of a mesh, each holding some of
    the images) the counts of positives and of ground truths are summed over
    it first, so each rank's terms are its images' sums over the global
    count, as JAX divides on a sharded batch; their sum over the group is
    the global batch's loss."""
    preds, grids, stride_vec = concat_levels(attach_strides(head_outputs, strides))
    preds = preds.float()
    decoded = decode_center_format(preds, grids, stride_vec)     # (B, A, 5+C)

    bbox_preds = decoded[..., :4]
    obj_logits = preds[..., 4:5]
    cls_logits = preds[..., 5:]
    centers = (grids + 0.5) * stride_vec[:, None]

    tgt = simota_assign(labels, bbox_preds, cls_logits, obj_logits, centers,
                        stride_vec, num_classes, compute_dtype=simota_dtype)

    if group is not None:
        counts = all_reduce_(torch.stack([tgt.num_fg, tgt.num_gts]), group)
        tgt = tgt._replace(num_fg=counts[0], num_gts=counts[1])
    num_fg = tgt.num_fg.clamp_min(1.0)
    fg = tgt.fg_mask.float()

    loss_iou = (iou_loss(bbox_preds, tgt.reg_target, iou_type) * fg).sum() / num_fg
    loss_obj = sigmoid_binary_cross_entropy(obj_logits[..., 0], fg).sum() / num_fg
    lc = sigmoid_binary_cross_entropy(cls_logits, tgt.cls_target)
    loss_cls = (lc * fg[..., None]).sum() / num_fg
    if use_l1:
        ll = (preds[..., :4] - tgt.l1_target).abs() * fg[..., None]
        loss_l1 = ll.sum() / num_fg
    else:
        loss_l1 = torch.zeros((), device=preds.device)

    total = reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    losses = DetectionLosses(
        total=total, iou=reg_weight * loss_iou, obj=loss_obj, cls=loss_cls, l1=loss_l1,
        num_fg_per_gt=tgt.num_fg / tgt.num_gts.clamp_min(1.0))
    return losses, tgt
