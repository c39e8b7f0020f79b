"""SimOTA label assignment, batched and fixed-shape
(cocodet_tpu/ops/simota.py:53-242).

JAX vmaps ``assign_single`` over the images; here every tensor carries the
batch dimension: the cost and IoU matrices are (B, G, A) for G padded
ground truths and A anchors. The same operations in the same order as the
JAX functions, so an f32 assignment is the same set of anchors (ties go to
the lowest index in both). Everything runs under ``torch.no_grad`` and
without a host sync: no ``.item()``, no boolean-mask indexing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .boxes import pairwise_iou

_BIG = 1e5  # not-in-both penalty (ref yolo_head.py:467)
_INF = 1e9  # non-candidate / invalid-gt exclusion


class SimOTATargets(NamedTuple):
    """Per-anchor training targets, batched."""

    fg_mask: torch.Tensor     # (B, A) bool, positive anchors
    cls_target: torch.Tensor  # (B, A, C) iou-weighted one-hot (0 for bg)
    reg_target: torch.Tensor  # (B, A, 4) matched gt cxcywh (0 for bg)
    l1_target: torch.Tensor   # (B, A, 4) encoded gt for L1 (0 for bg)
    num_fg: torch.Tensor      # () total positives in the batch (f32)
    num_gts: torch.Tensor     # () total gts in the batch (f32)
    matched_gt: torch.Tensor  # (B, A) int64, the gt of each anchor (0 for bg)


def _binary_cross_entropy_terms(sp: torch.Tensor, eps: float = 1e-12):
    """log(sp), log(1-sp) with torch-style clamping (log >= -100)."""
    log_p = torch.log(sp.clamp_min(eps)).clamp_min(-100.0)
    log_1p = torch.log((1.0 - sp).clamp_min(eps)).clamp_min(-100.0)
    return log_p, log_1p


def _topk_small(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by k rounds of argmax: (values (..., k),
    indices (..., k)). ``torch.argmax`` returns the first maximal index, so
    ties go to the lowest index, as in JAX (``torch.topk`` orders ties
    otherwise on CUDA)."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idxs.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


@torch.no_grad()
def simota_assign(
    labels: torch.Tensor,       # (B, G, 5) [class, cx, cy, w, h], zero-padded
    pred_boxes: torch.Tensor,   # (B, A, 4) decoded cxcywh (input pixels)
    cls_logits: torch.Tensor,   # (B, A, C)
    obj_logits: torch.Tensor,   # (B, A, 1)
    centers: torch.Tensor,      # (A, 2) anchor centers ((shift + 0.5) * stride)
    strides: torch.Tensor,      # (A,)
    num_classes: int,
    center_radius: float = 2.5,
    compute_dtype: torch.dtype = torch.float32,
) -> SimOTATargets:
    """Batched SimOTA (assign_single, :79-209, over the batch). The inputs
    are detached. ``compute_dtype`` is the type of the (B, G, A) IoU and
    gathered BCE terms (bf16 approximates which anchors are chosen); the
    final cost sum and every target stay f32."""
    labels, pred_boxes = labels.detach().float(), pred_boxes.detach().float()
    cls_logits, obj_logits = cls_logits.detach(), obj_logits.detach()
    b, g, _ = labels.shape
    a = pred_boxes.shape[1]
    cdt = compute_dtype

    gt_valid = labels.sum(-1) > 0                               # (B, G)
    gt_cls = labels[..., 0].long()
    gt_box = labels[..., 1:5]                                   # cxcywh

    # geometric priors (ref get_in_boxes_info)
    cx, cy = centers[:, 0], centers[:, 1]
    gcx, gcy = gt_box[..., 0:1], gt_box[..., 1:2]               # (B, G, 1)
    gl = gcx - 0.5 * gt_box[..., 2:3]
    gr = gcx + 0.5 * gt_box[..., 2:3]
    gt = gcy - 0.5 * gt_box[..., 3:4]
    gb = gcy + 0.5 * gt_box[..., 3:4]
    in_box = (cx > gl) & (cx < gr) & (cy > gt) & (cy < gb)      # (B, G, A)
    r = center_radius * strides
    in_center = (cx > gcx - r) & (cx < gcx + r) & (cy > gcy - r) & (cy < gcy + r)
    in_box &= gt_valid[..., None]
    in_center &= gt_valid[..., None]
    candidate = (in_box | in_center).any(1)                     # (B, A)
    in_both = in_box & in_center

    # pairwise IoU over candidates
    iou = pairwise_iou(gt_box.to(cdt), pred_boxes.to(cdt), xyxy=False)  # (B, G, A)
    iou_cand = torch.where(candidate[:, None, :] & gt_valid[..., None], iou,
                           torch.zeros((), dtype=cdt, device=iou.device))

    # classification cost without the (B, G, A, C) intermediate
    sp = torch.sqrt(torch.sigmoid(cls_logits.float()) * torch.sigmoid(obj_logits.float()))
    log_p, log_1p = _binary_cross_entropy_terms(sp)             # (B, A, C)
    s_all = log_1p.sum(-1)                                      # (B, A)
    idx = gt_cls[:, None, :].expand(b, a, g)
    gathered_p = torch.gather(log_p.to(cdt), 2, idx).transpose(1, 2)    # (B, G, A)
    gathered_1p = torch.gather(log_1p.to(cdt), 2, idx).transpose(1, 2)
    cost_cls = -gathered_p + gathered_1p - s_all.to(cdt)[:, None, :]

    cost_iou = -torch.log(iou.float() + 1e-8)
    cost = (cost_cls.float() + 3.0 * cost_iou
            + _BIG * (~in_both).float()
            + _INF * (~candidate[:, None, :]).float()
            + _INF * (~gt_valid[..., None]).float())

    # dynamic k (ref dynamic_k_matching): int(sum of the top-10 IoUs), at least 1
    k_cap = min(10, a)
    topk_iou, _ = _topk_small(iou_cand, k_cap)
    topk_iou = topk_iou.float()
    total = topk_iou[..., 0]
    for j in range(1, k_cap):  # left to right, as XLA:CPU sums the row
        total = total + topk_iou[..., j]
    dynamic_k = total.to(torch.int32).clamp_min(1)              # (B, G)

    neg_vals, top_idx = _topk_small(-cost, k_cap)               # (B, G, k)
    sel = ((torch.arange(k_cap, device=cost.device) < dynamic_k[..., None])
           & (-neg_vals < _INF * 0.5) & gt_valid[..., None])
    matched = torch.zeros((b, g, a), dtype=torch.bool, device=cost.device)
    matched.scatter_(2, top_idx, sel)

    # conflict resolution: the min-cost gt wins (ref yolo_head.py:576-580)
    n_match = matched.sum(1)                                    # (B, A)
    best_gt = torch.argmin(torch.where(matched, cost, torch.inf), dim=1)  # (B, A)
    keep_row = F.one_hot(best_gt, g).transpose(1, 2).bool()     # (B, G, A)
    matched = torch.where(n_match[:, None, :] > 1, matched & keep_row, matched)

    fg = matched.any(1)                                         # (B, A)
    matched_gt = torch.argmax(matched.to(torch.uint8), dim=1)   # (B, A)
    pred_iou = torch.where(matched, iou, torch.zeros((), dtype=cdt, device=iou.device)
                           ).sum(1).float()

    # targets (ref yolo_head.py:330-346)
    fgf = fg.float()[..., None]
    cls_t = F.one_hot(torch.gather(gt_cls, 1, matched_gt), num_classes).float()
    cls_t = cls_t * pred_iou[..., None] * fgf
    reg_t = torch.gather(gt_box, 1, matched_gt[..., None].expand(b, a, 4)) * fgf

    # L1 target (ref get_l1_target, yolo_head.py:383-389)
    st = strides[:, None]
    shift = centers / st - 0.5
    l1_xy = reg_t[..., :2] / st - shift
    l1_wh = torch.log(reg_t[..., 2:] / st + 1e-8)
    l1_t = torch.cat([l1_xy, l1_wh], dim=-1) * fgf

    return SimOTATargets(
        fg_mask=fg, cls_target=cls_t, reg_target=reg_t, l1_target=l1_t,
        num_fg=fg.float().sum(), num_gts=gt_valid.float().sum(),
        matched_gt=matched_gt)
