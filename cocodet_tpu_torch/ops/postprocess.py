"""Batched postprocess: candidate selection -> exact NMS
(cocodet_tpu/ops/postprocess.py:32-163).

Static bounds as in the JAX package: pre-NMS top-K and ``max_det``. The
max-class filter ranks on the raw head maps and decodes only the top-K
rows (``_select_topk_fused``); the multi-class and RMMOP filters decode
every anchor and select per image (``select_candidates``), batched on the
device with no host sync. ``soft`` takes the Gaussian soft-NMS of
``ops/nms.py`` in place of the greedy keep.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .decode import attach_strides, concat_levels, decode_corner_scores, level_grid
from .nms import NMSResult, batched_nms


class PostprocessConfig(NamedTuple):
    num_classes: int = 80
    conf_threshold: float = 0.001
    nms_threshold: float = 0.65
    pre_nms_topk: int = 2000
    max_det: int = 300
    multi_class: bool = False
    class_agnostic: bool = False
    soft: bool = False
    rmmop: Optional[Tuple[float, float]] = None


def topk_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties taken lowest index first, as
    ``jax.lax.top_k`` does (``torch.topk`` does not)."""
    sorted_vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return sorted_vals[..., :k], idx[..., :k]


def select_candidates(boxes: torch.Tensor, obj: torch.Tensor, cls: torch.Tensor,
                      cfg: PostprocessConfig):
    """Candidate selection of cocodet_tpu/ops/postprocess.py:47-85, batched:
    boxes (B, A, 4), obj (B, A, 1), cls (B, A, C) already obj-multiplied ->
    score-sorted (boxes (B, K, 4), scores (B, K), classes (B, K) int32,
    obj (B, K), valid (B, K)). Ties go lowest index first (``topk_stable``).

    - RMMOP (``cfg.rmmop = (r1, r2)``): the top class is a candidate if its
      score is at least r1 times the second's and obj^2 at least r2 times
      its score. No conf threshold, as in the JAX package (:61).
    - multi-class: every (anchor, class) pair at or above the threshold.
    - otherwise max-class: each anchor's best class.
    """
    b, a, c = cls.shape
    objv = obj[..., 0]
    conf = torch.full((), cfg.conf_threshold, dtype=cls.dtype, device=cls.device)
    none = torch.full((), -1.0, dtype=cls.dtype, device=cls.device)
    if cfg.rmmop is not None:
        r1, r2 = cfg.rmmop
        top2, idx2 = topk_stable(cls, 2)
        score, klass = top2[..., 0], idx2[..., 0]
        ok = (score >= r1 * top2[..., 1]) & (objv.square() >= r2 * score)
        cand = torch.where(ok, score, none)
    elif not cfg.multi_class:
        score, klass = cls.max(dim=-1).values, cls.argmax(dim=-1)
        cand = torch.where(score >= conf, score, none)
    else:  # every (anchor, class) pair
        flat = cls.reshape(b, a * c)
        cand = torch.where(flat >= conf, flat, none)
    top_scores, take = topk_stable(cand, min(cfg.pre_nms_topk, cand.shape[1]))
    if cfg.rmmop is None and cfg.multi_class:
        anchor, klass_k = torch.div(take, c, rounding_mode="floor"), take % c
    else:
        anchor, klass_k = take, torch.gather(klass, 1, take)
    return (torch.gather(boxes, 1, anchor[..., None].expand(-1, -1, 4)), top_scores,
            klass_k.to(torch.int32), torch.gather(objv, 1, anchor), top_scores >= 0.0)


def _select_topk_fused(head_outputs: Sequence[Dict[str, torch.Tensor]],
                       strides: Sequence[int], cfg: PostprocessConfig):
    """Max-class candidate selection on the raw head maps.

    sigmoid is monotone, so the class reduction runs on the raw logits in the
    model's dtype; only (B, A) scores are ranked (the product of sigmoids in
    that dtype, bf16 when serving), and just the top-K rows are gathered and
    decoded in f32, where the reported score is recomputed.
    """
    scores_lv, klass_lv, raw_lv, grids_lv, sv_lv = [], [], [], [], []
    for out, s in zip(head_outputs, strides):
        b, h, w, _ = out["reg"].shape
        cls_logit = out["cls"]
        max_logit = cls_logit.amax(dim=-1)                      # (B,H,W)
        arg = cls_logit.argmax(dim=-1).to(torch.int32)          # first of ties
        obj_logit = out["obj"][..., 0]
        score = torch.sigmoid(obj_logit) * torch.sigmoid(max_logit)
        scores_lv.append(score.reshape(b, h * w))
        klass_lv.append(arg.reshape(b, h * w))
        raw_lv.append(torch.cat([out["reg"], out["obj"], max_logit[..., None]],
                                dim=-1).reshape(b, h * w, 6))
        grids_lv.append(level_grid(h, w, device=cls_logit.device))
        sv_lv.append(torch.full((h * w,), float(s), dtype=torch.float32,
                                device=cls_logit.device))

    scores = torch.cat(scores_lv, dim=1).to(torch.float32)     # (B, A)
    klass = torch.cat(klass_lv, dim=1)
    raw = torch.cat(raw_lv, dim=1)                              # (B, A, 6)
    grids = torch.cat(grids_lv, dim=0)                          # (A, 2)
    sv = torch.cat(sv_lv, dim=0)                                # (A,)

    k = min(cfg.pre_nms_topk, scores.shape[1])
    # a fill on the device: a scalar copied from host memory would synchronise
    conf = torch.full((), cfg.conf_threshold, dtype=torch.float32, device=scores.device)
    cand = torch.where(scores >= conf, scores, torch.full_like(scores, -1.0))
    top_s, take = topk_stable(cand, k)                          # (B, K)

    raw_k = torch.gather(raw, 1, take[..., None].expand(-1, -1, 6)).to(torch.float32)
    klass_k = torch.gather(klass, 1, take)
    grids_k = grids[take]                                       # (B, K, 2)
    sv_k = sv[take][..., None]                                  # (B, K, 1)

    xy = (raw_k[..., 0:2] + grids_k) * sv_k
    half_wh = torch.exp(raw_k[..., 2:4].clamp(-20.0, 20.0)) * (sv_k * 0.5)
    boxes = torch.cat([xy - half_wh, xy + half_wh], dim=-1)
    objv = torch.sigmoid(raw_k[..., 4])
    score_f32 = objv * torch.sigmoid(raw_k[..., 5])
    valid = top_s >= 0.0
    return (boxes, torch.where(valid, score_f32, torch.zeros_like(score_f32)),
            klass_k, objv, valid)


def postprocess(head_outputs: Sequence[Dict[str, torch.Tensor]],
                strides: Sequence[int], cfg: PostprocessConfig) -> NMSResult:
    """Full batched postprocess from raw NHWC head maps to detections."""
    if cfg.rmmop is None and not cfg.multi_class:
        sel = _select_topk_fused(head_outputs, strides, cfg)
    else:
        preds, grids, stride_vec = concat_levels(attach_strides(head_outputs, strides))
        sel = select_candidates(*decode_corner_scores(preds, grids, stride_vec), cfg)
    return batched_nms(
        *sel,
        iou_threshold=cfg.nms_threshold,
        max_det=cfg.max_det,
        class_agnostic=cfg.class_agnostic,
        soft=cfg.soft,
    )
