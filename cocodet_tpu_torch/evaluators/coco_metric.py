"""COCO detection mAP, float64 numpy (cocodet_tpu/evaluators/coco_metric.py,
ported as it stands: the same stats, equal, not close).

The full COCOeval bbox protocol: greedy per-image matching at 10 IoU
thresholds, area ranges, maxDets, 101-point interpolated AP. The per-image
matching runs in host C++ (``csrc/host/cocoeval.cpp``, the JAX package's
native matcher copied, bound in ``fast_coco_eval.py``); ``match_image``
below is its plain version. ``COCOMeanAP(use_native=False)`` selects it.
Where the JAX package falls back to it quietly when the library fails to
build or load, the port raises.

Protocol notes (matching pycocotools semantics):
  * matching runs once per (img, cat, area) at the LARGEST maxDet; smaller
    maxDets are per-image truncations applied during accumulate;
  * detections sorted by score desc (stable); GTs sorted ignore-last;
  * crowd/out-of-area GTs are ignore; a det may match a crowd GT repeatedly;
    non-ignore GTs are preferred;
  * matching threshold ratchets: candidate must beat min(t, best so far);
  * unmatched dets with area outside the range are ignored (not FPs);
  * AP: precision envelope sampled at 101 recall points, averaged over
    (iou, class) cells that contain at least one GT.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import fast_coco_eval

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """IoU of det boxes vs gt boxes, xywh. For crowd GTs the denominator is
    the det area (IoF), per COCO protocol."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx2 = dets[:, 0] + dets[:, 2]
    dy2 = dets[:, 1] + dets[:, 3]
    gx2 = gts[:, 0] + gts[:, 2]
    gy2 = gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dets[:, 0][:, None], gts[:, 0][None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dets[:, 1][:, None], gts[:, 1][None]), 0, None)
    inter = iw * ih
    area_d = dets[:, 2] * dets[:, 3]
    area_g = gts[:, 2] * gts[:, 3]
    union = np.where(iscrowd[None, :].astype(bool),
                     area_d[:, None],
                     area_d[:, None] + area_g[None] - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_image(ious: np.ndarray, gt_ignore: np.ndarray, gt_crowd: np.ndarray,
                iou_thrs: np.ndarray):
    """Greedy per-image matching. ious (D, G) with dets score-sorted and GTs
    ignore-last sorted. Returns (dt_match (T,D) gt-index or -1,
    dt_ignore (T,D))."""
    t_n = len(iou_thrs)
    nd, ng = ious.shape
    dt_match = -np.ones((t_n, nd), np.int64)
    gt_taken = np.zeros((t_n, ng), bool)
    dt_ignore = np.zeros((t_n, nd), bool)
    for ti in range(t_n):
        t = iou_thrs[ti]
        for di in range(nd):
            best_iou = min(t, 1 - 1e-10)
            best_g = -1
            for gi in range(ng):
                if gt_taken[ti, gi] and not gt_crowd[gi]:
                    continue
                if best_g >= 0 and not gt_ignore[best_g] and gt_ignore[gi]:
                    break  # gts sorted ignore-last; keep the real match
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                dt_match[ti, di] = best_g
                gt_taken[ti, best_g] = True
                dt_ignore[ti, di] = gt_ignore[best_g]
    return dt_match, dt_ignore


class COCOMeanAP:
    """Accumulating COCO bbox evaluator.

    feed ground truth once (add_gt_annotations), detections per image
    (add_detections), then summarize().
    """

    def __init__(self, iou_thrs: np.ndarray = IOU_THRS,
                 max_dets: Sequence[int] = MAX_DETS,
                 use_native: bool = True):
        self.iou_thrs = np.asarray(iou_thrs, np.float64)
        self.max_dets = tuple(sorted(max_dets))
        self.gt: Dict[Tuple[int, int], dict] = {}
        self.dt: Dict[Tuple[int, int], List] = {}
        self.cats: set = set()
        self.imgs: set = set()
        if use_native:
            fast_coco_eval.load()  # builds and probes now: raises here, not mid-summarize
        self._match = fast_coco_eval.match_image if use_native else match_image

    # ---------------- input ----------------
    def add_gt_annotations(self, annotations: Sequence[dict]):
        """COCO-format annotation dicts: image_id, category_id, bbox xywh,
        area, iscrowd."""
        buckets: Dict[Tuple[int, int], List] = {}
        for a in annotations:
            key = (a["image_id"], a["category_id"])
            buckets.setdefault(key, []).append(a)
            self.cats.add(a["category_id"])
            self.imgs.add(a["image_id"])
        for key, anns in buckets.items():
            self.gt[key] = {
                "boxes": np.array([a["bbox"] for a in anns], np.float64),
                "area": np.array(
                    [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns],
                    np.float64),
                "iscrowd": np.array(
                    [a.get("iscrowd", 0) for a in anns], np.int64),
            }

    def add_detections(self, detections: Sequence[dict]):
        """COCO-format result dicts: image_id, category_id, bbox xywh, score."""
        for d in detections:
            key = (d["image_id"], d["category_id"])
            self.dt.setdefault(key, []).append((float(d["score"]), d["bbox"]))
            self.imgs.add(d["image_id"])
            self.cats.add(d["category_id"])

    # ---------------- evaluation ----------------
    def _evaluate_unit(self, img: int, cat: int,
                       area_rng: Tuple[float, float], max_det: int,
                       iou_cache: dict):
        g = self.gt.get((img, cat))
        d = self.dt.get((img, cat), [])
        if g is None and not d:
            return None
        if g is None:
            g = {"boxes": np.zeros((0, 4)), "area": np.zeros(0),
                 "iscrowd": np.zeros(0, np.int64)}

        gt_ignore = (g["iscrowd"] > 0) | (g["area"] < area_rng[0]) | (
            g["area"] > area_rng[1])
        g_order = np.argsort(gt_ignore, kind="stable")

        key = (img, cat)
        if key not in iou_cache:
            scores = np.array([s for s, _ in d], np.float64)
            d_order = np.argsort(-scores, kind="mergesort")
            d_boxes = (np.array([b for _, b in d], np.float64)[d_order]
                       if d else np.zeros((0, 4)))
            iou_cache[key] = (d_boxes, scores[d_order] if d else np.zeros(0),
                              box_iou_xywh(d_boxes, g["boxes"],
                                           g["iscrowd"] > 0))
        d_boxes, d_scores, ious_full = iou_cache[key]
        d_boxes, d_scores = d_boxes[:max_det], d_scores[:max_det]
        ious = ious_full[:max_det][:, g_order]

        g_ign = gt_ignore[g_order]
        g_crowd = (g["iscrowd"] > 0)[g_order]
        dt_match, dt_ignore = self._match(
            np.ascontiguousarray(ious), g_ign.astype(bool),
            g_crowd.astype(bool), self.iou_thrs)

        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ignore = dt_ignore | ((dt_match < 0) & d_out[None, :])

        return {
            "scores": d_scores,
            "matched": dt_match >= 0,
            "ignored": dt_ignore,
            "num_gt": int(np.sum(~g_ign)),
        }

    def accumulate(self) -> Dict[str, np.ndarray]:
        cats = sorted(self.cats)
        t_n, r_n = len(self.iou_thrs), len(RECALL_THRS)
        a_n, m_n = len(AREA_RANGES), len(self.max_dets)
        precision = -np.ones((t_n, r_n, len(cats), a_n, m_n))
        recall = -np.ones((t_n, len(cats), a_n, m_n))
        max_cap = max(self.max_dets)

        imgs = sorted(self.imgs)
        for ci, cat in enumerate(cats):
            iou_cache: dict = {}
            for ai, area_rng in enumerate(AREA_RANGES.values()):
                # match once at the largest maxDet (pycocotools order)
                evals = [self._evaluate_unit(img, cat, area_rng, max_cap,
                                             iou_cache) for img in imgs]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                npig = sum(e["num_gt"] for e in evals)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in evals])
                    matched = np.concatenate(
                        [e["matched"][:, :max_det] for e in evals], axis=1)
                    ignored = np.concatenate(
                        [e["ignored"][:, :max_det] for e in evals], axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = np.cumsum(matched & ~ignored, axis=1).astype(float)
                    fps = np.cumsum(~matched & ~ignored, axis=1).astype(float)
                    for ti in range(t_n):
                        tp, fp = tps[ti], fps[ti]
                        nd = len(tp)
                        if nd == 0:
                            recall[ti, ci, ai, mi] = 0.0
                            precision[ti, :, ci, ai, mi] = 0.0
                            continue
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ci, ai, mi] = rc[-1]
                        q = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, RECALL_THRS, side="left")
                        prec = np.zeros(r_n)
                        valid = inds < nd
                        prec[valid] = q[inds[valid]]
                        precision[ti, :, ci, ai, mi] = prec
        return {"precision": precision, "recall": recall}

    def summarize(self, verbose: bool = False) -> Dict[str, float]:
        acc = self.accumulate()
        p, r = acc["precision"], acc["recall"]

        def ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = self.max_dets.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.argmin(np.abs(self.iou_thrs - iou)))
                s = s[ti:ti + 1]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = self.max_dets.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        stats = {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "APs": ap(area="small"),
            "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
            "AR100": ar(max_det=100),
            "ARs": ar(area="small"),
            "ARm": ar(area="medium"),
            "ARl": ar(area="large"),
        }
        if verbose:
            for k, v in stats.items():
                print(f"{k:6s} = {v:.4f}")
        return stats

    def per_class_ap(self, iou: Optional[float] = 0.5, area: str = "all",
                     max_det: int = 100) -> Dict[int, float]:
        """Per-category AP table (ref COCOEvaluator per_class_AP option)."""
        acc = self.accumulate()
        p = acc["precision"]
        cats = sorted(self.cats)
        ai = list(AREA_RANGES).index(area)
        mi = self.max_dets.index(max_det)
        out = {}
        for ci, cat in enumerate(cats):
            s = p[:, :, ci, ai, mi]
            if iou is not None:
                ti = int(np.argmin(np.abs(self.iou_thrs - iou)))
                s = s[ti:ti + 1]
            s = s[s > -1]
            out[cat] = float(np.mean(s)) if s.size else float("nan")
        return out


def score_detections_json(gt, det_json_path: str) -> Dict[str, float]:
    """Score a COCO-format detections json against ground truth.

    The harness self-eval scoring (cocodet_tpu/evaluators/coco_metric.py:
    300-339): load the detections, remap string image_ids
    (the harness emits file-name ids for non-numeric names) through the GT
    file_name table, drop records without a bbox (challenge header / dummy
    records), and run COCOMeanAP.

    gt: the instances dict, or a path to the annotations json.
    """
    import json as _json

    if isinstance(gt, str):
        with open(gt) as f:
            gt = _json.load(f)
    name_to_id = {im["file_name"]: im["id"] for im in gt["images"]}
    with open(det_json_path) as f:
        dets = _json.load(f)
    for d in dets:
        if isinstance(d.get("image_id"), str):
            d["image_id"] = name_to_id.get(d["image_id"], -1)
    metric = COCOMeanAP()
    metric.add_gt_annotations(gt["annotations"])
    metric.add_detections([d for d in dets if "bbox" in d])
    return metric.summarize()
