"""VOC mAP evaluator (cocodet_tpu/evaluators/voc_evaluator.py): the 07
11-point and the all-point metrics, a class's AP by greedy IoU > 0.5
matching against ground truths whose difficult ones count neither way.

``VOCEvaluator`` keeps the port's evaluator contract (``evaluate(predictor)
-> (ap, ap50, summary)``, ``records``, ``shard``, ``shard_range()``), so the
trainer and ``tools.eval`` take it as they take ``COCOEvaluator``, whose
threaded batch assembly it shares. Every rank of a data-parallel run scores
the whole set, as in JAX.

The frame. The dataset's items are resized by ``r0 = min(size / h, size /
w)`` and letterboxed again by ``r``; the records are divided by ``min(size
/ h, size / w)`` of the original image, as upstream YOLOX and the port's
COCO evaluator do, and scored against the XML boxes, which are in original
pixels. JAX's evaluator divides by ``r`` alone (:122-152), so its
detections stay in the resized frame, ``r0`` times too small, wherever the
image's longer side is not the test size (ROADMAP Queue 3).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.transforms import letterbox
from ..data.voc import VOC_CLASSES, parse_voc_xml
from .coco_evaluator import COCOEvaluator

logger = logging.getLogger(__name__)


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    """AP from a PR curve (voc_eval.py semantics)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_class(detections: List[Tuple[int, float, np.ndarray]],
               gts: Dict[int, Tuple[np.ndarray, np.ndarray]],
               iou_thr: float = 0.5, use_07_metric: bool = False) -> float:
    """AP for one class. ``detections``: (image index, score, box xyxy);
    ``gts``: image index -> (boxes (G, 4), difficult (G,) bool). NaN where
    the class has neither detections nor positives."""
    npos = sum(int((~d).sum()) for _, (_, d) in gts.items())
    if not detections:
        return 0.0 if npos > 0 else float("nan")
    detections = sorted(detections, key=lambda t: -t[1])
    taken = {i: np.zeros(len(b), bool) for i, (b, _) in gts.items()}
    tp = np.zeros(len(detections))
    fp = np.zeros(len(detections))
    for di, (img, score, box) in enumerate(detections):
        boxes, difficult = gts.get(img, (np.zeros((0, 4)), np.zeros(0, bool)))
        if len(boxes) == 0:
            fp[di] = 1
            continue
        ixmin = np.maximum(boxes[:, 0], box[0])
        iymin = np.maximum(boxes[:, 1], box[1])
        ixmax = np.minimum(boxes[:, 2], box[2])
        iymax = np.minimum(boxes[:, 3], box[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inter = iw * ih
        union = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
                 + (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0) - inter)
        overlaps = inter / np.maximum(union, 1e-12)
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > iou_thr:
            if difficult[jmax]:
                continue  # neither tp nor fp
            if not taken[img][jmax]:
                tp[di] = 1
                taken[img][jmax] = True
            else:
                fp[di] = 1
        else:
            fp[di] = 1
    tp, fp = np.cumsum(tp), np.cumsum(fp)
    recall = tp / max(npos, 1)
    precision = tp / np.maximum(tp + fp, np.spacing(1))
    return voc_ap(recall, precision, use_07_metric)


class VOCEvaluator(COCOEvaluator):
    """Evaluates a port ``Predictor`` over a ``VOCDetection`` at ``img_size``
    (conf, NMS IoU; pre-NMS top-K 2000 and 300 detections, JAX's
    PostprocessConfig defaults). ``records`` are ``{"image": dataset index,
    "category": class, "score", "bbox": [x1, y1, x2, y2]}`` in the original
    image's pixels, f32 values as Python floats; ``stats`` holds the mAP and
    each class's AP."""

    def __init__(self, dataset, img_size=(640, 640), conf_threshold: float = 0.01,
                 nms_threshold: float = 0.65, num_classes: int = 20, batch_size: int = 8,
                 use_07_metric: bool = False):
        super().__init__(dataset, img_size=img_size, conf_threshold=conf_threshold,
                         nms_threshold=nms_threshold, num_classes=num_classes,
                         batch_size=batch_size)
        self.use_07_metric = use_07_metric

    def _item(self, index: int):
        img, _, info, idx = self.dataset.pull_item(index)
        return letterbox(img, self.img_size)[0], None, info, idx

    def shard_range(self) -> Tuple[int, int]:
        """The whole set on every rank (voc_evaluator.py:115-117)."""
        return 0, len(self.dataset)

    def convert_to_voc_format(self, result, infos, ids) -> List[dict]:
        records = []
        boxes, scores, classes, valid = result
        for i, ((h, w), index) in enumerate(zip(infos, ids)):
            scale = min(self.img_size[0] / float(h), self.img_size[1] / float(w))
            for j in range(boxes.shape[1]):
                if not valid[i, j]:
                    break  # kept detections are front-compacted
                records.append({"image": int(index), "category": int(classes[i, j]),
                                "score": float(scores[i, j]),
                                "bbox": [float(v) for v in boxes[i, j] / scale]})
        return records

    def ground_truths(self) -> List[Dict[int, Tuple[np.ndarray, np.ndarray]]]:
        """Per class, image index -> (boxes, difficult) from the XML, the
        difficult objects kept (voc_evaluator.py:127-137)."""
        gts: List[Dict[int, Tuple[np.ndarray, np.ndarray]]] = [{} for _ in range(self.num_classes)]
        for i in range(len(self.dataset)):
            boxes, difficult = parse_voc_xml(self.dataset.annotation_path(i), keep_difficult=True)
            difficult = np.asarray(difficult, bool)
            for c in range(self.num_classes):
                sel = boxes[:, 4] == c
                if sel.any():
                    gts[c][i] = (boxes[sel, :4], difficult[sel])
        return gts

    def evaluate_prediction(self, records: Sequence[dict],
                            use_07_metric: Optional[bool] = None) -> Dict[str, object]:
        """{"mAP", "per_class"} of ``records`` under the 07 metric or the
        all-point one (the evaluator's own by default); the mean is over
        the classes whose AP is not NaN."""
        use_07 = self.use_07_metric if use_07_metric is None else use_07_metric
        per_class: List[List[Tuple[int, float, np.ndarray]]] = [[] for _ in range(self.num_classes)]
        for r in records:
            per_class[r["category"]].append((r["image"], r["score"],
                                             np.asarray(r["bbox"], np.float32)))
        gts = self.ground_truths()
        aps = [eval_class(per_class[c], gts[c], use_07_metric=use_07)
               for c in range(self.num_classes)]
        kept = [ap for ap in aps if not np.isnan(ap)]
        return {"mAP": float(np.mean(kept)) if kept else 0.0, "per_class": aps,
                "classes": len(kept)}

    def evaluate(self, predictor):
        """Returns (mAP50, mAP50, summary) under the evaluator's metric."""
        from ..entry import Predictor

        serve = Predictor(predictor.model, self.postprocess_config)
        records: List[dict] = []
        t0 = time.perf_counter()
        for imgs, infos, ids in self._batches():
            res = serve(imgs)
            result = tuple(t.cpu().numpy() for t in (res.boxes, res.scores, res.classes,
                                                     res.valid))
            records.extend(self.convert_to_voc_format(result, infos, ids))
        self.records = records
        stats = self.evaluate_prediction(records)
        for c, ap in enumerate(stats["per_class"]):
            name = VOC_CLASSES[c] if c < len(VOC_CLASSES) else str(c)
            logger.info("%-14s AP50 = %.4f", name, ap)
        self.stats = stats
        summary = (f"VOC mAP50 = {stats['mAP']:.4f} ({stats['classes']} classes), "
                   f"{len(self.dataset)} imgs in {time.perf_counter() - t0:.1f}s")
        logger.info(summary)
        return stats["mAP"], stats["mAP"], summary
