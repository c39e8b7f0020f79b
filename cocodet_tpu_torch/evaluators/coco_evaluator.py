"""Batched COCO evaluator (cocodet_tpu/evaluators/coco_evaluator.py:32-197):
forward and postprocess on the model's device, numpy bookkeeping on the
host.

A port ``Predictor`` serves each batch of letterboxed val images, its
postprocess set to the evaluator's point (conf, NMS IoU, pre-NMS top-K,
``max_det``), and only the (B, max_det) result crosses to the host. Two
threads assemble the next batches (read, resize, letterbox) while the card
computes the current one. The records are scaled back to the original
image, mapped to the 91-id COCO space and scored by ``COCOMeanAP``.
Gathering detections across hosts is the caller's ``gather_fn``; the
port's torch.distributed gather comes with the trainer.
"""

from __future__ import annotations

import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.coco import COCO_CLASS_ID
from ..ops.postprocess import PostprocessConfig
from .coco_metric import COCOMeanAP

logger = logging.getLogger(__name__)


class COCOEvaluator:
    """Evaluates a ``Predictor`` over a COCO-layout dataset whose items are
    (letterboxed image (H, W, 3) float32, _, (h, w) of the original, image
    id) and which carries its annotations as ``dataset.coco``. The JAX
    evaluator's ``testdev`` and ``per_class_ap`` arguments, which it never
    reads, are left out."""

    def __init__(self, dataset, img_size: Tuple[int, int] = (640, 640),
                 conf_threshold: float = 0.01, nms_threshold: float = 0.65,
                 num_classes: int = 80, batch_size: int = 8, max_det: int = 300,
                 pre_nms_topk: int = 2000):
        self.dataset = dataset
        self.img_size = img_size
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.max_det = max_det
        self.pre_nms_topk = pre_nms_topk

    @property
    def postprocess_config(self) -> PostprocessConfig:
        return PostprocessConfig(num_classes=self.num_classes,
                                 conf_threshold=self.conf_threshold,
                                 nms_threshold=self.nms_threshold,
                                 pre_nms_topk=self.pre_nms_topk, max_det=self.max_det)

    def _batches(self):
        """Threaded batch assembly: batch k+1's read and letterbox overlap
        batch k's compute on the card. A ragged last batch is padded with
        zero images (their detections are never read)."""
        ds = self.dataset
        n = len(ds)

        def build(start):
            items = [ds[i] for i in range(start, min(start + self.batch_size, n))]
            imgs = np.stack([np.asarray(it[0], np.float32) for it in items])
            pad = self.batch_size - len(items)
            if pad:
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], np.float32)])
            return imgs, [it[2] for it in items], [it[3] for it in items]

        starts = list(range(0, n, self.batch_size))
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [pool.submit(build, s) for s in starts[:2]]
            for k in range(len(starts)):
                if k + 2 < len(starts):
                    futures.append(pool.submit(build, starts[k + 2]))
                yield futures[k].result()

    def convert_to_coco_format(self, result, infos, ids) -> List[dict]:
        """Scale detections back to original image space and emit COCO
        records with the 80 -> 91 category map. ``result`` holds numpy
        arrays; the boxes stay float32 through the division by the Python
        float ``scale``, as in the JAX package."""
        records = []
        boxes, scores, classes, valid = result
        for i, ((h, w), img_id) in enumerate(zip(infos, ids)):
            scale = min(self.img_size[0] / float(h), self.img_size[1] / float(w))
            for j in range(boxes.shape[1]):
                if not valid[i, j]:
                    break  # kept detections are front-compacted
                x1, y1, x2, y2 = boxes[i, j] / scale
                x1, x2 = np.clip([x1, x2], 0, w)
                y1, y2 = np.clip([y1, y2], 0, h)
                records.append({
                    "image_id": int(img_id),
                    "category_id": COCO_CLASS_ID[int(classes[i, j])],
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(scores[i, j]),
                    "segmentation": [],
                })
        return records

    def evaluate(self, predictor, output_json: Optional[str] = None,
                 gather_fn: Optional[Callable[[List[dict]], List[dict]]] = None):
        """Returns (ap50_95, ap50, summary). ``predictor`` is a port
        ``Predictor``; its model serves here at this evaluator's
        postprocess point. ``stats`` (the 12 numbers) and ``timing``
        (forward+NMS and host seconds, batches) are kept on the evaluator."""
        from ..entry import Predictor

        serve = Predictor(predictor.model, self.postprocess_config)
        data_list: List[dict] = []
        n_batches = 0
        t_fwd = 0.0
        t_host = 0.0
        t0 = time.perf_counter()
        for imgs, infos, ids in self._batches():
            t1 = time.perf_counter()
            res = serve(imgs)
            # the copy to host memory waits for the card: forward+NMS ends here
            result = tuple(t.cpu().numpy() for t in (res.boxes, res.scores, res.classes,
                                                     res.valid))
            t2 = time.perf_counter()
            data_list.extend(self.convert_to_coco_format(result, infos, ids))
            t3 = time.perf_counter()
            t_fwd += t2 - t1
            t_host += t3 - t2
            n_batches += 1

        if gather_fn is not None:  # multi-host: concat per-process shards
            data_list = gather_fn(data_list)

        if output_json:
            with open(output_json, "w") as f:
                json.dump(data_list, f)

        n_imgs = max(len(self.dataset), 1)
        total = time.perf_counter() - t0
        self.timing = {"forward+nms s": t_fwd, "host s": t_host, "total s": total,
                       "batches": n_batches, "images": len(self.dataset)}
        summary = (
            f"eval: {n_imgs} imgs, {n_batches} batches | "
            f"forward+nms {1000 * t_fwd / n_imgs:.2f} ms/img, "
            f"host {1000 * t_host / n_imgs:.2f} ms/img, "
            f"total {total:.1f}s")
        logger.info(summary)

        self.records = data_list
        self.stats = self.evaluate_prediction(data_list)
        summary += f" | AP={self.stats['AP']:.4f} AP50={self.stats['AP50']:.4f}"
        return self.stats["AP"], self.stats["AP50"], summary

    def evaluate_prediction(self, data_list: Sequence[dict],
                            use_native: bool = True) -> Dict[str, float]:
        metric = COCOMeanAP(use_native=use_native)
        coco = self.dataset.coco
        anns = [a for img_id in coco.ids for a in coco.anns_per_image.get(img_id, [])]
        metric.add_gt_annotations(anns)
        metric.add_detections(list(data_list))
        return metric.summarize()
