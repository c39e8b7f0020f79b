"""COCO evaluation: the mAP metric and the batched evaluator."""
