"""Mosaic + MixUp on the host (cocodet_tpu/data/mosaic.py), the input path
of the JAX package's default exp (``device_mosaic False``).

An item is four images composed around a random centre on a canvas twice
the input size, warped back to the input size by ``random_affine``,
optionally blended 1:1 with a resized, flipped and cropped partner
(``mixup``), then ``preproc`` (``TrainTransform``). Every draw comes from
the caller's ``random.Random`` in the JAX package's order, and every pixel
operation is the port's exact counterpart of cv2's (``transforms.resize``,
``transforms.warp_affine``, ``augment_hsv``), so an item equals JAX's for
the same seed: the images bit for bit, the labels exactly.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np

from .transforms import random_affine, resize


def adjust_box_anns(bbox, scale_ratio, padw, padh, w_max, h_max):
    """Scale and shift a tile's boxes and clip them to the canvas."""
    bbox = bbox.copy()
    bbox[:, 0::2] = np.clip(bbox[:, 0::2] * scale_ratio + padw, 0, w_max)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2] * scale_ratio + padh, 0, h_max)
    return bbox


def _mosaic_tile_coords(pos: int, xc: int, yc: int, w: int, h: int, iw: int, ih: int):
    """Placement of tile ``pos`` (0 tl, 1 tr, 2 bl, 3 br) on a 2x canvas."""
    if pos == 0:
        x1, y1, x2, y2 = max(xc - w, 0), max(yc - h, 0), xc, yc
        sx1, sy1 = w - (x2 - x1), h - (y2 - y1)
        sx2, sy2 = w, h
    elif pos == 1:
        x1, y1, x2, y2 = xc, max(yc - h, 0), min(xc + w, iw * 2), yc
        sx1, sy1 = 0, h - (y2 - y1)
        sx2, sy2 = min(w, x2 - x1), h
    elif pos == 2:
        x1, y1, x2, y2 = max(xc - w, 0), yc, xc, min(ih * 2, yc + h)
        sx1, sy1 = w - (x2 - x1), 0
        sx2, sy2 = w, min(y2 - y1, h)
    else:
        x1, y1, x2, y2 = xc, yc, min(xc + w, iw * 2), min(ih * 2, yc + h)
        sx1, sy1 = 0, 0
        sx2, sy2 = min(w, x2 - x1), min(y2 - y1, h)
    return (x1, y1, x2, y2), (sx1, sy1, sx2, sy2)


class MosaicDetection:
    """Wraps a dataset with ``pull_item``; an item is mosaic(4 images)
    [+ mixup] + preproc. ``close_mosaic`` turns mosaic and mixup off (the
    no-aug epochs)."""

    def __init__(self, dataset, mosaic: bool = True, img_size: Tuple[int, int] = (640, 640),
                 preproc=None, degrees: float = 10.0, translate: float = 0.1,
                 mosaic_scale: Sequence[float] = (0.5, 1.5),
                 mixup_scale: Sequence[float] = (0.5, 1.5), shear: float = 2.0,
                 enable_mixup: bool = True, mosaic_prob: float = 1.0, mixup_prob: float = 1.0,
                 rng: Optional[random.Random] = None):
        self._dataset = dataset
        self.rng = rng or random
        self.input_dim = img_size
        self.preproc = preproc
        self.degrees = degrees
        self.translate = translate
        self.scale = mosaic_scale
        self.mixup_scale = mixup_scale
        self.shear = shear
        self.enable_mosaic = mosaic
        self.enable_mixup = enable_mixup
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob

    def __len__(self):
        return len(self._dataset)

    def close_mosaic(self):
        self.enable_mosaic = False
        self.enable_mixup = False

    def __getitem__(self, index):
        return self.fetch(index)

    def fetch(self, index, rng: Optional[random.Random] = None):
        """(image, labels, info, id) of an item, drawn from ``rng`` (the
        loader passes one seeded per item). ``index`` may be the batch
        sampler's (mosaic flag, index); the flag is stored, as JAX stores
        it, but this item reads its own copy: the loader's threads fetch
        items of batches sampled before and after ``close_mosaic`` at once,
        and the JAX package's item reads the shared attribute, which another
        thread may have set in between."""
        rng = rng or self.rng
        if isinstance(index, tuple):
            mosaic, index = index
            self.enable_mosaic = mosaic
        else:
            mosaic = self.enable_mosaic

        if mosaic and rng.random() < self.mosaic_prob:
            img, labels, img_info, img_id = self._mosaic_item(index, rng)
        else:
            self._dataset.img_size = self.input_dim
            img, labels, img_info, img_id = self._dataset.pull_item(index)

        if (mosaic and self.enable_mixup and len(labels)
                and rng.random() < self.mixup_prob):
            img, labels = self.mixup(img, labels, self.input_dim, rng)

        if self.preproc is not None:
            img, labels = self.preproc(img, labels, self.input_dim, rng=self._preproc_rng(rng))
        return img, labels, img_info, img_id

    def _preproc_rng(self, rng=None):
        rng = rng or self.rng
        return rng if isinstance(rng, random.Random) else None

    def _mosaic_item(self, index, rng: Optional[random.Random] = None):
        rng = rng or self.rng
        ih, iw = self.input_dim
        yc = int(rng.uniform(0.5 * ih, 1.5 * ih))
        xc = int(rng.uniform(0.5 * iw, 1.5 * iw))
        indices = [index] + [rng.randint(0, len(self._dataset) - 1) for _ in range(3)]

        canvas = np.full((ih * 2, iw * 2, 3), 114, np.uint8)
        all_labels = []
        img_info, img_id = (ih, iw), None
        for pos, idx in enumerate(indices):
            img, labels, info, iid = self._dataset.pull_item(idx)
            if pos == 0:
                img_info, img_id = info, iid
            h0, w0 = img.shape[:2]
            s = min(1.0 * ih / h0, 1.0 * iw / w0)
            img = resize(img, (int(w0 * s), int(h0 * s)))
            h, w = img.shape[:2]
            (x1, y1, x2, y2), (sx1, sy1, sx2, sy2) = _mosaic_tile_coords(pos, xc, yc, w, h, iw, ih)
            canvas[y1:y2, x1:x2] = img[sy1:sy2, sx1:sx2]
            padw, padh = x1 - sx1, y1 - sy1
            if labels.size > 0:
                # only the box columns: labels are [x1 y1 x2 y2 cls]
                adj = labels.copy()
                adj[:, :4] = adjust_box_anns(labels[:, :4].copy(), s, padw, padh, 2 * iw, 2 * ih)
                all_labels.append(adj)

        labels = (np.concatenate(all_labels, 0) if all_labels
                  else np.zeros((0, 5), np.float32))
        canvas, labels = random_affine(
            canvas, labels, target_size=(iw, ih), degrees=self.degrees,
            translate=self.translate, scales=self.scale, shear=self.shear,
            rng=self._preproc_rng(rng))
        return canvas, labels, img_info, img_id

    def mixup(self, origin_img, origin_labels, input_dim, rng: Optional[random.Random] = None):
        """A flip-augmented second image blended 1:1 (mosaic.py:165-216); the
        partner is redrawn until it has labels, 50 times at most."""
        rng = rng or self.rng
        jit = rng.uniform(*self.mixup_scale)
        flip = rng.random() > 0.5
        cp_labels = np.zeros((0, 5), np.float32)
        img = None
        for _ in range(50):
            idx = rng.randint(0, len(self._dataset) - 1)
            img, cp_labels, _, _ = self._dataset.pull_item(idx)
            if len(cp_labels) > 0:
                break
        if img is None or len(cp_labels) == 0:
            return origin_img, origin_labels

        ih, iw = input_dim
        cp_img = np.full((ih, iw, 3), 114, np.uint8)
        s = min(ih / img.shape[0], iw / img.shape[1])
        resized = resize(img, (int(img.shape[1] * s), int(img.shape[0] * s)))
        cp_img[: resized.shape[0], : resized.shape[1]] = resized

        cp_img = resize(cp_img, (int(iw * jit), int(ih * jit)))
        scale = s * jit
        if flip:
            cp_img = cp_img[:, ::-1]

        oh, ow = origin_img.shape[:2]
        th, tw = cp_img.shape[:2]
        pad = np.full((max(oh, th), max(ow, tw), 3), 114, np.uint8)
        pad[:th, :tw] = cp_img
        x_off = rng.randint(0, max(pad.shape[1] - ow, 0)) if pad.shape[1] > ow else 0
        y_off = rng.randint(0, max(pad.shape[0] - oh, 0)) if pad.shape[0] > oh else 0
        crop = pad[y_off:y_off + oh, x_off:x_off + ow]

        boxes = cp_labels[:, :4].copy() * scale if len(cp_labels) else np.zeros((0, 4))
        if flip and len(boxes):
            boxes[:, 0::2] = tw - boxes[:, 2::-2]
        if len(boxes):
            boxes[:, 0::2] = np.clip(boxes[:, 0::2] - x_off, 0, ow)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2] - y_off, 0, oh)
            keep = (boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1)
            if keep.any():
                labels = np.hstack([boxes[keep], cp_labels[keep, 4:5]])
                origin_labels = np.vstack([origin_labels, labels])
        out = 0.5 * origin_img.astype(np.float32) + 0.5 * crop.astype(np.float32)
        return out.astype(np.uint8), origin_labels
