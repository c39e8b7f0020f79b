"""COCO dataset layer (cocodet_tpu/data/coco.py:27-161), without cv2: a
dataset item is (img, padded_labels (N, 5), img_info (h, w), img_id), the
image resized to the dataset's ``img_size`` with its annotations scaled by
the same ratio. The image is read by ``image_io.read_image`` (JPEG and
8-bit PNG, as ``cv2.imread`` reads them) and resized by
``transforms.resize``, cv2.resize's arithmetic.
The ratio and the resized size are Python floats and ints, as in the JAX
package (coco.py:128-136).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image_io import read_image
from .transforms import resize

logger = logging.getLogger(__name__)

# 80 contiguous training classes -> 91-id COCO category space
# (cocodet_tpu/data/coco.py:27-33)
COCO_CLASS_ID = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


def get_datadir() -> str:
    """ref yolox/data/dataloading.py:18-29 (YOLOX_DATADIR env)."""
    return os.environ.get("YOLOX_DATADIR", os.path.join(os.getcwd(), "datasets"))


class COCOAnnotations:
    """Minimal COCO instances-json reader (pycocotools-free)."""

    def __init__(self, ann_path: str):
        with open(ann_path) as f:
            data = json.load(f)
        self.images: Dict[int, dict] = {im["id"]: im for im in data["images"]}
        self.ids: List[int] = sorted(self.images)
        cat_ids = sorted(c["id"] for c in data.get("categories", []))
        self.cat_to_contig = {c: i for i, c in enumerate(cat_ids)}
        self.anns_per_image: Dict[int, List[dict]] = {i: [] for i in self.ids}
        for ann in data.get("annotations", []):
            # crowd annotations are kept (eval needs them as ignore regions)
            # and filtered out of the training targets in boxes_for()
            self.anns_per_image.setdefault(ann["image_id"], []).append(ann)

    def boxes_for(self, img_id: int) -> np.ndarray:
        """(N, 5) [x1, y1, x2, y2, contiguous_class] with degenerate boxes
        dropped (upstream COCODataset semantics)."""
        im = self.images[img_id]
        w, h = im["width"], im["height"]
        out = []
        for ann in self.anns_per_image.get(img_id, []):
            if ann.get("iscrowd", 0):
                continue
            x1, y1, bw, bh = ann["bbox"]
            x2 = min(x1 + bw, w)
            y2 = min(y1 + bh, h)
            x1 = max(x1, 0)
            y1 = max(y1, 0)
            if ann.get("area", bw * bh) > 0 and x2 > x1 and y2 > y1:
                out.append([x1, y1, x2, y2, self.cat_to_contig[ann["category_id"]]])
        if not out:
            return np.zeros((0, 5), np.float32)
        return np.asarray(out, np.float32)


class COCODataset:
    """Detection dataset over a COCO directory layout.

    Returns (img HWC uint8/float32, targets, img_info (h, w), img_id); with a
    ``preproc`` (TrainTransform/ValTransform) attached, targets are the fixed
    (max_labels, 5) padded array.
    """

    def __init__(
        self,
        data_dir: Optional[str] = None,
        json_file: str = "instances_train2017.json",
        name: str = "train2017",
        img_size: Tuple[int, int] = (640, 640),
        preproc=None,
        cache: bool = False,
    ):
        self.data_dir = data_dir or get_datadir()
        self.name = name
        self.img_size = img_size
        self.preproc = preproc
        ann_path = os.path.join(self.data_dir, "annotations", json_file)
        self.coco = COCOAnnotations(ann_path)
        self.ids = self.coco.ids
        self.annotations = [self._load_anno(i) for i in self.ids]
        self._cache: Optional[List[Optional[np.ndarray]]] = (
            [None] * len(self.ids) if cache else None)
        logger.info("COCODataset: %d images from %s", len(self.ids), ann_path)

    def __len__(self):
        return len(self.ids)

    def _load_anno(self, img_id: int):
        im = self.coco.images[img_id]
        h, w = im["height"], im["width"]
        res = self.coco.boxes_for(img_id)
        r = min(self.img_size[0] / h, self.img_size[1] / w)
        res = res.copy()
        res[:, :4] *= r
        file_name = im.get("file_name", f"{img_id:012d}.jpg")
        return res, (h, w), (int(h * r), int(w * r)), file_name

    def _read_img(self, index: int) -> np.ndarray:
        _, _, (rh, rw), file_name = self.annotations[index]
        path = os.path.join(self.data_dir, self.name, file_name)
        return resize(read_image(path), (rw, rh))

    def load_resized_img(self, index: int) -> np.ndarray:
        if self._cache is not None:
            if self._cache[index] is None:
                self._cache[index] = self._read_img(index)
            return self._cache[index].copy()
        return self._read_img(index)

    def pull_item(self, index: int):
        res, img_info, _, _ = self.annotations[index]
        img = self.load_resized_img(index)
        return img, res.copy(), img_info, self.ids[index]

    def __getitem__(self, index: int):
        img, target, img_info, img_id = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, img_info, img_id
