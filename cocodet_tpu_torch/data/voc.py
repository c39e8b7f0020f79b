"""PASCAL VOC detection dataset (cocodet_tpu/data/voc.py), without cv2: the
VOC2007/2012 layout, image-set splits, XML boxes with the difficult flag,
and the COCO dataset's item tuple. Images are read by
``image_io.read_image`` and resized by ``transforms.resize``, the port's
bit-exact counterparts of ``cv2.imread`` and ``cv2.resize`` INTER_LINEAR.

The dataset has no ``annotations`` list, as JAX's has none, so the device
mosaic (``data/device_mosaic.py``) refuses it; the host mosaic takes it.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from .image_io import read_image
from .transforms import resize

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def parse_voc_xml(path: str, keep_difficult: bool = False) -> Tuple[np.ndarray, List[int]]:
    """(N, 5) f32 [x1 y1 x2 y2 class] in 0-based pixels (VOC's are 1-based),
    and the difficult flags. Difficult objects are dropped unless
    ``keep_difficult``; names outside VOC_CLASSES are dropped."""
    root = ET.parse(path).getroot()
    boxes, difficult = [], []
    for obj in root.iter("object"):
        diff = int(obj.findtext("difficult", "0"))
        if diff and not keep_difficult:
            continue
        name = obj.findtext("name", "").lower().strip()
        if name not in VOC_CLASSES:
            continue
        bb = obj.find("bndbox")
        box = [float(bb.findtext(k)) - 1 for k in ("xmin", "ymin", "xmax", "ymax")]
        boxes.append(box + [VOC_CLASSES.index(name)])
        difficult.append(diff)
    arr = np.asarray(boxes, np.float32) if boxes else np.zeros((0, 5), np.float32)
    return arr, difficult


class VOCDetection:
    """Items ``(img resized by r = min(size / h, size / w), boxes * r, (h,
    w), index)``; ``items`` lists ``(VOC<year> root, image id)`` in the
    image sets' order."""

    def __init__(self, data_dir: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"),
                                                          ("2012", "trainval")),
                 img_size: Tuple[int, int] = (640, 640), preproc=None,
                 keep_difficult: bool = False):
        self.data_dir = data_dir
        self.img_size = img_size
        self.preproc = preproc
        self.keep_difficult = keep_difficult
        self.items: List[Tuple[str, str]] = []
        for year, split in image_sets:
            root = os.path.join(data_dir, f"VOC{year}")
            with open(os.path.join(root, "ImageSets", "Main", f"{split}.txt")) as f:
                self.items += [(root, line.strip()) for line in f]

    def __len__(self):
        return len(self.items)

    def annotation_path(self, index: int) -> str:
        root, img_id = self.items[index]
        return os.path.join(root, "Annotations", f"{img_id}.xml")

    def pull_item(self, index: int):
        root, img_id = self.items[index]
        img = read_image(os.path.join(root, "JPEGImages", f"{img_id}.jpg"))
        h, w = img.shape[:2]
        res, _ = parse_voc_xml(self.annotation_path(index), self.keep_difficult)
        r = min(self.img_size[0] / h, self.img_size[1] / w)
        img = resize(img, (int(w * r), int(h * r)))
        res = res.copy()
        res[:, :4] *= r
        return img, res, (h, w), index

    def __getitem__(self, index: int):
        img, target, info, idx = self.pull_item(index)
        if self.preproc is not None:
            img, target = self.preproc(img, target, self.img_size)
        return img, target, info, idx
