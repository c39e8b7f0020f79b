"""Procedural multi-class synthetic detection dataset in COCO layout
(cocodet_tpu/data/synthetic.py), without cv2; and a PASCAL VOC tree of the
same drawings for the VOC path (``make_synthetic_voc``, the port's own).

K classes are shape x colour (disk/square/triangle/ring x R/G/B), 1 to
max_objects instances an image at log-uniform scales, textured backgrounds
and unlabelled distractor blobs, written as train2017/, val2017/ and
annotations/instances_*.json with category ids of the 91-id COCO space.

The draws come from ``np.random.RandomState`` in exactly the JAX package's
order, and no annotation depends on a pixel, so ``instances_*.json`` equals
the JAX package's exactly: images are written as ``{i:012d}.jpg`` by
``image_io.write_image``, whose encoder writes cv2.imwrite's bytes. A numpy
rasterizer takes the place of cv2's drawing
calls: a filled circle (OpenCV's midpoint algorithm) and an inclusive
filled rectangle give cv2's pixels; the filled ellipse, the triangle and
the thick ellipse outline scan-fill OpenCV's polygons and differ from cv2
on edge pixels only (tests/test_torch_eval_data.py states the share).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .coco import COCO_CLASS_ID
from .image_io import write_image


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)``: OpenCV's midpoint
    circle, a horizontal run of pixels for each step, clipped."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    col = np.asarray(color, np.uint8)

    def run(y, x1, x2):
        if 0 <= y < h and x2 >= 0 and x1 < w:
            img[y, max(x1, 0):min(x2, w - 1) + 1] = col

    while dx >= dy:
        run(cy - dy, cx - dx, cx + dx)
        run(cy + dy, cx - dx, cx + dx)
        run(cy - dx, cx - dy, cx + dy)
        run(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def rectangle(img: np.ndarray, pt1, pt2, color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: both corners included."""
    h, w = img.shape[:2]
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    img[max(y1, 0):min(y2, h - 1) + 1, max(x1, 0):min(x2, w - 1) + 1] = np.asarray(color, np.uint8)


def _ellipse_points(center, axes) -> np.ndarray:
    """The vertices, rounded to pixels, of the polygon OpenCV draws an
    unrotated full ellipse as (cv2.ellipse2Poly's step: 90, 30, 18 or 5
    degrees by the larger axis)."""
    big = max(abs(axes[0]), abs(axes[1]))
    step = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    deg = np.radians(np.arange(0, 360 + step, step))
    return np.rint(np.stack([center[0] + abs(axes[0]) * np.cos(deg),
                             center[1] + abs(axes[1]) * np.sin(deg)], -1))


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` for a convex polygon, by scan
    lines: on each pixel row between the rounded lowest and highest vertex,
    the pixels from the rounded left edge to the rounded right edge."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    h, w = img.shape[:2]
    y0 = max(int(np.floor(pts[:, 1].min() + 0.5)), 0)
    y1 = min(int(np.floor(pts[:, 1].max() + 0.5)), h - 1)
    if y1 < y0:
        return
    ys = np.arange(y0, y1 + 1, dtype=np.float64)
    a, b = pts, np.roll(pts, -1, axis=0)
    dy = b[:, 1] - a[:, 1]
    a, b, dy = a[dy != 0], b[dy != 0], dy[dy != 0]
    t = (ys[None] - a[:, 1, None]) / dy[:, None]
    x = a[:, 0, None] + t * (b[:, 0] - a[:, 0])[:, None]
    on = (t >= 0) & (t <= 1)
    at_vertex = pts[:, 1, None] == ys[None]  # a row through a vertex alone
    xl = np.minimum(np.where(on, x, np.inf).min(0, initial=np.inf),
                    np.where(at_vertex, pts[:, 0, None], np.inf).min(0))
    xr = np.maximum(np.where(on, x, -np.inf).max(0, initial=-np.inf),
                    np.where(at_vertex, pts[:, 0, None], -np.inf).max(0))
    xs = np.arange(w)[None]
    inside = (xs >= np.floor(xl + 0.5)[:, None]) & (xs <= np.floor(xr + 0.5)[:, None])
    img[y0:y1 + 1][inside] = np.asarray(color, np.uint8)


def ellipse(img: np.ndarray, center, axes, color, thickness: int) -> None:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, color, thickness)``:
    OpenCV's polygon filled when ``thickness`` < 0; else its outline drawn
    as OpenCV draws a thick polyline, a quad of that width along each
    segment and a round cap at each vertex."""
    pts = _ellipse_points(center, axes)
    if thickness < 0:
        fill_poly(img, pts, color)
        return
    half = (thickness + (thickness & 1) * 0.5) / 2.0
    for a, b in zip(pts[:-1], pts[1:]):
        dx, dy = a[0] - b[0], b[1] - a[1]
        length = np.hypot(dx, dy)
        if length > 0:
            dp = np.asarray([dy, dx]) * (half / length)
            fill_poly(img, np.stack([a + dp, a - dp, b - dp, b + dp]), color)
    for v in pts:
        circle(img, (int(v[0]), int(v[1])), int(np.floor(thickness / 2 + 0.5)), color)


SHAPES = ("disk", "square", "triangle", "ring")
# base BGR colors; jittered per instance
COLORS = {
    "red": (40, 40, 210),
    "green": (50, 200, 60),
    "blue": (220, 70, 40),
}

SYNTH_CLASSES = tuple(f"{c}_{s}" for s in SHAPES for c in COLORS)  # 12


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return inter / max(ua, 1e-9)


def _draw_background(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    base = rs.randint(40, 130, size=3)
    img = np.tile(base.astype(np.float32), (h, w, 1))
    # linear gradient along a random axis
    g = rs.uniform(-40, 40)
    axis = rs.randint(2)
    ramp = np.linspace(0, 1, h if axis == 0 else w, dtype=np.float32)
    ramp = ramp[:, None, None] if axis == 0 else ramp[None, :, None]
    img += g * ramp
    img += rs.normal(0, 8, size=(h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _draw_distractors(rs, img: np.ndarray, n: int) -> None:
    """Low-saturation blobs that belong to no class (hard negatives)."""
    h, w = img.shape[:2]
    for _ in range(n):
        v = int(rs.randint(60, 180))
        col = tuple(int(np.clip(v + rs.randint(-15, 15), 0, 255))
                    for _ in range(3))
        cx, cy = int(rs.randint(0, w)), int(rs.randint(0, h))
        r = int(rs.randint(4, max(min(h, w) // 6, 5)))
        if rs.randint(2):
            circle(img, (cx, cy), r, col)
        else:
            rectangle(img, (cx - r, cy - r), (cx + r, cy + r), col)


def _draw_instance(rs, img: np.ndarray, cls: int,
                   existing: list, max_tries: int = 20,
                   max_iou: float = 0.3,
                   scale_rng: Tuple[float, float] = (0.08, 0.45),
                   textured: bool = False, center=None
                   ) -> Optional[Tuple[float, float, float, float]]:
    """Draw one instance of class ``cls``; returns its tight xywh bbox or
    None if no low-overlap placement was found."""
    h, w = img.shape[:2]
    shape = SHAPES[cls // len(COLORS)]
    color_name = list(COLORS)[cls % len(COLORS)]
    base = np.asarray(COLORS[color_name], np.int32)
    col = tuple(int(c) for c in np.clip(
        base + rs.randint(-25, 26, size=3), 0, 255))

    for _ in range(max_tries):
        side = float(np.exp(rs.uniform(np.log(scale_rng[0]),
                                       np.log(scale_rng[1])))
                     * min(h, w))
        ar = float(np.exp(rs.uniform(-0.4, 0.4)))
        bw = max(side * ar, 6.0)
        bh = max(side / ar, 6.0)
        if bw >= w - 2 or bh >= h - 2:
            continue
        if center is not None:
            # crowding variant: place near the cluster center
            x1 = float(np.clip(center[0] + rs.normal(0, 0.12 * w) - bw / 2,
                               1, w - bw - 1))
            y1 = float(np.clip(center[1] + rs.normal(0, 0.12 * h) - bh / 2,
                               1, h - bh - 1))
        else:
            x1 = rs.uniform(1, w - bw - 1)
            y1 = rs.uniform(1, h - bh - 1)
        box = np.asarray([x1, y1, x1 + bw, y1 + bh])
        if any(_iou(box, e) > max_iou for e in existing):
            continue
        cx, cy = x1 + bw / 2.0, y1 + bh / 2.0
        if shape == "disk":
            ellipse(img, (int(cx), int(cy)), (int(bw / 2), int(bh / 2)), col, -1)
        elif shape == "square":
            rectangle(img, (int(x1), int(y1)), (int(x1 + bw), int(y1 + bh)), col)
        elif shape == "triangle":
            # upright triangle with horizontal apex jitter
            ax = cx + rs.uniform(-0.2, 0.2) * bw
            pts = np.asarray([[ax, y1], [x1, y1 + bh],
                              [x1 + bw, y1 + bh]], np.int32)
            fill_poly(img, pts, col)
        else:  # ring
            rx, ry = int(bw / 2), int(bh / 2)
            t = max(int(min(rx, ry) * 0.35), 2)
            ellipse(img, (int(cx), int(cy)), (rx - t // 2, ry - t // 2), col, t)
        if textured:
            _texture_fill(rs, img, box, col)
        existing.append(box)
        return (float(x1), float(y1), float(bw), float(bh))
    return None


def _texture_fill(rs, img: np.ndarray, box, col) -> None:
    """Overlay a stripe or checker pattern on the instance region so color
    becomes a distribution over textured pixels, not a flat constant."""
    x1, y1, x2, y2 = (int(v) for v in box)
    x2, y2 = min(x2, img.shape[1]), min(y2, img.shape[0])
    if x2 - x1 < 4 or y2 - y1 < 4:
        return
    region = img[y1:y2, x1:x2].astype(np.int32)
    period = max(int(rs.randint(3, 8)), 2)
    yy, xx = np.mgrid[0:y2 - y1, 0:x2 - x1]
    if rs.randint(2):  # stripes at a random orientation
        phase = (xx if rs.randint(2) else yy) // period % 2
    else:  # checker
        phase = (xx // period + yy // period) % 2
    delta = int(rs.randint(20, 60))
    # only modulate pixels that belong to the instance (match its color)
    mask = (np.abs(region - np.asarray(col)).sum(-1) < 90)
    mod = np.where(phase[..., None].astype(bool), delta, -delta)
    region = np.where(mask[..., None], region + mod, region)
    img[y1:y2, x1:x2] = np.clip(region, 0, 255).astype(np.uint8)


def _draw_occluders(rs, img: np.ndarray, boxes: list, n: int) -> None:
    """Background-toned bars partially covering labeled instances: the
    annotation keeps the full extent (realistic partial occlusion)."""
    h, w = img.shape[:2]
    for _ in range(n):
        if not boxes:
            return
        b = boxes[int(rs.randint(len(boxes)))]
        bw, bh = b[2] - b[0], b[3] - b[1]
        v = int(rs.randint(50, 150))
        col = tuple(int(np.clip(v + rs.randint(-10, 11), 0, 255))
                    for _ in range(3))
        if rs.randint(2):  # vertical bar over up to ~40% of the width
            ow = max(int(bw * rs.uniform(0.15, 0.4)), 2)
            ox = int(np.clip(b[0] + rs.uniform(0, bw - ow), 0, w - ow))
            rectangle(img, (ox, max(int(b[1]) - 2, 0)), (ox + ow, min(int(b[3]) + 2, h)), col)
        else:  # horizontal bar
            oh = max(int(bh * rs.uniform(0.15, 0.4)), 2)
            oy = int(np.clip(b[1] + rs.uniform(0, bh - oh), 0, h - oh))
            rectangle(img, (max(int(b[0]) - 2, 0), oy), (min(int(b[2]) + 2, w), oy + oh), col)


# per-variant generation knobs (cocodet_tpu/data/synthetic.py:247-275)
VARIANTS = {
    # (max-IoU between instances, scale log-range, objects multiplier,
    #  occluders per image, textured instances, photometric gain range)
    "default":   (0.30, (0.08, 0.45), 1.0, 0, False, None),
    "occlusion": (0.50, (0.08, 0.45), 1.0, 3, False, None),
    "crowding":  (0.45, (0.05, 0.22), 3.0, 0, False, None),
    "texture":   (0.30, (0.08, 0.45), 1.0, 0, True, None),
    # smallobj: every instance in the P3-receptive-field tail (7-50 px) at
    # 2x density — the axis channel pruning classically damages first
    # (narrow high-resolution FPN levels carry the small-object signal)
    "smallobj":  (0.30, (0.03, 0.10), 2.0, 0, False, None),
    # lowlight: global gain crush to 25-50% after composition — objectness
    # and color-bucket classification at compressed dynamic range
    "lowlight":  (0.30, (0.08, 0.45), 1.0, 0, False, (0.25, 0.5)),
    # robustness-training mix: each image drawn from one of the four
    # ORIGINAL axes, so one training run sees occluders, 3x density AND
    # textured instances (the val sets stay single-variant for clean
    # per-axis measurement).  smallobj/lowlight are deliberately NOT in
    # the mix: the mix's composition is pinned so chain_mixed results
    # stay comparable across rounds — they are held-out eval-only axes.
    "mixed": None,
}

_MIX = ("default", "occlusion", "crowding", "texture")


def make_synthetic_coco(root: str, n_train: int = 256, n_val: int = 64,
                        size_range: Tuple[int, int] = (256, 512),
                        n_classes: int = len(SYNTH_CLASSES),
                        max_objects: int = 8, seed: int = 0,
                        variant: str = "default") -> str:
    """Write a complete COCO-layout dataset under ``root``; returns root."""
    if not 1 <= n_classes <= len(SYNTH_CLASSES):
        raise ValueError(f"n_classes {n_classes} not in [1, {len(SYNTH_CLASSES)}]")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
    base_max_objects = max_objects
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cats = [{"id": COCO_CLASS_ID[i], "name": SYNTH_CLASSES[i],
             "supercategory": "shape"} for i in range(n_classes)]

    for split, n_images, split_seed in (("train2017", n_train, seed),
                                        ("val2017", n_val, seed + 77777)):
        rs = np.random.RandomState(split_seed)
        out_dir = os.path.join(root, split)
        os.makedirs(out_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n_images):
            img_variant = (_MIX[int(rs.randint(len(_MIX)))]
                           if variant == "mixed" else variant)
            (max_iou, scale_rng, obj_mult, n_occluders,
             textured, photometric) = VARIANTS[img_variant]
            max_objects = max(int(base_max_objects * obj_mult), 1)
            h = int(rs.randint(size_range[0], size_range[1] + 1))
            w = int(rs.randint(size_range[0], size_range[1] + 1))
            img = _draw_background(rs, h, w)
            _draw_distractors(rs, img, int(rs.randint(0, 6)))
            existing: list = []
            centers = None
            if img_variant == "crowding":
                centers = [(rs.uniform(0.2 * w, 0.8 * w),
                            rs.uniform(0.2 * h, 0.8 * h))
                           for _ in range(int(rs.randint(1, 4)))]
            for _ in range(int(rs.randint(1, max_objects + 1))):
                cls = int(rs.randint(n_classes))
                center = (centers[int(rs.randint(len(centers)))]
                          if centers else None)
                bbox = _draw_instance(rs, img, cls, existing,
                                      max_iou=max_iou, scale_rng=scale_rng,
                                      textured=textured, center=center)
                if bbox is None:
                    continue
                annotations.append({
                    "id": ann_id, "image_id": i,
                    "category_id": COCO_CLASS_ID[cls],
                    "bbox": list(bbox), "area": bbox[2] * bbox[3],
                    "iscrowd": 0})
                ann_id += 1
            if n_occluders and existing:
                _draw_occluders(rs, img, existing,
                                int(rs.randint(1, n_occluders + 1)))
            if photometric is not None:
                # rs draws gated on the variant so the draw SEQUENCE of
                # every pre-existing variant is untouched (the chain
                # pipeline's bit-determinism depends on it)
                g = float(rs.uniform(*photometric))
                img = np.clip(img.astype(np.float32) * g,
                              0, 255).astype(np.uint8)
            # final global noise so object edges aren't perfectly clean
            noise = rs.normal(0, 4, size=img.shape)
            img = np.clip(img.astype(np.float32) + noise,
                          0, 255).astype(np.uint8)
            name = f"{i:012d}.jpg"
            write_image(os.path.join(out_dir, name), img)
            images.append({"id": i, "width": w, "height": h,
                           "file_name": name})
        with open(os.path.join(root, "annotations",
                               f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": cats}, f)
    return root


def make_fake_coco(root: str, n_images: int = 8, size: int = 96, seed: int = 0) -> str:
    """The one-box COCO set of the JAX package's tests (tests/synthetic.py::
    make_fake_coco), the data of ``tools/run_pipeline.py --tiny``: train2017/
    and val2017/ each with ``n_images`` grey images of 60 to ``size`` px
    holding one white rectangle of class 1, and their annotations. The same
    draws, pixels (``rectangle``) and JPEG bytes (``write_image``) as JAX's,
    which draws with cv2; returns ``root``."""
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train2017", "val2017"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        images, annotations = [], []
        for i in range(n_images):
            h = int(rs.randint(60, size))
            w = int(rs.randint(60, size))
            img = np.full((h, w, 3), 120, np.uint8)
            x, y = w * 0.2, h * 0.2
            bw, bh = w * 0.5, h * 0.5
            rectangle(img, (int(x), int(y)), (int(x + bw), int(y + bh)), (255, 255, 255))
            name = f"{i:012d}.jpg"
            write_image(os.path.join(root, split, name), img)
            images.append({"id": i, "width": w, "height": h, "file_name": name})
            annotations.append({"id": i, "image_id": i, "category_id": 1,
                                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0})
        cats = [{"id": c, "name": str(c)} for c in range(1, 91)]
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": cats}, f)
    return root


# make_synthetic_voc: at most this many objects an image, each difficult with
# this probability
VOC_MAX_OBJECTS = 6
VOC_DIFFICULT_PROB = 0.15


def make_synthetic_voc(root: str,
                       sets: Sequence[Tuple[str, str, int]] = (("2007", "trainval", 32),
                                                              ("2007", "test", 16),
                                                              ("2012", "trainval", 8)),
                       size_range: Tuple[int, int] = (256, 512),
                       long_side: Optional[int] = None, seed: int = 0) -> str:
    """A PASCAL VOC tree under ``root``/VOCdevkit for the port's VOC path:
    for each (year, image set, count) of ``sets``, JPEGs (``write_image``)
    in ``VOC<year>/JPEGImages``, their XML in ``Annotations`` and the ids in
    ``ImageSets/Main/<set>.txt``. Each image holds 1 to ``VOC_MAX_OBJECTS``
    instances of the 20 VOC classes, taken in turn over a set's boxes and
    class ``c`` drawn as the synthetic shape ``c % 12`` (so classes c and
    c + 12 look alike), with 1-based
    integer boxes, a ``difficult`` flag set with ``VOC_DIFFICULT_PROB``, and
    now and then an object named in other case, padded, or outside the
    classes (which the parser lowers, strips or drops). Sides are drawn
    from ``size_range``; ``long_side`` fixes the longer one. Returns the
    VOCdevkit path."""
    from .voc import VOC_CLASSES

    devkit = os.path.join(root, "VOCdevkit")
    rs = np.random.RandomState(seed)
    for year, image_set, count in sets:
        placed = 0  # the classes in turn, so that each set holds all 20 once it has 20 boxes
        base = os.path.join(devkit, f"VOC{year}")
        for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        ids = []
        for i in range(count):
            img_id = f"{year}_{image_set}_{i:06d}"
            h = int(rs.randint(size_range[0], size_range[1] + 1))
            w = int(rs.randint(size_range[0], size_range[1] + 1))
            if long_side is not None:
                h, w = (long_side, min(w, long_side)) if h >= w else (min(h, long_side),
                                                                      long_side)
            img = _draw_background(rs, h, w)
            existing: list = []
            objects = []
            for _ in range(int(rs.randint(1, VOC_MAX_OBJECTS + 1))):
                cls = placed % len(VOC_CLASSES)
                bbox = _draw_instance(rs, img, cls % len(SYNTH_CLASSES), existing)
                if bbox is None:
                    continue
                placed += 1
                x, y, bw, bh = bbox
                name = VOC_CLASSES[cls]
                kind = int(rs.randint(12))
                if kind == 0:
                    name = f" {name.upper()} "
                elif kind == 1:
                    name = "zebra"
                objects.append((name, int(rs.uniform() < VOC_DIFFICULT_PROB),
                                (int(x) + 1, int(y) + 1, int(x + bw) + 1, int(y + bh) + 1)))
            noise = rs.normal(0, 4, size=img.shape)
            img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
            write_image(os.path.join(base, "JPEGImages", f"{img_id}.jpg"), img)
            xml = [f"<annotation><folder>VOC{year}</folder><filename>{img_id}.jpg</filename>",
                   f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"]
            for name, diff, (x1, y1, x2, y2) in objects:
                xml.append(f"<object><name>{name}</name><pose>Unspecified</pose>"
                           f"<truncated>0</truncated><difficult>{diff}</difficult>"
                           f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                           f"<ymax>{y2}</ymax></bndbox></object>")
            xml.append("</annotation>")
            with open(os.path.join(base, "Annotations", f"{img_id}.xml"), "w") as f:
                f.write("\n".join(xml) + "\n")
            ids.append(img_id)
        with open(os.path.join(base, "ImageSets", "Main", f"{image_set}.txt"), "w") as f:
            f.write("".join(f"{i}\n" for i in ids))
    return devkit
