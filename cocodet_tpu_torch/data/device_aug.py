"""HSV jitter, flip, letterbox and label padding on the card
(cocodet_tpu/data/device_aug.py): the TrainTransform stage of the
device-mosaic and device-aug paths.

``draw_randoms`` draws each item's random vector on the host in the host
TrainTransform's call order. ``train_aug_batch`` runs the pixels as one CUDA
kernel (``ops/cuda/train_aug.py::train_aug``, K4) and the labels as plain
tensor ops before it (the flip, the degenerate-aug fallback, the stable
compaction into the (max_labels, 5) layout the loss takes), with no host
sync. ``apply_device_preproc`` is what the trainer runs on a collated batch
dict: on the device-mosaic path ``device_mosaic.mosaic_mixup_batch``
feeding ``train_aug_batch`` (``mosaic_preproc_batch``), and on the
device-aug path (``device_aug`` without ``device_mosaic``) K4 alone, on the
images the host mosaic composed without its TrainTransform
(``DeviceAugDataset``), packed into static uint8 buffers by
``make_device_collate``. ``DeviceTrainAug`` is the same packing and K4 for
a caller's own (image, boxes) items; ``mixup_batch`` the 0.5/0.5 mixup of
two letterboxed batches, which no trainer calls, in JAX as here.
"""

from __future__ import annotations

import random
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.cuda import train_aug as kernels

# per-image random vector (device_aug.py:37-42): [0] hsv gate, [1:4] hsv gain
# draws U[-1, 1], [4:7] hsv on/off draws, [7] flip draw
N_RANDOMS = 8


def draw_randoms(rng, n: int, hsv_prob: float = 1.0) -> np.ndarray:
    """The (n, N_RANDOMS) vector in the host TrainTransform's call order: the
    gate, then 3 gains and 3 on/off ints only when the gate passes, then the
    flip (device_aug.py:45-59)."""
    out = np.zeros((n, N_RANDOMS), np.float32)
    for i in range(n):
        out[i, 0] = rng.random()
        if out[i, 0] < hsv_prob:
            out[i, 1:4] = [rng.uniform(-1, 1) for _ in range(3)]
            out[i, 4:7] = [rng.randint(0, 1) for _ in range(3)]
        out[i, 7] = rng.random()
    return out


def xyxy2cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    return torch.cat([boxes[..., 0:2] + wh * 0.5, wh], dim=-1)


def aug_inputs(hw: torch.Tensor, boxes: torch.Tensor, nvalid: torch.Tensor,
               randoms: torch.Tensor, out_size: Tuple[int, int], flip_prob: float = 0.5,
               hsv_prob: float = 1.0, hgain: float = 5.0, sgain: float = 30.0,
               vgain: float = 30.0) -> Dict[str, torch.Tensor]:
    """What ``_train_aug_one`` decides before its pixels, for a batch: the
    truncated HSV gains (B, 3), the flip and the degenerate-aug fallback (B,)
    int32 that the kernel takes, and the flipped boxes' (valid, keep,
    cxcywh, r_pre) for the labels. If the scaling kills every box, the item
    falls back to the clean image and all its original boxes
    (transforms.py:168-170, 182-186)."""
    oh, ow = out_size
    dev = boxes.device
    hsv_on = randoms[:, 0] < hsv_prob
    gains = (randoms[:, 1:4] * torch.tensor([hgain, sgain, vgain], dtype=torch.float32,
                                            device=dev)
             * randoms[:, 4:7] * hsv_on[:, None].to(torch.float32))
    do_flip = randoms[:, 7] < flip_prob
    valid = torch.arange(boxes.shape[1], device=dev)[None, :] < nvalid[:, None]
    w = hw[:, 1].to(torch.float32)[:, None]
    flipped = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]],
                          dim=-1)
    fboxes = torch.where(do_flip[:, None, None], flipped, boxes)
    h0, w0 = hw[:, 0].to(torch.float32), hw[:, 1].to(torch.float32)
    r_pre = torch.minimum(torch.full_like(h0, float(oh)) / h0,
                          torch.full_like(w0, float(ow)) / w0)[:, None, None]
    cxcywh = xyxy2cxcywh(fboxes) * r_pre
    keep = valid & (torch.minimum(cxcywh[..., 2], cxcywh[..., 3]) > 1.0)
    return {"gains": torch.trunc(gains), "flip": do_flip.to(torch.int32),
            "fallback": (~keep.any(1)).to(torch.int32), "valid": valid, "keep": keep,
            "cxcywh": cxcywh, "r_pre": r_pre}


def train_aug_batch(images: torch.Tensor, hw: torch.Tensor, boxes: torch.Tensor,
                    classes: torch.Tensor, nvalid: torch.Tensor, randoms: torch.Tensor,
                    nhw: torch.Tensor, out_size: Tuple[int, int] = (640, 640),
                    max_labels: int = 50, flip_prob: float = 0.5, hsv_prob: float = 1.0,
                    hgain: float = 5.0, sgain: float = 30.0, vgain: float = 30.0):
    """The batched TrainTransform (device_aug.py:202-295).

    images (B, sh, sw, 3) uint8, hw and the host extents nhw (B, 2) int32,
    boxes (B, N, 4) f32 xyxy, classes (B, N), nvalid (B,) int32, randoms (B,
    N_RANDOMS) f32 -> images (B, oh, ow, 3) f32, labels (B, max_labels, 5)
    [class, cx, cy, w, h]."""
    dev = images.device
    a = aug_inputs(hw, boxes, nvalid, randoms, out_size, flip_prob, hsv_prob, hgain, sgain,
                   vgain)
    out = kernels.train_aug(images, hw, nhw, a["gains"], a["flip"], a["fallback"], out_size)

    fallback = a["fallback"] > 0
    final_boxes = torch.where(fallback[:, None, None], xyxy2cxcywh(boxes) * a["r_pre"],
                              a["cxcywh"])
    final_keep = torch.where(fallback[:, None], a["valid"], a["keep"])
    order = torch.argsort((~final_keep).to(torch.int8), dim=1, stable=True)[:, :max_labels]
    merged = torch.cat([classes[..., None], final_boxes], dim=-1)
    gathered = torch.gather(merged, 1, order[..., None].expand(-1, -1, 5))
    if gathered.shape[1] < max_labels:
        gathered = torch.nn.functional.pad(gathered, (0, 0, 0, max_labels - gathered.shape[1]))
    kcount = final_keep.sum(1)
    live = torch.arange(max_labels, device=dev)[None, :] < kcount[:, None]
    return out, torch.where(live[..., None], gathered, 0.0)


def mosaic_preproc_batch(batch: Mapping[str, torch.Tensor], out_size: Tuple[int, int],
                         max_labels: int = 120, flip_prob: float = 0.5,
                         hsv_prob: float = 1.0):
    """The device-mosaic batch dict -> (images, labels): the mosaic, affine and
    mixup program feeding the TrainTransform program (device_aug.py:313-340).
    A passthrough item letterboxes tile 0 at its host extents nhw5[:, 0]."""
    from .device_mosaic import mosaic_mixup_batch

    ih, iw = tuple(out_size)
    img, hw, boxes, classes, nvalid = mosaic_mixup_batch(
        batch["mosaic_tiles"], batch["hw5"], batch["nhw5"], batch["boxes5"],
        batch["classes5"], batch["nvalid5"], batch["mrand"], out_size=(ih, iw))
    nhw_final = torch.where(batch["mrand"][:, :1] > 0,
                            torch.tensor([[ih, iw]], dtype=torch.int32, device=img.device),
                            batch["nhw5"][:, 0])
    return train_aug_batch(img, hw, boxes, classes, nvalid, batch["randoms"], nhw_final,
                           out_size=(ih, iw), max_labels=max_labels, flip_prob=flip_prob,
                           hsv_prob=hsv_prob)


def mixup_batch(images_a: torch.Tensor, labels_a: torch.Tensor, images_b: torch.Tensor,
                labels_b: torch.Tensor):
    """0.5/0.5 mixup of two letterboxed batches with the union of their
    labels (device_aug.py:298-311): (B, L, 5) zero-padded labels, a's live
    rows then b's, stably front-compacted and cut to L."""
    imgs = 0.5 * images_a + 0.5 * images_b
    both = torch.cat([labels_a, labels_b], dim=1)
    live = (both[..., 3] > 0) & (both[..., 4] > 0)
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    both = torch.gather(both, 1, order[..., None].expand(-1, -1, both.shape[-1]))
    return imgs, both[:, :labels_a.shape[1]]


def apply_device_preproc(exp, input_size: Tuple[int, int], batch: Mapping[str, torch.Tensor]):
    """The trainer's device preprocessing of a collated batch dict
    (device_aug.py:343-359): the device-mosaic dict of
    ``make_mosaic_collate``, or the device-aug dict of
    ``make_device_collate`` (K4 alone)."""
    if "mosaic_tiles" in batch:
        return mosaic_preproc_batch(batch, tuple(input_size), max_labels=exp.max_labels_mosaic,
                                    flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob)
    if "nhw" not in batch:
        raise ValueError("the device-aug batch carries no host extents nhw: collate it with "
                         "make_device_collate(..., out_size=input_size)")
    return train_aug_batch(batch["images_u8"], batch["hw"], batch["boxes_xyxy"], batch["classes"],
                           batch["nvalid"], batch["randoms"], batch["nhw"],
                           out_size=tuple(input_size), max_labels=exp.max_labels_mosaic,
                           flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob)


class DeviceAugDataset:
    """A ``MosaicDetection`` built with ``preproc=None``, whose ``fetch``
    returns the composed uint8 image, its xyxy + class labels and the item's
    random vector, drawn after the mosaic's draws from the same ``rng``
    (device_aug.py:362-398). An item with no labels draws nothing, as the
    host TrainTransform returns before its first draw, and carries
    ``[1, 0, 0, 0, 0, 0, 0, 1]``: gates of 1 turn HSV and the flip off."""

    def __init__(self, inner, hsv_prob: float = 1.0):
        self._inner = inner
        self._hsv_prob = hsv_prob

    def __len__(self):
        return len(self._inner)

    def close_mosaic(self):
        self._inner.close_mosaic()

    def __getattr__(self, name):
        if name.startswith("__") or name in ("_inner", "_hsv_prob"):
            raise AttributeError(name)  # (unpickling, before __init__'s attributes)
        return getattr(self._inner, name)

    def fetch(self, index, rng=None):
        rng = rng or getattr(self._inner, "rng", None) or random
        img, labels, info, img_id = self._inner.fetch(index, rng)
        if len(labels) == 0:
            randoms = np.asarray([1, 0, 0, 0, 0, 0, 0, 1], np.float32)
        else:
            randoms = draw_randoms(rng, 1, self._hsv_prob)[0]
        return img, labels, randoms, info, img_id


_PACK_WARNED = [False]


def pack_items(items: Sequence, src_size: Tuple[int, int], max_boxes: int,
               out_size: Optional[Tuple[int, int]] = None):
    """(uint8 image, (n, 5) xyxy + class) items -> ``train_aug_batch``'s
    static numpy buffers (device_aug.py:402-440): images (B, sh, sw, 3)
    uint8 in the top-left corner, hw (B, 2) int32, boxes (B, max_boxes, 4)
    and classes (B, max_boxes) f32, nvalid (B,) int32, and the letterbox
    extents nhw = (int(h r), int(w r)) (B, 2) int32 in host f64, r = min(oh
    / h, ow / w), when ``out_size`` is given (zeros otherwise). An image
    larger than the buffer is cropped, with one warning a process."""
    b = len(items)
    sh, sw = src_size
    imgs = np.zeros((b, sh, sw, 3), np.uint8)
    hw = np.zeros((b, 2), np.int32)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    classes = np.zeros((b, max_boxes), np.float32)
    nvalid = np.zeros((b,), np.int32)
    nhw = np.zeros((b, 2), np.int32)
    for i, (img, tg) in enumerate(items):
        if (img.shape[0] > sh or img.shape[1] > sw) and not _PACK_WARNED[0]:
            _PACK_WARNED[0] = True
            print(f"[device_aug] WARNING: {img.shape[0]}x{img.shape[1]} image cropped to the "
                  f"{sh}x{sw} static buffer (raise exp.device_aug_src_scale to keep host "
                  f"parity)", flush=True)
        h = min(img.shape[0], sh)
        w = min(img.shape[1], sw)
        imgs[i, :h, :w] = img[:h, :w]
        hw[i] = (h, w)
        n = min(len(tg), max_boxes)
        if n:
            boxes[i, :n] = tg[:n, :4]
            classes[i, :n] = tg[:n, 4]
        nvalid[i] = n
        if out_size is not None:
            r = min(out_size[0] / h, out_size[1] / w)
            nhw[i] = (int(h * r), int(w * r))
    return imgs, hw, boxes, classes, nvalid, nhw


def make_device_collate(src_size: Tuple[int, int], max_boxes: int = 120,
                        out_size: Optional[Tuple[int, int]] = None):
    """The collate of ``DeviceAugDataset`` items (device_aug.py:443-463):
    (batch dict, None, infos, ids), the dict's uint8 images a quarter of the
    host path's f32 bytes on their way to the card. The dict carries
    ``nhw`` when ``out_size`` is given."""

    def collate(items):
        randoms = np.stack([it[2] for it in items]).astype(np.float32)
        infos = [it[3] for it in items]
        ids = [it[4] for it in items]
        imgs, hw, boxes, classes, nvalid, nhw = pack_items(
            [(it[0], it[1]) for it in items], src_size, max_boxes, out_size=out_size)
        batch = {"images_u8": imgs, "hw": hw, "boxes_xyxy": boxes, "classes": classes,
                 "nvalid": nvalid, "randoms": randoms}
        if out_size is not None:
            batch["nhw"] = nhw
        return batch, None, infos, ids

    return collate


class DeviceTrainAug:
    """Raw (uint8 image, xyxy + class labels) items -> the TrainTransform's
    (images, labels) on ``device`` (device_aug.py:466-498): packed by
    ``pack_items``, their randoms drawn from ``rng`` in the host order, and
    K4 with the label math on the card (the plain versions on the CPU)."""

    def __init__(self, input_size: Tuple[int, int], src_size: Tuple[int, int],
                 max_labels: int = 50, max_boxes: int = 120, flip_prob: float = 0.5,
                 hsv_prob: float = 1.0, device: Union[str, torch.device] = "cuda"):
        self.input_size = tuple(input_size)
        self.src_size = tuple(src_size)
        self.max_labels = max_labels
        self.max_boxes = max_boxes
        self.flip_prob = flip_prob
        self.hsv_prob = hsv_prob
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: DeviceTrainAug runs on the card unless it is "
                               "asked for the CPU (device='cpu')")

    def collate(self, items, rng):
        """The host's numpy buffers: (imgs, hw, boxes, classes, nvalid,
        randoms, nhw)."""
        imgs, hw, boxes, classes, nvalid, nhw = pack_items(
            items, self.src_size, self.max_boxes, out_size=self.input_size)
        randoms = draw_randoms(rng, len(items), self.hsv_prob)
        return imgs, hw, boxes, classes, nvalid, randoms, nhw

    def __call__(self, items, rng):
        arrays = [torch.from_numpy(a).to(self.device) for a in self.collate(items, rng)]
        return train_aug_batch(*arrays, out_size=self.input_size, max_labels=self.max_labels,
                               flip_prob=self.flip_prob, hsv_prob=self.hsv_prob)
