"""HSV jitter, flip, letterbox and label padding on the card
(cocodet_tpu/data/device_aug.py): the TrainTransform stage of the
device-mosaic path.

``draw_randoms`` draws each item's random vector on the host in the host
TrainTransform's call order. ``train_aug_batch`` runs the pixels as one CUDA
kernel (``ops/cuda/train_aug.py::train_aug``) and the labels as plain tensor
ops before it (the flip, the degenerate-aug fallback, the stable compaction
into the (max_labels, 5) layout the loss takes), with no host sync.
``mosaic_preproc_batch`` is the production composition the trainer runs:
``device_mosaic.mosaic_mixup_batch`` feeding ``train_aug_batch``.

Not ported: ``DeviceAugDataset`` and ``make_device_collate`` (``device_aug``
without ``device_mosaic``, which needs the host mosaic), ``mixup_batch`` and
``DeviceTrainAug`` (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def apply_device_preproc(exp, input_size: Tuple[int, int], batch: Mapping[str, torch.Tensor]):
    """The trainer's device preprocessing of a collated batch dict
    (device_aug.py:343-359). Only the device-mosaic dict is ported."""
    if "mosaic_tiles" not in batch:
        raise NotImplementedError(
            "device_aug without device_mosaic (DeviceAugDataset, make_device_collate) is not "
            "ported (ROADMAP Queue 1 item 1)")
    return mosaic_preproc_batch(batch, tuple(input_size), max_labels=exp.max_labels_mosaic,
                                flip_prob=exp.flip_prob, hsv_prob=exp.hsv_prob)
