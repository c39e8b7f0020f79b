"""Image-folder inference dataset with aspect-ratio bucketing, the
submission harness's loader (cocodet_tpu/data/folder.py), without cv2.

Files are sorted by aspect ratio h/w; each is read by
``image_io.read_image`` (JPEG and 8-bit PNG), resized to the long side
by ``transforms.resize`` (cv2.resize's arithmetic), BGR, not normalized;
a batch is padded with 114 to its largest image rounded up to multiples
of 64 (the model's largest stride), top-left anchored, so a run sees at
most (img_size / 64)^2 batch shapes. Where the JAX package's
``list_images`` falls back to a full cv2 decode on a header it cannot
parse, the port's raises.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from .image_io import read_image
from .transforms import resize

IMG_EXT = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp"}


def probe_image_size(path: str) -> Tuple[int, int]:
    """(h, w) from the file header only — no full decode. Covers JPEG, PNG,
    BMP, GIF, WEBP(VP8/VP8L/VP8X) and little-endian TIFF; returns (0, 0) on
    unknown formats."""
    import struct

    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == b"\x89PNG\r\n\x1a\n":  # IHDR is the first chunk
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"BM":  # BITMAPINFOHEADER
            w, h = struct.unpack("<ii", head[18:26])
            return abs(h), abs(w)
        if head[:6] in (b"GIF87a", b"GIF89a"):
            w, h = struct.unpack("<HH", head[6:10])
            return h, w
        if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
            fourcc = head[12:16]
            if fourcc == b"VP8X":
                w = int.from_bytes(head[24:27], "little") + 1
                h = int.from_bytes(head[27:30], "little") + 1
                return h, w
            if fourcc == b"VP8L" and head[20:21] == b"\x2f":
                bits = int.from_bytes(head[21:25], "little")
                return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
            if fourcc == b"VP8 ":
                w, h = struct.unpack("<HH", head[26:30])
                return h & 0x3FFF, w & 0x3FFF
            return 0, 0
        if head[:2] in (b"II", b"MM") and head[2:4] in (b"*\x00", b"\x00*"):
            le = head[:2] == b"II"
            fmt = "<" if le else ">"
            f.seek(struct.unpack(fmt + "I", head[4:8])[0])
            n = struct.unpack(fmt + "H", f.read(2))[0]
            h = w = 0
            for _ in range(n):
                tag_bytes = f.read(12)
                tag, typ = struct.unpack(fmt + "HH", tag_bytes[:4])
                val = struct.unpack(
                    fmt + ("H" if typ == 3 else "I"), tag_bytes[8:10 if typ == 3 else 12])[0]
                if tag == 256:
                    w = val
                elif tag == 257:
                    h = val
            return h, w
        if head[:2] == b"\xff\xd8":  # JPEG: scan segments for SOFn
            f.seek(2)
            while True:
                seg = f.read(4)
                if len(seg) < 4:
                    return 0, 0
                while seg[0:1] != b"\xff":  # resync on stray bytes
                    seg = seg[1:] + f.read(1)
                    if len(seg) < 4:
                        return 0, 0
                marker, ln = seg[1], struct.unpack(">H", seg[2:4])[0]
                if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                    data = f.read(5)
                    h, w = struct.unpack(">HH", data[1:5])
                    return h, w
                f.seek(ln - 2, 1)
    return 0, 0


def list_images(data_dir: str) -> List[Tuple[str, int, int]]:
    """(filename, h, w) for every image in the folder, sizes from a
    header-only probe (O(files), not O(bytes)). A header the probe cannot
    parse raises."""
    out = []
    for f in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, f)
        if not os.path.isfile(path) or f.split(".")[-1].lower() not in IMG_EXT:
            continue
        h, w = probe_image_size(path)
        if h <= 0 or w <= 0:
            raise ValueError(f"{path}: image size not found in its header")
        out.append((f, h, w))
    return out


def exposure_normalize(img: np.ndarray,
                       dark_hi: float = 130.0,
                       dark_lo: float = 20.0,
                       full_hi: float = 110.0,
                       full_lo: float = 15.0) -> np.ndarray:
    """Adaptive per-image exposure normalization (lowlight rescue), as
    cocodet_tpu/data/folder.py:115-150 computes it.

    A globally gain-crushed image carries its structure in a compressed
    intensity window. Its signature is both percentiles scaled toward zero:
    inside the certain-crush region (p98 < ``full_hi`` and p2 < ``full_lo``)
    the p2..p98 window is stretched to [16, 240]; from there the correction
    ramps linearly to zero at the outer boundary (``dark_hi``, ``dark_lo``);
    everything outside passes through untouched.
    """
    lo, hi = np.percentile(img, (2.0, 98.0))
    if hi >= dark_hi or lo >= dark_lo or hi - lo < 4.0:
        return img  # well-exposed / naturally-dim / flat: identity
    w = min(1.0, (dark_hi - hi) / (dark_hi - full_hi),
            (dark_lo - lo) / (dark_lo - full_lo))
    scale = min((240.0 - 16.0) / (hi - lo), 8.0)
    stretched = (img.astype(np.float32) - lo) * scale + 16.0
    out = img.astype(np.float32) + w * (stretched - img.astype(np.float32))
    return np.clip(out, 0.0, 255.0).astype(img.dtype)


class ImageFolderDataset:
    """Aspect-sorted image folder (cocodet_tpu/data/folder.py:153-180)."""

    def __init__(self, data_dir: str, img_size: int,
                 exposure_norm: bool = False):
        self.data_dir = data_dir
        self.img_size = img_size
        self.exposure_norm = exposure_norm
        files = list_images(data_dir)
        files.sort(key=lambda t: t[1] / t[2])  # by h/w
        self.files = files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        name, h, w = self.files[idx]
        img = read_image(os.path.join(self.data_dir, name))  # BGR
        if w > h:
            nw, nh = self.img_size, int(h * self.img_size / w)
        else:
            nh, nw = self.img_size, int(w * self.img_size / h)
        resized = resize(img, (nw, nh))
        if self.exposure_norm:
            resized = exposure_normalize(resized)
        return resized, (h, w, name, nh, nw)


def collate_batch(img_size: int, items: Sequence, pad_multiple: int = 64):
    """Pad a list of resized images to one NHWC float32 batch, 114-filled,
    its height and width snapped up to multiples of ``pad_multiple``."""
    max_h = max(it[1][3] for it in items)
    max_w = max(it[1][4] for it in items)
    # pad_multiple is the MODEL's max stride (64 for P6) — it must not be
    # relaxed for odd img_size or stride-64 upsample/concat shapes mismatch
    # inside the PAFPN.
    mult = pad_multiple
    max_h = int(math.ceil(max_h / mult) * mult)
    max_w = int(math.ceil(max_w / mult) * mult)

    batch = np.full((len(items), max_h, max_w, 3), 114, np.uint8)
    infos = []
    for i, (img, (h, w, name, nh, nw)) in enumerate(items):
        batch[i, :nh, :nw] = img
        infos.append((h, w, name))
    return np.ascontiguousarray(batch, np.float32), infos


class FolderLoader:
    """Simple batched iterator over ImageFolderDataset."""

    def __init__(self, dataset: ImageFolderDataset, batch_size: int,
                 pad_multiple: int = 64):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_multiple = pad_multiple

    def __iter__(self):
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            items = [self.dataset[i]
                     for i in range(start, min(start + self.batch_size, n))]
            imgs, infos = collate_batch(self.dataset.img_size, items,
                                        self.pad_multiple)
            # a ragged last batch is padded to the batch size (its rows unread)
            if len(items) < self.batch_size:
                pad = self.batch_size - len(items)
                imgs = np.concatenate(
                    [imgs, np.full((pad,) + imgs.shape[1:], 114.0,
                                   np.float32)])
            yield imgs, infos
