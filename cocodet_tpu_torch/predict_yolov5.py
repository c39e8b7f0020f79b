"""The YOLOv5m6 predictor of the multi-model submission
(harness/predict_yolov5.py) on the port.

    python -m cocodet_tpu_torch.predict_yolov5 --data-dir DIR [--img-size 1280]
        [--batch-size 8] [--conf 0.001] [--nms 0.65] [--out answersheet_yolov5.json]
        [--dummy] [--device cuda|cpu] [--ckpt FILE]

The fused YOLOv5m6 (``models/anchor_zoo.py``) in bf16 on an image folder
(``data/folder.py``: aspect-sorted, resized to ``--img-size``, 114-padded
batches), each batch ``/255``, decoded, the class max taken, the 2000 best
candidates at ``--conf`` (ties lowest index first, as ``jax.lax.top_k``)
through ``ops/nms.py::batched_nms`` at IoU ``--nms`` to 300 detections.
The answer sheet is the JSON list JAX's predictor writes: for each kept
detection ``image_id`` (the file name), ``category_id`` (COCO's),
``bbox`` (x, y, w, h scaled back to the image in f32) and ``score``.
``--dummy`` (or no ``--data-dir``) runs one random batch instead.

Weights: numpy seed 0 (``utils/convert.py::random_variables``; JAX's
predictor draws its own random init, the reference's ``.pt`` weights are not
in the repository), or a flax msgpack tree of the model with ``--ckpt``
(``{"params": ...}``, or under ``"model"``). Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data.coco import COCO_CLASS_ID
from .models.anchor_zoo import build_anchor_model, decode_anchor_outputs
from .ops.nms import NMSResult, batched_nms
from .ops.postprocess import topk_stable
from .utils.checkpoint import load_checkpoint
from .utils.convert import load_variables, random_variables

PRE_NMS_TOPK = 2000
MAX_DET = 300


def load_anchor_model(name: str, device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.bfloat16, ckpt: Optional[str] = None,
                      width_multiple: Optional[float] = None):
    """(model, anchors, strides): the fused ``name`` on ``device`` in eval
    mode, computing in ``dtype`` with its parameters in it, its weights the
    flax msgpack tree at ``ckpt`` or numpy seed 0; ``width_multiple``
    overrides the published width."""
    with torch.device("meta"):
        model, anchors, strides = build_anchor_model(name, fused=True, dtype=dtype,
                                                     width_multiple=width_multiple)
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    if ckpt is None:
        variables = random_variables(model, 0)
    else:
        tree = load_checkpoint(ckpt)
        tree = tree.get("model", tree)
        variables = {"params": tree.get("params", tree)}
    load_variables(model, variables)
    return model.to(dtype).eval(), anchors, strides


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.inference_mode()
def predict(model, anchors: Sequence, strides: Sequence[int], images: torch.Tensor,
            conf: float = 0.001, nms: float = 0.65, num_classes: int = 80) -> NMSResult:
    """One batch of NHWC float images (0-255) through the predictor's step
    (harness/predict_yolov5.py:52-63)."""
    outs = model(images / 255.0)  # v5 normalizes /255
    boxes, obj, cls = decode_anchor_outputs(outs, anchors, strides, num_classes)
    score = cls.amax(-1)
    klass = cls.argmax(-1).to(torch.int32)
    k = min(PRE_NMS_TOPK, score.shape[1])
    top, order = topk_stable(torch.where(score >= conf, score, torch.full_like(score, -1.0)), k)

    def take(t):
        idx = order if t.dim() == 2 else order[..., None].expand(-1, -1, t.shape[-1])
        return torch.gather(t, 1, idx)

    return batched_nms(take(boxes), top, take(klass), take(obj[..., 0]), top >= 0.0,
                       iou_threshold=nms, max_det=MAX_DET)


def answer_records(res: NMSResult, infos, size: int) -> List[dict]:
    """The answer sheet's records of one batch, as harness/predict_yolov5.py:
    78-91 writes them (the f32 arithmetic of its numpy arrays)."""
    boxes, scores, classes, valid = (t.cpu().numpy() for t in (
        res.boxes, res.scores, res.classes, res.valid))
    records = []
    for i, (h, w, name) in enumerate(infos):
        scale = min(size / h, size / w)
        for j in range(boxes.shape[1]):
            if not valid[i, j]:
                break
            x1, y1, x2, y2 = boxes[i, j] / scale
            records.append({"image_id": name,
                            "category_id": COCO_CLASS_ID[int(classes[i, j])],
                            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                            "score": float(scores[i, j])})
    return records


def run(args: argparse.Namespace, dtype: torch.dtype = torch.bfloat16,
        report: Optional[dict] = None) -> Tuple[int, List[dict]]:
    """The predictor on ``args`` (``main``'s flags); returns (images served,
    records written). ``report``, if given, receives the seconds of each
    phase and the batch shapes."""
    from .data.folder import FolderLoader, ImageFolderDataset

    device = torch.device(args.device)
    t0 = time.perf_counter()
    model, anchors, strides = load_anchor_model("yolov5m6", device, dtype, ckpt=args.ckpt)
    print(f"yolov5m6: {count_params(model):,} params")
    size = args.img_size
    report = {} if report is None else report
    report.update(setup_s=time.perf_counter() - t0, shapes=[])
    if args.dummy or not args.data_dir:
        imgs = torch.from_numpy(
            (np.random.rand(args.batch_size, size, size, 3) * 255).astype(np.float32)).to(device)
        t0 = time.time()
        res = predict(model, anchors, strides, imgs, args.conf, args.nms)
        res.valid.cpu()
        print(f"dummy forward ok: {tuple(res.boxes.shape)} in {time.time() - t0:.1f}s")
        return args.batch_size, []

    ds = ImageFolderDataset(args.data_dir, size)
    results: List[dict] = []
    t0 = time.perf_counter()
    for imgs, infos in FolderLoader(ds, args.batch_size):
        report["shapes"].append(tuple(imgs.shape))
        res = predict(model, anchors, strides, torch.from_numpy(imgs).to(device), args.conf,
                      args.nms)
        results += answer_records(res, infos, size)
    report["serve_s"] = time.perf_counter() - t0
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} records -> {args.out}")
    return len(ds), results


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("predict_yolov5")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--img-size", type=int, default=1280)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--nms", type=float, default=0.65)
    ap.add_argument("--out", default="answersheet_yolov5.json")
    ap.add_argument("--dummy", action="store_true",
                    help="random-input smoke forward (ref predict_yolov4.py)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None,
                    help="a flax msgpack tree of the model (default: numpy seed 0 weights)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA card is visible")
    run(args)


if __name__ == "__main__":
    main()
