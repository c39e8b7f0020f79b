"""The submission harness (harness/main.py:133-400) on the port.

    python -m cocodet_tpu_torch.harness --config harness/config/yolox_m_p6.json

A JSON config (``harness/config/*.json``) with CLI overrides; the model
built by type string; a warm-up batch; then an image folder served in
aspect-ratio buckets (``data/folder.py``: each batch padded with 114 to
multiples of 64 up to ``img_size``), the contrast TTA ``x * 0.9 + 11.4`` on
the device, forward and postprocess on the device, and each finished batch
converted to COCO records on the host while the next one computes. The
records (boxes scaled back in float64 and rounded to 2 decimals, scores to
5; image ids from digit file names; a dummy record for an image without
detections) go to one JSON file, optionally after a ``--challenge`` header;
``--profile`` prints the seconds of each phase and the batch shapes; with an
``annotation`` file, the harness scores itself.

Weights: a ``ckpt`` msgpack file (the JAX package's fused deployment
trees, ``{"model": {"params": ...}}`` or the bare tree) is read with the
port's own reader (``utils/checkpoint.py``) and laid over the init leaf by
leaf (``load_matched``, harness/main.py:96-104). The init, and the weights
with no ``ckpt`` or a ``ckpt`` path that does not exist, are drawn from
numpy seed 0 (``utils/convert.py::random_variables``; the JAX harness
draws its own random init and warns as the port does);
``run(variables=...)`` takes a fused flax-layout tree instead. A checkpoint
that matches no leaf of the model raises: random weights are never served
under a checkpoint's name. ``.pth`` state dicts, w8a8 checkpoints (their
``quant`` collection) and ``stem6`` raise. ``quant: "w8a8"`` with an
existing ``slim_spec`` and no checkpoint serves ``entry.build_headline``;
``split_cat``, w8a8 without a slim spec, soft-NMS and the multi-chip
serving modes raise. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .compress import load_slim_spec
from .data.coco import COCO_CLASS_ID
from .data.folder import FolderLoader, ImageFolderDataset
from .entry import Predictor, build_headline, cast_parameters
from .evaluators.coco_metric import COCOMeanAP
from .models.yolox import MODEL_SPECS, YOLOX, build_model
from .ops.postprocess import PostprocessConfig, postprocess
from .utils.checkpoint import load_checkpoint, load_matched
from .utils.convert import flatten_tree, random_variables
from .utils.metric import Timer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME_MAP = {"yolox": "yolox", "yolox-dw": "yolox-dw", "yolox-m-p6": "yolox-p6",
            "yolox-m-p6-pr": "yolox-p6", "yolox-p6": "yolox-p6", "yolox-p6-v2": "yolox-p6v2"}
CKPT_TODO = "is not ported (ROADMAP Queue 1 item 5)"


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def postprocess_config(cfg: Mapping[str, Any]) -> PostprocessConfig:
    """harness/main.py:148-160: the config's postprocess section with the
    harness's defaults (NMS 0.55, pre-NMS top-K 2048)."""
    pp = cfg.get("postprocess", {})
    return PostprocessConfig(
        conf_threshold=float(pp.get("conf_threshold", 0.001)),
        nms_threshold=float(pp.get("nms_threshold", 0.55)),
        multi_class=bool(pp.get("multi_class", False)),
        soft=bool(pp.get("soft", False)),
        rmmop=tuple(pp["rmmop"]) if pp.get("rmmop") else None,
        pre_nms_topk=int(pp.get("max_num_nms", 2048)),
        max_det=int(pp.get("max_num_det", 300)),
    )


def _shapes(name: str, depth: float, width: float, spec: Optional[str]) -> torch.nn.Module:
    """The fused model on the meta device: the init's leaves and shapes."""
    slim = load_slim_spec(spec) if spec else None
    with torch.device("meta"):
        return YOLOX(MODEL_SPECS[name], depth=depth, width=width, fused=True, slim=slim)


def load_ckpt_variables(path: str, init: Mapping[str, Any]) -> Dict[str, Any]:
    """harness/main.py:96-104: the checkpoint's ``model`` tree (or the file's
    tree) laid over ``init``'s params with ``load_matched``."""
    loaded = load_checkpoint(path)
    tree = loaded.get("model", loaded)
    params = tree.get("params", tree)
    if not set(flatten_tree(params)) & set(flatten_tree(init["params"])):
        raise ValueError(f"{path}: the checkpoint matches no parameter of the model")
    return {**init, "params": load_matched(init["params"], params)}


def build_predictor_from_config(cfg: Mapping[str, Any], variables=None,
                                device: Union[str, torch.device] = "cuda") -> Predictor:
    """The model of harness/main.py:36-130 by type string, served at the
    config's postprocess point. ``variables``: a fused flax-layout tree;
    without one, weights from numpy seed 0."""
    for key in ("stem6", "split_cat", "data_parallel", "spatial_partition"):
        if cfg.get(key):
            raise NotImplementedError(f"harness config {key}={cfg[key]!r} is not ported")
    if postprocess_config(cfg).soft:
        raise NotImplementedError("soft-NMS is not ported (ROADMAP Queue 1 item 5)")
    mcfg = cfg["model"]
    name = NAME_MAP.get(mcfg.get("type", "yolox-p6"), "yolox-p6")
    if name not in MODEL_SPECS:
        raise NotImplementedError(f"model {name!r} is not ported")
    depth, width = float(mcfg.get("depth", 0.67)), float(mcfg.get("width", 0.75))
    dtype = torch.bfloat16 if cfg.get("half", True) else torch.float32
    spec = cfg.get("slim_spec")
    spec = spec if spec and os.path.exists(spec) else None
    quant = cfg.get("quant")
    ckpt = cfg.get("ckpt")
    if ckpt and os.path.exists(ckpt):
        if ckpt.endswith(".pth"):
            raise NotImplementedError(f"{ckpt}: loading a .pth state dict {CKPT_TODO}")
        if quant:
            raise NotImplementedError(f"{ckpt}: loading a {quant} checkpoint (its quant "
                                      f"collection) {CKPT_TODO}")
        if variables is None:
            variables = random_variables(_shapes(name, depth, width, spec), 0)
        variables = load_ckpt_variables(ckpt, variables)
        print(f"loaded checkpoint {ckpt}")
    elif variables is None:
        print("WARNING: no checkpoint — random weights (dummy-quality output)")
    if quant == "w8a8" and spec is not None and name == "yolox-p6":
        predictor = build_headline(spec, depth, width, dtype, device, variables)
        predictor = Predictor(predictor.model, postprocess_config(cfg))
    elif quant:
        raise NotImplementedError(f"quant={quant!r} without a slim spec on disk is not "
                                  "ported: the port builds w8a8 only through entry.build_headline")
    else:
        slim = load_slim_spec(spec) if spec else None
        if variables is None:
            variables = random_variables(_shapes(name, depth, width, spec), 0)
        model = build_model(name, depth=depth, width=width, fused=True, slim=slim,
                            device=device, variables=variables)
        predictor = Predictor(cast_parameters(model, dtype), postprocess_config(cfg))
    print(f"# params: {count_params(predictor.model):,}")
    return predictor


def image_id_of(name: str):
    """The COCO image id of a file name: its digits, or the name itself."""
    return (int(os.path.splitext(name)[0].lstrip("0") or 0)
            if name.split(".")[0].isdigit() else name)


def run(cfg: Dict[str, Any], out_path: str, profile: bool = False, challenge: bool = False,
        dummy: bool = False, variables=None, device: Union[str, torch.device] = "cuda",
        report: Optional[dict] = None) -> List[dict]:
    """harness/main.py::run on the port; returns the records it wrote.
    ``report``, if given, receives the phase seconds, the batch shapes, the
    image count and the self-evaluation's stats."""
    timer = Timer()
    predictor = build_predictor_from_config(cfg, variables, device)
    model, ppcfg, device = predictor.model, predictor.cfg, predictor.device
    strides = model.strides
    aug = cfg.get("input_aug", True)
    bsz = int(cfg["dataloader"]["batch_size"])

    @torch.inference_mode()
    def step(images: torch.Tensor):
        if aug:
            images = images * 0.9 + 11.4  # contrast TTA (harness/main.py:246-251)
        return postprocess(model(images), strides, ppcfg)

    def to_device(batch: np.ndarray) -> torch.Tensor:
        # as Predictor copies: from pageable host memory
        return torch.from_numpy(batch).to(device, torch.float32, non_blocking=True)

    timer.toc("setup")

    results: List[dict] = []
    if challenge:
        results.append({"framework": "cocodet_tpu_torch(pytorch/cuda)",
                        "parameters": count_params(model)})

    if dummy:
        imgs = np.random.rand(bsz, cfg["img_size"], cfg["img_size"], 3) * 255
        res = step(to_device(imgs.astype(np.float32)))
        print("dummy forward ok:", tuple(res.boxes.shape))
        return []

    max_stride = max(strides)
    if cfg["img_size"] % max_stride != 0:
        raise ValueError(f"img_size {cfg['img_size']} must be a multiple of the model's "
                         f"max stride {max_stride} (P6 upsample/concat shapes)")
    dataset = ImageFolderDataset(cfg["data_dir"], cfg["img_size"],
                                 exposure_norm=bool(cfg.get("exposure_norm", False)))
    loader = FolderLoader(dataset, bsz, pad_multiple=max_stride)

    warm = np.full((bsz, cfg["img_size"], cfg["img_size"], 3), 114.0, np.float32)
    step(to_device(warm)).valid.cpu()
    timer.toc("warmup")

    n_img = 0
    shapes: List[tuple] = []
    coco_id = np.asarray(COCO_CLASS_ID, np.int64)

    def drain(res, infos):
        """Host-side conversion of one finished batch (harness/main.py:
        269-310): whole-batch numpy, one .tolist() per field."""
        nonlocal n_img
        timer.tic()
        boxes, scores, classes, valid = (t.cpu().numpy() for t in (
            res.boxes, res.scores, res.classes, res.valid))
        timer.toc("forward+nms")  # the copy to host memory waits for the card
        for i, (h, w, name) in enumerate(infos):
            scale = min(cfg["img_size"] / h, cfg["img_size"] / w)
            image_id = image_id_of(name)
            nv = int(valid[i].sum())  # valid dets are prefix-packed
            if nv == 0:
                results.append({"image_id": image_id, "category_id": 1,
                                "bbox": [0.0, 0.0, 0.0, 0.0], "score": 0.0,
                                "segmentation": []})
                n_img += 1
                continue
            b = boxes[i, :nv].astype(np.float64) / scale
            x1 = np.clip(b[:, 0], 0, w)
            y1 = np.clip(b[:, 1], 0, h)
            bw = np.clip(b[:, 2], 0, w) - x1
            bh = np.clip(b[:, 3], 0, h) - y1
            xywh = np.round(np.stack([x1, y1, bw, bh], 1), 2).tolist()
            sc = np.round(scores[i, :nv].astype(np.float64), 5).tolist()
            cat = coco_id[classes[i, :nv].astype(np.int64)].tolist()
            for bb, s, c in zip(xywh, sc, cat):
                results.append({"image_id": image_id, "category_id": c, "bbox": bb,
                                "score": s, "segmentation": []})
            n_img += 1
        timer.toc("convert")

    # software-pipelined: while batch k computes on the card, batch k-1's
    # results convert on the host
    pending = None
    for imgs, infos in loader:
        timer.tic()
        batch = to_device(imgs)
        timer.toc("h2d")
        shapes.append(tuple(batch.shape))
        res = step(batch)  # queued on the card: no wait here
        if pending is not None:
            drain(*pending)
        pending = (res, infos)
    if pending is not None:
        drain(*pending)

    with open(out_path, "w") as f:
        json.dump(results, f)
    timer.toc("json")
    print(f"wrote {len(results)} records for {n_img} images -> {out_path}")

    distinct = sorted(set(shapes))
    if profile:
        for name, meter in timer.meters.items():
            print(f"  {name:12s}: total {meter.total:.3f}s")
        print(f"  batch shapes: {len(distinct)} distinct of {len(shapes)} batches: {distinct}")

    stats = None
    ann = cfg.get("annotation")
    if ann and os.path.exists(ann):
        with open(ann) as f:
            gt = json.load(f)
        # a file-name image id is looked up in the annotations' file names,
        # as score_detections_json does (JAX's harness sorts it among ints)
        name_to_id = {im["file_name"]: im["id"] for im in gt["images"]}
        metric = COCOMeanAP()
        metric.add_gt_annotations(gt["annotations"])
        metric.add_detections([
            dict(r, image_id=name_to_id.get(r["image_id"], -1))
            if isinstance(r["image_id"], str) else r
            for r in results if "bbox" in r and r["score"] > 0])
        stats = metric.summarize(verbose=True)
        print(f"mAP@0.5 = {stats['AP50']:.4f}")
    if report is not None:
        report.update(phases={k: m.total for k, m in timer.meters.items()},
                      shapes=shapes, images=n_img, stats=stats)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser("cocodet_tpu_torch submission harness")
    ap.add_argument("--config", default=os.path.join(REPO, "harness", "config",
                                                     "yolox_m_p6.json"))
    ap.add_argument("--out", default="answersheet_4_04_cocodet.json")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--challenge", action="store_true")
    ap.add_argument("--dummy", action="store_true")
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with open(args.config) as f:
        cfg = json.load(f)
    # CLI overrides (harness/main.py:385-392)
    if args.img_size:
        cfg["img_size"] = args.img_size
    if args.ckpt:
        cfg["ckpt"] = args.ckpt
    if args.data_dir:
        cfg["data_dir"] = args.data_dir
    if args.batch_size:
        cfg["dataloader"]["batch_size"] = args.batch_size

    t0 = time.time()
    run(cfg, args.out, profile=args.profile, challenge=args.challenge, dummy=args.dummy,
        device=args.device)
    print(f"total time: {time.time() - t0:.2f}s")


if __name__ == "__main__":
    main()
