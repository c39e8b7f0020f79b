"""The submission harness (harness/main.py:133-400) on the port.

    python -m cocodet_tpu_torch.harness --config harness/config/yolox_m_p6.json [-d N]

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

Weights (harness/main.py:87-123), laid over the init leaf by leaf
(``load_matched``): a ``ckpt`` msgpack file (the JAX package's fused
deployment trees, ``{"model": {"params": ...}}`` or the bare tree) read with
the port's own reader (``utils/checkpoint.py``); a reference ``.pth`` state
dict (``utils/torch_import.py``, variant ``"p6"`` if the model's name has
it, else ``"standard"``, the model's level count; params only, the BN
statistics dropped); with ``quant: "w8a8"`` a checkpoint of
``tools.quantize_model`` (int8 params and its ``quant`` collection; one
without ``quant`` raises JAX's ``ValueError``), with or without a
``slim_spec`` on disk. The init, and the weights with no ``ckpt`` or a
``ckpt`` path that does not exist, are drawn from numpy seed 0
(``utils/convert.py::random_variables``; the JAX harness draws its own
random init and warns as the port does); ``run(variables=...)`` takes a
fused flax-layout tree instead. A checkpoint that matches no leaf of the
model raises: random weights are never served under a checkpoint's name.
``quant: "w8a8"`` with no checkpoint serves ``entry.build_headline`` where
the ``slim_spec`` exists, and otherwise, as JAX does (its w8a8 model's init
kernels are float, so its convs run in float), the float model.

``stem6`` and ``split_cat`` (harness/main.py:66-120; the latency config
``harness/config/yolox_m_p6_latency.json``) build the fused model with the
6x6 stem and the concat-free merges (``models/yolox.py``). Under ``stem6``
a checkpoint's Focus stem, msgpack and ``.pth`` alike, and a ``variables``
tree's, is rewritten by ``ops/fuse.py::fold_focus_stem``. (JAX's ``.pth``
branch loads no stem there: its imported Focus kernel matches no leaf of
the 6x6 stem, which keeps its random init; ROADMAP Queue 3.) A w8a8
checkpoint under ``stem6`` has its stem's scales re-homed too
(``fold_focus_quant``, harness/main.py:114-118); a w8a8 model with either
rewrite serves through the int8 conv kernel (its 6x6 stem, its s32 sums of
parts), bit for bit the plain graph's numbers.

Several devices (harness/main.py:162-243). JAX runs one process over every
device, the parameters replicated and the jitted program partitioned; here
a rank is a process with one device (``-d`` ranks, spawned by
``parallel/launch.py::run_ranks``, sharing a card where there are more
ranks than cards). ``data_parallel`` splits each batch (its ragged tail
padded with 114) into contiguous rows, one share a data rank;
``spatial_partition`` (``true`` or an integer S) splits each image's
height over S space ranks, which run the forward under ``use_mesh`` (the
convs and the SPP exchange halos) and gather the head maps before the
postprocess; both together are a (n/S data, S space) mesh. A batch's
height splits in whole rows of the deepest map, as evenly as they go (the
shares may differ by one row); a batch whose deepest map has fewer rows
than the space ranks runs whole on each of them. JAX's checks of the
modes, with its messages, run before the first batch. Rank 0 gathers the
records in batch order, writes the JSON and scores it; each rank's phase
seconds are printed on rank 0. A config with neither mode runs one rank.
A w8a8 model shards its height too: each int8 conv takes its rank's rows
with their halo rows and writes its own output rows. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .compress import load_slim_spec
from .data.coco import COCO_CLASS_ID
from .data.folder import FolderLoader, ImageFolderDataset
from .entry import (Predictor, build_headline, build_w8a8_predictor, cast_parameters,
                    fold_w8a8_stem)
from .evaluators.coco_metric import COCOMeanAP
from .models.darknet import _FOCUS_ORDER
from .models.yolox import MODEL_SPECS, YOLOX, build_model
from .ops.fuse import fold_focus_quant, fold_focus_stem
from .ops.postprocess import PostprocessConfig, postprocess
from .parallel import collectives
from .parallel.collectives import gather_rows
from .parallel.launch import run_ranks
from .parallel.mesh import Mesh, make_mesh, make_mesh_2d, use_mesh
from .utils.checkpoint import load_checkpoint, load_matched
from .utils.convert import flatten_tree, jax_layout, random_variables
from .utils.metric import Timer
from .utils.torch_import import load_torch_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME_MAP = {"yolox": "yolox", "yolox-dw": "yolox-dw", "yolox-m-p6": "yolox-p6",
            "yolox-m-p6-pr": "yolox-p6", "yolox-p6": "yolox-p6", "yolox-p6-v2": "yolox-p6v2"}


def count_params(model: torch.nn.Module) -> int:
    """The leaves of the model's flax ``params`` (a w8a8 model's int8
    kernels, which are buffers here, included), as JAX's harness counts."""
    return sum(int(np.prod(shape)) for path, shape in jax_layout(model).items()
               if path[0] == "params")


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


def model_name(cfg: Mapping[str, Any]) -> str:
    """The config's model type as a MODEL_SPECS key; an unknown type is
    ``yolox-p6``, as harness/main.py:55-58 maps it."""
    return NAME_MAP.get(cfg["model"].get("type", "yolox-p6"), "yolox-p6")


def _shapes(name: str, depth: float, width: float, slim, quant=None,
            stem6: bool = False) -> torch.nn.Module:
    """The fused model on the meta device: the init's leaves and shapes."""
    with torch.device("meta"):
        return YOLOX(MODEL_SPECS[name], depth=depth, width=width, fused=True, slim=slim,
                     quant=quant, stem6=stem6)


def _fold_stem(params: Mapping[str, Any], name: str) -> Dict[str, Any]:
    """``params`` with its Focus stem as the 6x6 conv of a ``stem6`` model
    (``fold_focus_stem``, in the model's channel order); a tree that has
    the 6x6 stem already passes as it is."""
    if ("backbone", "backbone", "stem", "conv", "conv", "kernel") not in flatten_tree(params):
        return dict(params)
    return fold_focus_stem(params, order=_FOCUS_ORDER[MODEL_SPECS[name].variant])


def load_ckpt_variables(path: str, init: Mapping[str, Any], name: str = "yolox-p6",
                        quant: Optional[str] = None, stem6: bool = False) -> Dict[str, Any]:
    """harness/main.py:87-123: the checkpoint's params laid over ``init``'s
    with ``load_matched``, the Focus stem folded for a ``stem6`` model; for
    ``quant="w8a8"`` with the checkpoint's ``quant`` collection beside
    them."""
    if path.endswith(".pth"):
        if quant:
            raise ValueError(f"config asks for quant={quant!r} but {path} is a float "
                             "reference state dict: produce a w8a8 checkpoint with "
                             "cocodet_tpu_torch.tools.quantize_model")
        tree = load_torch_checkpoint(path, variant="p6" if "p6" in name else "standard",
                                     num_levels=len(MODEL_SPECS[name].strides))
    else:
        loaded = load_checkpoint(path)
        tree = loaded.get("model", loaded)
    params = tree.get("params", tree)
    if stem6:
        params = _fold_stem(params, name)
    if not set(flatten_tree(params)) & set(flatten_tree(init["params"])):
        raise ValueError(f"{path}: the checkpoint matches no parameter of the model")
    variables = {"params": load_matched(init["params"], params)}
    if quant == "w8a8":
        if "quant" not in tree:
            raise ValueError(f"config asks for quant={quant!r} but {path} has no 'quant' "
                             "collection — produce one with "
                             "cocodet_tpu_torch.tools.quantize_model")
        variables["quant"] = (fold_focus_quant(tree["quant"]) if stem6 and _focus_quant(tree)
                              else tree["quant"])
    return variables


def _focus_quant(tree: Mapping[str, Any]) -> bool:
    """Whether a tree's ``quant`` collection has the Focus stem's scales."""
    return ("backbone", "backbone", "stem", "conv", "conv", "w_scale") in flatten_tree(
        tree.get("quant", {}))


def build_predictor_from_config(cfg: Mapping[str, Any], variables=None,
                                device: Union[str, torch.device] = "cuda") -> Predictor:
    """The model of harness/main.py:36-130 by type string, served at the
    config's postprocess point. ``variables``: a fused flax-layout tree (for
    ``quant: "w8a8"`` a quantized one, or the float init a checkpoint is
    laid over); without one, weights from numpy seed 0. ``stem6`` and
    ``split_cat`` build the deployment rewrites, a ``variables`` tree's
    Focus stem folded to the 6x6 conv."""
    name = model_name(cfg)
    stem6, split_cat = bool(cfg.get("stem6", False)), bool(cfg.get("split_cat", False))
    mcfg = cfg["model"]
    depth, width = float(mcfg.get("depth", 0.67)), float(mcfg.get("width", 0.75))
    dtype = torch.bfloat16 if cfg.get("half", True) else torch.float32
    spec = cfg.get("slim_spec")
    spec = spec if spec and os.path.exists(spec) else None
    slim = load_slim_spec(spec) if spec else None
    quant = cfg.get("quant")
    if quant not in (None, "w8a8"):
        raise ValueError(f"the harness serves quant=None or 'w8a8', not {quant!r}")
    if variables is not None and stem6:
        variables = (fold_w8a8_stem(variables, name) if _focus_quant(variables) else
                     dict(variables, params=_fold_stem(variables["params"], name)))
    ppcfg = postprocess_config(cfg)
    ckpt = cfg.get("ckpt")
    if ckpt and os.path.exists(ckpt):
        if variables is None:
            variables = random_variables(_shapes(name, depth, width, slim, quant, stem6), 0)
        variables = load_ckpt_variables(ckpt, variables, name, quant, stem6)
        print(f"loaded checkpoint {ckpt}")
    elif variables is None:
        print("WARNING: no checkpoint — random weights (dummy-quality output)")
        if quant == "w8a8" and spec is not None and name == "yolox-p6":
            headline = build_headline(spec, depth, width, dtype, device, stem6=stem6,
                                      split_cat=split_cat)
            predictor = Predictor(headline.model, ppcfg)
            print(f"# params: {count_params(predictor.model):,}")
            return predictor
        quant = None  # JAX's w8a8 init has float kernels: its convs run in float
    if quant == "w8a8" and "quant" in variables:
        predictor = build_w8a8_predictor(variables, slim, depth, width, dtype, device, ppcfg,
                                         name=name, stem6=stem6, split_cat=split_cat)
    else:
        if variables is None:
            variables = random_variables(_shapes(name, depth, width, slim, stem6=stem6), 0)
        model = build_model(name, depth=depth, width=width, fused=True, slim=slim,
                            device=device, variables=variables, stem6=stem6,
                            split_cat=split_cat)
        predictor = Predictor(cast_parameters(model, dtype), ppcfg)
    print(f"# params: {count_params(predictor.model):,}")
    return predictor


def image_id_of(name: str):
    """The COCO image id of a file name: its digits, or the name itself."""
    return (int(os.path.splitext(name)[0].lstrip("0") or 0)
            if name.split(".")[0].isdigit() else name)


def batch_records(img_size: int, result, infos) -> List[dict]:
    """COCO records of one batch's detections (harness/main.py:269-310):
    ``result`` is (boxes, scores, classes, valid) as numpy arrays, one row an
    image of ``infos`` ((h, w, file name) each); boxes scaled back in float64
    and rounded to 2 decimals, scores to 5, a dummy record for an image
    without detections. Whole-batch numpy, one .tolist() per field."""
    boxes, scores, classes, valid = result
    coco_id = np.asarray(COCO_CLASS_ID, np.int64)
    records: List[dict] = []
    for i, (h, w, name) in enumerate(infos):
        scale = min(img_size / h, img_size / w)
        image_id = image_id_of(name)
        nv = int(valid[i].sum())  # valid dets are prefix-packed
        if nv == 0:
            records.append({"image_id": image_id, "category_id": 1,
                            "bbox": [0.0, 0.0, 0.0, 0.0], "score": 0.0, "segmentation": []})
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
            records.append({"image_id": image_id, "category_id": c, "bbox": bb, "score": s,
                            "segmentation": []})
    return records


# --------------------------------------------------------------------------
# serving on several ranks
# --------------------------------------------------------------------------


def serving_modes(cfg: Mapping[str, Any], n: int, max_stride: int) -> Tuple[bool, int]:
    """harness/main.py:186-229's checks on ``n`` devices (ranks), with its
    messages: (data_parallel, S), S the space ranks (0: none)."""
    dp = bool(cfg.get("data_parallel", False))
    sp_cfg = cfg.get("spatial_partition", False)
    sp_n = (-1 if isinstance(sp_cfg, bool) else int(sp_cfg)) if sp_cfg else 0
    if not (dp or sp_n):
        return False, 0
    bsz = int(cfg["dataloader"]["batch_size"])
    if sp_n > 0 and (sp_n <= 1 or sp_n > n or n % sp_n or max_stride % sp_n):
        raise ValueError(
            f"spatial_partition={sp_n}: need an integer in (1, {n}] dividing both the "
            f"device count {n} and the max stride {max_stride} (aspect-bucket heights "
            f"are multiples of {max_stride})")
    if dp and sp_n:
        if sp_n < 0:
            raise ValueError("combined data_parallel + spatial_partition needs "
                             "spatial_partition set to an integer >1 (a bare true does "
                             "not define the 2-D split)")
        rows = n // sp_n
        if bsz % rows:
            raise ValueError(f"data_parallel: batch_size {bsz} must be a multiple of the "
                             f"{rows} data rows of the ({rows}, {sp_n}) mesh")
    elif dp and bsz % n:
        raise ValueError(f"data_parallel: batch_size {bsz} must be a multiple of the "
                         f"device count {n}")
    return dp, (n if sp_n < 0 else sp_n)


def serving_ranks(cfg: Mapping[str, Any], n: int) -> int:
    """The ranks a config runs on ``n`` devices: all of them with
    ``data_parallel``, the S space ranks of ``spatial_partition`` alone (JAX
    takes S of the devices), one with neither mode."""
    dp, space = serving_modes(cfg, n, max(MODEL_SPECS[model_name(cfg)].strides))
    return n if dp else (space or 1)


def serving_mesh(cfg: Mapping[str, Any], device: torch.device) -> Mesh:
    """This rank's mesh for the config (called by every rank of the group)."""
    n = dist.get_world_size()
    dp, space = serving_modes(cfg, n, max(MODEL_SPECS[model_name(cfg)].strides))
    return make_mesh_2d(space, device) if space else make_mesh(device)


def height_units(height: int, max_stride: int, n_space: int) -> Optional[Tuple[int, ...]]:
    """Each space rank's rows of the deepest map of a batch ``height`` rows
    high, split as evenly as whole rows go; None where there are fewer rows
    than ranks (the batch then runs whole on each)."""
    rows = height // max_stride
    if rows < n_space:
        return None
    return tuple(rows // n_space + (q < rows % n_space) for q in range(n_space))


def run(cfg: Dict[str, Any], out_path: str, profile: bool = False, challenge: bool = False,
        dummy: bool = False, variables=None, device: Union[str, torch.device] = "cuda",
        report: Optional[dict] = None, mesh: Optional[Mesh] = None) -> List[dict]:
    """harness/main.py::run on the port; returns the records it wrote (on
    rank 0 of a ``mesh``; the other ranks return []). ``report``, if given,
    receives the phase seconds, the serving loop's wall seconds, the batch
    shapes, the image count, the self-evaluation's stats and, on a mesh,
    every rank's phase and loop seconds and host seconds in collectives."""
    timer = Timer()
    predictor = build_predictor_from_config(cfg, variables, mesh.device if mesh else device)
    model, ppcfg, device = predictor.model, predictor.cfg, predictor.device
    strides = model.strides
    max_stride = max(strides)
    aug = cfg.get("input_aug", True)
    bsz = int(cfg["dataloader"]["batch_size"])
    dp, _ = serving_modes(cfg, mesh.size if mesh else 1, max_stride)
    n_data, d_index = (mesh.n_data, mesh.data_index) if mesh else (1, 0)
    space = mesh.space if mesh else None
    rank0 = mesh is None or dist.get_rank() == 0
    converts = mesh is None or mesh.space_index == 0

    @torch.inference_mode()
    def step(images: torch.Tensor, units):
        if aug:
            images = images * 0.9 + 11.4  # contrast TTA (harness/main.py:246-251)
        if space is None or units is None:
            return postprocess(model(images), strides, ppcfg)
        with use_mesh(mesh, units):
            outputs = model(images)
        outputs = [{k: gather_rows(v, space, dim=1,
                                   sizes=[u * (max_stride // s) for u in units])
                    for k, v in level.items()} for level, s in zip(outputs, strides)]
        return postprocess(outputs, strides, ppcfg)

    def to_device(batch: np.ndarray):
        """This rank's share of a host batch on its device (the copy from
        pageable host memory, as Predictor's), and its height units."""
        if dp and batch.shape[0] < bsz:  # ragged tail -> pad (dets unread)
            batch = np.concatenate([batch, np.full((bsz - batch.shape[0],) + batch.shape[1:],
                                                   114.0, batch.dtype)])
        per = batch.shape[0] // n_data
        batch = batch[d_index * per:(d_index + 1) * per]
        units = None
        if space is not None:
            units = height_units(batch.shape[1], max_stride, mesh.n_space)
            if units is not None:
                first = sum(units[:mesh.space_index]) * max_stride
                batch = batch[:, first:first + units[mesh.space_index] * max_stride]
        tensor = torch.from_numpy(np.ascontiguousarray(batch))
        return tensor.to(device, torch.float32, non_blocking=True), units

    timer.toc("setup")

    results: List[dict] = []
    if challenge:
        results.append({"framework": "cocodet_tpu_torch(pytorch/cuda)",
                        "parameters": count_params(model)})

    if dummy:
        imgs = np.random.rand(bsz, cfg["img_size"], cfg["img_size"], 3) * 255
        res = step(*to_device(imgs.astype(np.float32)))
        if rank0:
            print("dummy forward ok:", tuple(res.boxes.shape))
        return []

    if cfg["img_size"] % max_stride != 0:
        raise ValueError(f"img_size {cfg['img_size']} must be a multiple of the model's "
                         f"max stride {max_stride} (P6 upsample/concat shapes)")
    dataset = ImageFolderDataset(cfg["data_dir"], cfg["img_size"],
                                 exposure_norm=bool(cfg.get("exposure_norm", False)))
    loader = FolderLoader(dataset, bsz, pad_multiple=max_stride)

    warm = np.full((bsz, cfg["img_size"], cfg["img_size"], 3), 114.0, np.float32)
    step(*to_device(warm)).valid.cpu()
    timer.toc("warmup")
    collectives.reset_counts()

    n_img = 0
    shapes: List[tuple] = []
    per_batch: List[List[dict]] = []  # this rank's records, batch by batch

    def drain(res, infos):
        """Host-side conversion of this rank's rows of one finished batch."""
        nonlocal n_img
        timer.tic()
        boxes, scores, classes, valid = (t.cpu().numpy() for t in (
            res.boxes, res.scores, res.classes, res.valid))
        timer.toc("forward+nms")  # the copy to host memory waits for the card
        n_img += len(infos)
        records: List[dict] = []
        per_batch.append(records)
        if not converts:  # a space rank > 0 holds the same detections
            return
        first = d_index * boxes.shape[0]
        records.extend(batch_records(cfg["img_size"], (boxes, scores, classes, valid),
                                     infos[first:first + boxes.shape[0]]))
        timer.toc("convert")

    # software-pipelined: while batch k computes on the card, batch k-1's
    # results convert on the host
    pending = None
    t_loop = time.perf_counter()
    for imgs, infos in loader:
        timer.tic()
        batch, units = to_device(imgs)
        timer.toc("h2d")
        shapes.append(tuple(imgs.shape))
        res = step(batch, units)  # queued on the card: no wait here
        if pending is not None:
            drain(*pending)
        pending = (res, infos)
    if pending is not None:
        drain(*pending)
    loop_s = time.perf_counter() - t_loop  # the batches' wall time, copy to records

    phases = {k: m.total for k, m in timer.meters.items()}
    ranks = None
    if mesh is None:
        parts = [per_batch]
    else:  # every rank's records to rank 0, in batch order
        timer.tic()
        mine = {"records": per_batch, "phases": phases, "loop_s": loop_s,
                "collective_s": dict(collectives.host_seconds),
                "collectives": dict(collectives.calls)}
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        timer.toc("gather")
        parts = [g["records"] for r, g in enumerate(gathered) if r % mesh.n_space == 0]
        ranks = [{k: g[k] for k in ("phases", "loop_s", "collective_s", "collectives")}
                 for g in gathered]
    if not rank0:
        return []
    for b in range(len(per_batch)):
        for part in parts:
            results.extend(part[b])

    with open(out_path, "w") as f:
        json.dump(results, f)
    timer.toc("json")
    print(f"wrote {len(results)} records for {n_img} images -> {out_path}")

    distinct = sorted(set(shapes))
    if profile:
        for name, meter in timer.meters.items():
            print(f"  {name:12s}: total {meter.total:.3f}s")
        print(f"  batch shapes: {len(distinct)} distinct of {len(shapes)} batches: {distinct}")
        for r, info in enumerate(ranks or []):
            secs = ", ".join(f"{k} {v:.3f}s" for k, v in info["phases"].items())
            print(f"  rank {r}: {secs}; loop {info['loop_s']:.3f}s; collectives "
                  f"{sum(info['collective_s'].values()):.3f}s")

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
        report.update(phases={k: m.total for k, m in timer.meters.items()}, loop_s=loop_s,
                      shapes=shapes, images=n_img, stats=stats, ranks=ranks)
    return results


def _serve_rank(rank: int, device: torch.device, cfg: Dict[str, Any], out_path: str,
                flags: Dict[str, bool]) -> Optional[dict]:
    """One rank of ``main``: the harness on this rank's mesh; rank 0 hands
    back its report."""
    report: dict = {}
    run(cfg, out_path, mesh=serving_mesh(cfg, device), report=report, **flags)
    return report if rank == 0 else None


def serve(cfg: Dict[str, Any], out_path: str, devices: int = 1,
          device: Union[str, torch.device] = "cuda", timeout: Optional[float] = None,
          **flags) -> dict:
    """``run`` on ``devices`` ranks as the config's modes take them (one
    without ``data_parallel`` or ``spatial_partition``); returns rank 0's
    report."""
    ranks = serving_ranks(cfg, devices)
    if ranks == 1 and not (cfg.get("data_parallel") or cfg.get("spatial_partition")):
        report: dict = {}
        run(cfg, out_path, device=device, report=report, **flags)
        return report
    return run_ranks(_serve_rank, ranks, cfg, out_path, flags, device=device,
                     timeout=timeout)[0]


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
    ap.add_argument("-d", "--devices", type=int, default=None,
                    help="ranks on this host for data_parallel / spatial_partition "
                         "(default: every visible card; 1 with --device cpu)")
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
    devices = args.devices or (1 if args.device == "cpu" else torch.cuda.device_count())
    if devices < 1:
        raise RuntimeError("--device cuda but no CUDA card is visible")

    t0 = time.time()
    serve(cfg, args.out, devices, args.device, profile=args.profile,
          challenge=args.challenge, dummy=args.dummy)
    print(f"total time: {time.time() - t0:.2f}s")


if __name__ == "__main__":
    main()
