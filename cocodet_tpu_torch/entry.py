"""The port's programs: the counterparts of ``__graft_entry__.entry()``,
of ``bench.py``'s headline and of the train step that
``__graft_entry__.dryrun_multichip`` builds.

``entry``/``build_predictor``: YOLOX-M-P6 (depth 0.67, width 0.75) in bf16
with BN folded. ``build_headline``: the same model slimmed to the committed
channel plan ``artifacts/mp6_chain_slim_spec.json`` and quantized w8a8 with
per-input-channel activation scales (bench.py:163-187, 218-306). Both end in
the single batched postprocess at the production point: conf 0.001, NMS IoU
0.55, pre-NMS top-K 1024, ``max_det`` 300. ``Predictor`` serves batches of
NHWC float images; reading and resizing them is the data pipeline's
(``data/``). ``build_trainer``: the unfused YOLOX-P6 in train mode with f32
parameters and compute in ``dtype``, and its train step (forward, SimOTA
and losses, backward, SGD with nesterov momentum, EMA), on one device or,
given a ``parallel.Mesh``, data-parallel over the mesh's ranks.
``dryrun_multichip``: that step on n spawned ranks, on a data mesh and on
a data x space mesh. ``build_evaluator``/``evaluate``: the COCO evaluator
at the competition exp's point over a COCO-layout directory (the harness,
``python -m cocodet_tpu_torch.harness``, serves an image folder).
``train``: the training CLI (``tools/train.py``) in process: an exp, its
device-mosaic loader, the epoch loop with evaluation and checkpoints.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .compress import build_quant_tree, calibrate, load_slim_spec, quantize_weights
from .core.train_state import build_optimizer, create_train_state, make_train_step
from .data.coco import COCODataset
from .data.transforms import ValTransform
from .evaluators.coco_evaluator import COCOEvaluator
from .models.yolox import MODEL_SPECS, YOLOX, build_model
from .ops.fuse import fuse_model
from .ops.nms import NMSResult
from .ops.postprocess import PostprocessConfig, postprocess
from .parallel.launch import run_ranks
from .parallel.mesh import Mesh, make_mesh, make_mesh_2d, shard_batch
from .utils.convert import random_variables

PRODUCTION_CONFIG = PostprocessConfig(conf_threshold=0.001, nms_threshold=0.55,
                                      pre_nms_topk=1024, max_det=300)


class Predictor:
    """Serves requests: a batch of (B, H, W, 3) float images -> one
    ``NMSResult`` of (B, max_det, ...) tensors on the model's device."""

    def __init__(self, model: YOLOX, cfg: PostprocessConfig = PRODUCTION_CONFIG):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def __call__(self, images: Union[torch.Tensor, np.ndarray]) -> NMSResult:
        images = torch.as_tensor(images).to(self.device, torch.float32,
                                            non_blocking=True)
        return postprocess(self.model(images), self.model.strides, self.cfg)


def cast_parameters(model: YOLOX, dtype: torch.dtype) -> YOLOX:
    """Cast the model's parameters (kernels and biases) to ``dtype`` and make
    it the compute dtype. Buffers keep theirs: the int8 kernels and the f32
    scales of a w8a8 model. The same numbers as JAX's casts at each use."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    model.dtype = dtype
    return model


def build_predictor(variables: Mapping[str, Any], depth: float = 0.67,
                    width: float = 0.75, dtype: torch.dtype = torch.bfloat16,
                    device: Union[str, torch.device] = "cuda",
                    cfg: PostprocessConfig = PRODUCTION_CONFIG) -> Predictor:
    """The serving topology of ``harness/main.py``: a YOLOX-P6 with the given
    (unfused, flax-layout) ``variables`` loaded, BN folded, cast to
    ``dtype``."""
    model = build_model("yolox-p6", depth=depth, width=width, device=device,
                        variables=variables)
    return Predictor(cast_parameters(fuse_model(model), dtype), cfg)


SLIM_SPEC = Path(__file__).resolve().parents[1] / "artifacts" / "mp6_chain_slim_spec.json"


def build_w8a8_predictor(variables: Mapping[str, Any],
                         slim: Optional[Mapping[str, Any]] = None,
                         depth: float = 0.67, width: float = 0.75,
                         dtype: torch.dtype = torch.bfloat16,
                         device: Union[str, torch.device] = "cuda",
                         cfg: PostprocessConfig = PRODUCTION_CONFIG,
                         name: str = "yolox-p6") -> Predictor:
    """A fused YOLOX (``name``), slimmed to ``slim`` where one is given,
    built with quant="w8a8", with the quantized ``variables``
    (compress.quantize_model, or a ``tools.quantize_model`` checkpoint's
    params and ``quant`` collection) loaded, computing in ``dtype``, at the
    postprocess point ``cfg`` (by default the production point)."""
    model = build_model(name, depth=depth, width=width, fused=True,
                        slim=slim, quant="w8a8", device=device, variables=variables)
    return Predictor(cast_parameters(model, dtype), cfg)


def build_headline(spec_path: Union[str, Path] = SLIM_SPEC, depth: float = 0.67,
                   width: float = 0.75, dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device] = "cuda",
                   variables: Optional[Mapping[str, Any]] = None) -> Predictor:
    """``bench.py``'s headline: the fused YOLOX-M-P6 slimmed to the channel
    plan at ``spec_path``, with weights drawn from numpy seed 0 (or the
    given fused, slim ``variables``), calibrated in ``dtype`` on
    ``RandomState(1).rand(2, 256, 256, 3) * 255`` (bench.py:238-239),
    quantized w8a8 with per-input-channel activation scales, served in
    ``dtype``. The predictor carries ``variables`` (the quantized tree) and
    ``seconds`` (build, calibration, quantization)."""
    t0 = time.perf_counter()
    slim = load_slim_spec(str(spec_path))
    if variables is None:
        with torch.device("meta"):
            shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width,
                           fused=True, slim=slim)
        variables = random_variables(shapes, 0)
    calib = build_model("yolox-p6", depth=depth, width=width, fused=True, slim=slim,
                        quant="calib", dtype=dtype, device=device, variables=variables)
    t1 = time.perf_counter()
    images = (np.random.RandomState(1).rand(2, 256, 256, 3) * 255).astype(np.float32)
    stats = calibrate(calib, variables, [images])
    t2 = time.perf_counter()
    qvars, quant = quantize_weights(variables, build_quant_tree(stats, per_channel_act=True))
    qvars["quant"] = quant
    t3 = time.perf_counter()
    predictor = build_w8a8_predictor(qvars, slim, depth, width, dtype, device)
    predictor.variables = qvars
    predictor.seconds = {"build": t1 - t0 + time.perf_counter() - t3,
                         "calibrate": t2 - t1, "quantize": t3 - t2}
    return predictor


def entry(device: Union[str, torch.device] = "cuda") -> Tuple[Predictor, Tuple[torch.Tensor]]:
    """(fn, example_args): fused bf16 YOLOX-M-P6 forward + postprocess at
    the production point, with random weights drawn from numpy seed 0."""
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=0.67, width=0.75)
    fn = build_predictor(random_variables(shapes, 0), device=device)
    return fn, (torch.zeros((1, 256, 256, 3), dtype=torch.float32, device=device),)


# The competition exp's evaluation point (exps/p6/yolox_m_p6.py:37-39: test
# size 768, conf 0.001, NMS IoU 0.65) with the evaluator's pre-NMS top-K and
# max_det (cocodet_tpu/evaluators/coco_evaluator.py:33-37).
EVAL_SIZE = 768
EVAL_CONF = 0.001
EVAL_NMS = 0.65
EVAL_TOPK = 2000
EVAL_MAX_DET = 300


def build_evaluator(data_dir: str, img_size: int = EVAL_SIZE, batch_size: int = 16,
                    json_file: str = "instances_val2017.json", name: str = "val2017",
                    conf_threshold: float = EVAL_CONF, nms_threshold: float = EVAL_NMS,
                    pre_nms_topk: int = EVAL_TOPK, max_det: int = EVAL_MAX_DET) -> COCOEvaluator:
    """A ``COCOEvaluator`` over ``data_dir``'s ``annotations/<json_file>`` and
    ``<name>/`` images (JPEG or 8-bit PNG), letterboxed to ``img_size``
    square, at the competition exp's point."""
    dataset = COCODataset(data_dir, json_file=json_file, name=name,
                          img_size=(img_size, img_size), preproc=ValTransform())
    return COCOEvaluator(dataset, img_size=(img_size, img_size), conf_threshold=conf_threshold,
                         nms_threshold=nms_threshold, batch_size=batch_size,
                         max_det=max_det, pre_nms_topk=pre_nms_topk)


def evaluate(data_dir: str, predictor: Optional[Predictor] = None,
             device: Union[str, torch.device] = "cuda", output_json: Optional[str] = None,
             **evaluator_args) -> Tuple[float, float, str]:
    """(AP, AP50, summary) of ``predictor`` (by default the dense bf16
    YOLOX-M-P6 of ``entry()``, weights from numpy seed 0, on ``device``) on
    the COCO-layout set at ``data_dir``, through ``build_evaluator``."""
    if predictor is None:
        predictor, _ = entry(device)
    return build_evaluator(data_dir, **evaluator_args).evaluate(predictor, output_json)


def build_trainer(depth: float = 0.67, width: float = 0.75,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device] = "cuda",
                  seed: int = 0, mesh: Optional[Mesh] = None,
                  remat: bool = False, lr: float = 0.01) -> Tuple[YOLOX, Callable]:
    """(model, step): the unfused YOLOX-P6 at ``depth``/``width`` in train
    mode, f32 parameters computing in ``dtype``, weights drawn from numpy
    ``seed`` with the head's cls and obj biases at the prior 0.01, and its
    train step (``core/train_state.py::make_train_step``) with the optimizer
    of ``__graft_entry__.dryrun_multichip``: SGD at lr ``lr`` (its 0.01 by
    default) with nesterov momentum 0.9 and weight decay 5e-4 on the conv
    kernels, the EMA at
    0.9998, the iou loss, 80 classes, strides (8, 16, 32, 64). On a
    ``mesh`` (``parallel.make_mesh``, ``make_mesh_2d``) the model lives on
    the mesh's device, starts from rank 0's weights, and the step is the
    data-parallel step over the global batch. ``remat`` recomputes the
    forward in the backward (``core/train_state.py::make_forward``)."""
    if mesh is not None:
        device = mesh.device
    with torch.device("meta"):
        shapes = YOLOX(MODEL_SPECS["yolox-p6"], depth=depth, width=width)
    model = build_model("yolox-p6", depth=depth, width=width, dtype=dtype, device=device,
                        variables=random_variables(shapes, seed, prior_prob=0.01))
    state = create_train_state(model, build_optimizer(model, lr), mesh=mesh)
    return model, make_train_step(state, model.strides, num_classes=model.num_classes,
                                  mesh=mesh, remat=remat)


def _dryrun_rank(rank: int, device: torch.device) -> dict:
    """One rank of ``dryrun_multichip``: the losses of its two steps."""
    n = dist.get_world_size()
    labels = np.tile(np.asarray([[[1.0, 32.0, 32.0, 16.0, 16.0]] + [[0.0] * 5] * 9],
                                np.float32), (n, 1, 1))
    out = {}
    meshes = [("1-D", make_mesh(device), 64)]
    if n % 2 == 0:
        meshes.append(("2-D", make_mesh_2d(2, device), 256))
    for name, mesh, height in meshes:
        images = np.zeros((n, height, 64, 3), np.float32)  # one image a rank
        _, step = build_trainer(0.33, 0.125, torch.float32, seed=0, mesh=mesh)
        metrics = step(*shard_batch(mesh, (images, labels)), use_l1=True)
        out[name] = float(metrics["loss"])
    return out


def dryrun_multichip(n_devices: int, device: Union[str, torch.device] = "cuda",
                     timeout: float = 900.0) -> List[dict]:
    """``__graft_entry__.dryrun_multichip`` on ``n_devices`` ranks: the full
    data-parallel train step (gradients summed over the ranks, SGD, EMA, BN
    on the global batch) of yolox-p6 at depth 0.33, width 0.125, one 64 px
    image a rank, use_l1; then, if ``n_devices`` is even, the same step on
    the (n/2 data x 2 space) mesh at 256x64, image height sharded. Ranks on
    ``"cuda"`` share the cards when there are more ranks than cards (gloo);
    the CPU only when asked for. Returns each rank's losses."""
    results = run_ranks(_dryrun_rank, n_devices, device=device, timeout=timeout)
    for name in results[0]:
        losses = [r[name] for r in results]
        if not np.isfinite(losses[0]) or any(v != losses[0] for v in losses):
            raise RuntimeError(f"dryrun_multichip({n_devices}) {name}: the ranks' losses "
                               f"{losses} are not one finite value")
        mesh = "" if name == "1-D" else f"2-D ({n_devices // 2} data x 2 space) mesh "
        print(f"dryrun_multichip({n_devices}): {mesh}ok, loss={losses[0]:.4f}", flush=True)
    return results


def train(argv: Sequence[str], device: Union[str, torch.device] = "cuda"):
    """``python -m cocodet_tpu_torch.tools.train <argv>`` in process, on
    ``device`` (the card unless the CPU is asked for); returns the Trainer,
    whose ``epoch_stats``, ``eval_stats`` and ``ckpt_stats`` hold what the run
    measured."""
    from .tools.train import main

    return main(["--device", str(device), *argv])
