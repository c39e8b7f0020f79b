"""The epoch and iteration runtime (cocodet_tpu/core/trainer.py::Trainer).

``train``: ``before_train`` (model, loader, schedule, optimizer, state, an
init checkpoint, resume, evaluator, the multiscale stream, the prefetcher),
then per epoch ``before_epoch`` (the no-aug switch: close the mosaic, the L1
loss on, evaluate every epoch), ``train_in_iter`` (a multiscale bucket drawn
every 10 global iterations, the batch and its labels resized to it, the
train step of ``core/train_state.py``) and ``after_epoch`` (the latest
checkpoint, the evaluation of the EMA weights and its checkpoint).

The batch arrives from ``data/samplers.py::DevicePrefetcher``: on the host
mosaic path (the default) as float32 images and padded labels, composed and
transformed on the loader's threads (``data/mosaic.py``); with
``device_mosaic`` as raw buffers, preprocessed on the card
(``data/device_aug.py::apply_device_preproc``: CUDA kernels K1-K4 and the
label math). Metrics are read back only every ``print_interval``
iterations; each step's losses are checked for finite values on the card
and the count is read once an epoch. Each epoch's numbers (iterations,
trained img/s by the host clock with the data included, the step's and the
input kernels' device ms, the wait for data, the multiscale sizes, peak
memory) are kept in ``epoch_stats``, each checkpoint's in ``ckpt_stats``.

Checkpoints are JAX's msgpack trees (``utils/checkpoint.py``). A masked
model (``exp.use_mask``, or an init checkpoint whose ``model`` carries a
``masks`` collection, a Pruner's output) is built with its ChannelMask
gates (trainer.py:74-117); the gates stay fixed, are loaded from the init
checkpoint (its leaves the model lacks dropped, as ``load_matched`` does)
and go into the evaluated and saved ``model`` variables (:376-383).

``num_accumulate > 1`` wraps the optimizer in ``multi_steps``
(``optax.MultiSteps``, trainer.py:106-110); ``remat`` recomputes the
forward in the backward (``core/train_state.py::make_forward``).

Several ranks. When ``torch.distributed`` is up with more than one rank,
each rank is one process with one device, and the trainer trains on the
``Mesh`` of them (trainer.py:154-219): a data mesh, or a (data x space)
mesh with ``exp.spatial_devices > 1``. The global batch is ``batch_size``
whatever the number of ranks: every rank runs the single-process sampler
and item-seed stream and fetches only its data row's contiguous slice of
each batch; the space ranks of a row fetch and preprocess the same slice
and each keeps its rows of the images (JAX's reshard, :339-350), after the
multiscale resize. So the ranks train on the images one process would.
Rank 0 writes the checkpoints and the TensorBoard scalars, a barrier after
each save (:395-407); every rank loads ``resume`` and ``init_ckpt``, then
rank 0's state is broadcast. The evaluation is sharded over every rank, its
records gathered and scored on rank 0 (``evaluators/coco_evaluator.py``).
A batch the data rows do not divide raises before the first step: JAX
shrinks its mesh to the gcd (:206-210), but a rank is a process that cannot
drop out. ``spatial_devices > 1`` on one rank trains unsharded, with JAX's
warning (:172-178). The Pruner, the distilling Tuner and SynFlow train on
the same meshes (their modules say how).
"""

from __future__ import annotations

import hashlib
import os
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.device_aug import apply_device_preproc
from ..data.samplers import DevicePrefetcher
from ..entry import Predictor
from ..parallel.collectives import broadcast
from ..parallel.mesh import (Mesh, check_spatial_sizes, make_mesh, make_mesh_2d, replicate,
                             sync_global_devices)
from ..utils.checkpoint import load_checkpoint, load_matched, save_checkpoint
from ..utils.convert import (ema_variables, export_masks, export_variables, load_ema,
                             load_optimizer_state, load_variables, optimizer_state_dict)
from ..utils.ema import ModelEMA
from ..utils.logger import logger, setup_logger
from ..utils.metric import MeterBuffer, device_mem_usage_mb
from .train_state import create_train_state, make_train_step, multi_steps, resize_batch

def world_size() -> int:
    """The ranks of the default process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class Trainer:
    def __init__(self, exp, args, device: Any = "cuda"):
        self.exp = exp
        self.args = args
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on the card unless it is "
                               "asked for the CPU (device='cpu')")
        self.max_epoch = exp.max_epoch
        self.input_size = exp.input_size
        self.best_ap = 0.0
        self.meter = MeterBuffer(window_size=exp.print_interval)
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        self.world = world_size()
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.mesh: Optional[Mesh] = None
        if self.rank == 0:
            os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, rank=self.rank, filename="train_log.txt")
        self.epoch = 0
        self.start_epoch = 0
        self.use_l1 = False
        self.tblogger = None
        self.prefetcher = None
        self.epoch_stats: List[Dict[str, Any]] = []
        self.ckpt_stats: List[Dict[str, Any]] = []
        self.eval_stats: List[Dict[str, Any]] = []
        self._check_supported()

    def _check_supported(self):
        exp = self.exp
        # a size the deepest stride does not divide breaks the PAFPN's concat
        # of the upsampled map, in JAX as here: refuse it before the first step
        stride = max(exp.strides)
        bad = [s for s in [tuple(exp.input_size), *map(tuple, exp.multiscale_sizes())]
               if s[0] % stride or s[1] % stride]
        if bad:
            raise ValueError(f"training sizes {sorted(set(bad))} are not multiples of the "
                             f"model's largest stride {stride}: the PAFPN cannot concatenate "
                             f"its upsampled maps there (set multiscale_step to {stride}; "
                             f"ROADMAP Queue 3)")
        spatial = self.spatial_devices
        if spatial > 1 and self.world == 1:
            # don't die, but never drop the setting silently (trainer.py:172-178)
            logger.warning("exp.spatial_devices=%d requested but only 1 rank runs: training "
                           "UNSHARDED (the operating point this exp targets may not fit one "
                           "device)", spatial)
        if self.world == 1:
            return
        if self.world % spatial:
            raise ValueError(f"spatial_devices={spatial} must divide the {self.world} ranks")
        rows = self.world // spatial
        batch_size = self.args.batch_size
        if batch_size % rows:
            raise ValueError(f"batch_size {batch_size} does not split over {rows} data rows: a "
                             f"rank is a process that cannot drop out of the mesh, as JAX's "
                             f"devices do (set a batch size that {rows} divides)")
        if spatial > 1:
            self._check_spatial_sizes(spatial)

    @property
    def spatial_devices(self) -> int:
        return int(getattr(self.exp, "spatial_devices", 1) or 1)

    def _check_spatial_sizes(self, spatial: int):
        """Every training size (input_size and the multiscale buckets) keeps
        the deepest map evenly divided with at least two rows a space rank
        (``parallel/mesh.py::check_spatial_sizes``), and the test size's
        height divides over the space axis (trainer.py:221-252)."""
        exp = self.exp
        sizes = list(map(tuple, exp.multiscale_sizes()))
        if tuple(exp.input_size) not in sizes:
            sizes.append(tuple(exp.input_size))
        check_spatial_sizes(sizes, spatial, max(exp.strides))
        th = exp.test_size[0]
        if th % spatial:
            raise ValueError(f"spatial_devices={spatial}: test_size height {th} must be "
                             f"divisible by the space axis for sharded eval")

    def _setup_mesh(self) -> Optional[Mesh]:
        """The mesh of the default group's ranks (trainer.py:154-219), None on
        one rank. Collective: every rank builds its groups."""
        if self.world == 1:
            return None
        spatial = self.spatial_devices
        if spatial > 1:
            mesh = make_mesh_2d(spatial, self.device)
            logger.info("training over a (%d data x %d space) mesh of ranks", mesh.n_data,
                        mesh.n_space)
        else:
            mesh = make_mesh(self.device)
            logger.info("training over a %d-rank data mesh", mesh.n_data)
        return mesh

    def _replicate_state(self):
        """Rank 0's parameters, BN statistics and EMA shadow on every rank."""
        if self.mesh is None:
            return
        replicate(self.mesh, self.model)
        if self.state.ema is not None:
            for t in self.state.ema.shadow.values():
                broadcast(t, 0, self.mesh.world)

    def state_digest(self) -> str:
        """sha256 of the state's bytes (parameters, buffers, EMA shadow,
        momentum and accumulated gradients), in a fixed order: ranks that
        hold one state give one digest."""
        h = hashlib.sha256()

        def add(name, t):
            h.update(name.encode())
            h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())

        for name, t in list(self.model.named_parameters()) + list(self.model.named_buffers()):
            add(name, t)
        if self.state.ema is not None:
            for name, t in self.state.ema.shadow.items():
                add("ema." + name, t)
        opt = self.optimizer
        for name, p in self.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                add("trace." + name, buf)
            if p in getattr(opt, "acc", {}):
                add("acc." + name, opt.acc[p])
        h.update(f"{opt.count} {getattr(opt, 'mini_step', 0)}".encode())
        return h.hexdigest()

    # ------------------------------------------------------------------
    def train(self):
        self.before_train()
        self.train_epochs()

    def train_epochs(self):
        """The epoch loop from ``start_epoch``, after ``before_train``."""
        try:
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                self.train_in_iter()
                self.after_epoch()
        finally:
            self.after_train()

    def after_train(self):
        logger.info("training done, best AP50 = %.4f", self.best_ap)
        if self.prefetcher is not None:
            self.prefetcher.close()
            self.prefetcher = None
        if self.tblogger is not None:
            self.tblogger.close()

    # ------------------------------------------------------------------
    def before_train(self):
        exp, args = self.exp, self.args
        batch_size = args.batch_size
        logger.info("exp value:\n%s", exp)
        init_ckpt = getattr(exp, "init_ckpt", None)
        self._init_tree = load_checkpoint(init_ckpt) if init_ckpt else None
        ckpt_model = (self._init_tree or {}).get("model", self._init_tree)
        # a pruned init checkpoint builds the ChannelMask model (trainer.py:74-92)
        self.use_mask = bool(getattr(exp, "use_mask", False) or (ckpt_model or {}).get("masks"))
        self.mesh = self._setup_mesh()
        self.model = exp.get_model(device=self.device, use_mask=self.use_mask)
        # the single-process stream on every rank, each fetching its data row
        self.train_loader = exp.get_data_loader(
            batch_size=batch_size, is_distributed=False,
            no_aug=self.start_epoch >= self.max_epoch - exp.no_aug_epochs,
            cache_img=getattr(args, "cache", False), seed=exp.seed or 0)
        if self.mesh is not None:
            self.train_loader.rows = (self.mesh.data_index, self.mesh.n_data)
        self.iters_per_epoch = max(len(self.train_loader.dataset) // batch_size, 1)
        lr = exp.basic_lr_per_img * batch_size
        self.lr_schedule = exp.get_lr_scheduler(lr, self.iters_per_epoch)
        self.optimizer = exp.get_optimizer(batch_size, self.model, self.lr_schedule)
        if exp.num_accumulate > 1:
            multi_steps(self.optimizer, exp.num_accumulate)
        self.state = create_train_state(self.model, self.optimizer, use_ema=exp.ema,
                                        ema_decay=exp.ema_momentum)
        if init_ckpt:
            self._load_init_ckpt(init_ckpt)
        self.resume_train()
        self._replicate_state()
        self.train_step = make_train_step(self.state, exp.strides, num_classes=exp.num_classes,
                                          iou_type=exp.iou_type,
                                          simota_bf16=getattr(exp, "simota_bf16", False),
                                          mesh=self.mesh, remat=getattr(exp, "remat", False))
        self.evaluator = exp.get_evaluator(batch_size=batch_size)
        if self.world > 1:
            self.evaluator.shard = (self.rank, self.world)
        self.size_rng = random.Random((exp.seed or 0) + 1234)
        self.prefetcher = DevicePrefetcher(self.train_loader, self.device)
        self.data_iter = self.prefetcher
        self.tblogger = None
        if self.rank == 0:
            try:  # TensorBoard scalars, when the package is there (ref trainer.py:207-209)
                from torch.utils.tensorboard import SummaryWriter

                self.tblogger = SummaryWriter(self.file_name)
            except Exception:
                logger.info("tensorboard unavailable; skipping TB logs")
        logger.info("init done; %d iters/epoch, device mem %.0f MB", self.iters_per_epoch,
                    device_mem_usage_mb(self.device))

    def _load_matched_into_model(self, tree: Dict[str, Any]) -> None:
        """``load_matched`` of the tree's params and BN statistics, and of its
        masks where both the model and the tree have them (leaves the model
        lacks, such as a magnitude chain's ``conv_mask``, are dropped)."""
        cur = export_variables(self.model)
        new = {"params": load_matched(cur["params"], tree.get("params", tree)),
               "batch_stats": load_matched(cur.get("batch_stats", {}),
                                           tree.get("batch_stats", {}))}
        if "masks" in cur:
            new["masks"] = (load_matched(cur["masks"], tree["masks"]) if tree.get("masks")
                            else cur["masks"])
        load_variables(self.model, new)

    def _next_batch(self):
        """The next (images, labels) of this rank on the device, preprocessed
        on the card on the device paths."""
        imgs, labels, _, _ = self.data_iter.next()
        if isinstance(imgs, dict):
            imgs, labels = apply_device_preproc(self.exp, tuple(self.input_size), imgs)
        return self._space_rows(imgs), labels

    def _space_rows(self, imgs: torch.Tensor) -> torch.Tensor:
        """This rank's rows of its data row's images on a space mesh."""
        mesh = self.mesh
        if mesh is None or mesh.n_space == 1:
            return imgs
        rows = imgs.shape[1] // mesh.n_space
        return imgs.narrow(1, mesh.space_index * rows, rows).contiguous()

    def _load_init_ckpt(self, path: str):
        ckpt = self._init_tree
        self._load_matched_into_model(ckpt.get("model", ckpt))
        # re-seed the EMA shadow from the init weights (trainer.py:270-277)
        if self.state.ema is not None:
            self.state.ema = ModelEMA(self.model, self.exp.ema_momentum)
        logger.info("loaded init checkpoint %s", path)

    # ------------------------------------------------------------------
    def before_epoch(self):
        exp = self.exp
        logger.info("---> start train epoch %d", self.epoch + 1)
        if (self.epoch + 1 >= self.max_epoch - exp.no_aug_epochs
                or getattr(self.args, "no_aug", False)):
            logger.info("--->No mosaic aug now! Add additional L1 loss now!")
            self.train_loader.close_mosaic()
            self.use_l1 = True
            exp.eval_interval = 1

    def train_in_iter(self):
        exp = self.exp
        cur_size = self.input_size
        cuda = self.device.type == "cuda"
        events, sizes, waits = [], [], []
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t_epoch = time.perf_counter()
        for it in range(self.iters_per_epoch):
            iter_start = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
            imgs, labels, _, _ = self.data_iter.next()
            data_end = time.perf_counter()
            waits.append(data_end - iter_start)
            if cuda:
                ev[0].record()
            if isinstance(imgs, dict):
                imgs, labels = apply_device_preproc(exp, tuple(self.input_size), imgs)
            if cuda:
                ev[1].record()

            # multiscale bucket switch every 10 global iters (trainer.py:296-306)
            global_iter = self.epoch * self.iters_per_epoch + it
            if global_iter % 10 == 0:
                cur_size = exp.random_input_size(self.size_rng)
            if tuple(cur_size) != tuple(imgs.shape[1:3]):
                scale_y = cur_size[0] / imgs.shape[1]
                scale_x = cur_size[1] / imgs.shape[2]
                imgs = resize_batch(imgs, tuple(cur_size))
                scale = torch.tensor([1.0, scale_x, scale_y, scale_x, scale_y],
                                     dtype=torch.float32, device=labels.device)
                labels = labels * scale
            sizes.append(tuple(cur_size))

            metrics = self.train_step(self._space_rows(imgs), labels, use_l1=self.use_l1)
            bad += (~torch.isfinite(torch.stack([metrics[k] for k in (
                "loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss")]))).sum()
            if cuda:
                ev[2].record()
                events.append(ev)
            if (it + 1) % exp.print_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # the sync point
                iter_end = time.perf_counter()
                self.meter.update(data_time=data_end - iter_start,
                                  iter_time=iter_end - iter_start,
                                  lr=self.lr_schedule(global_iter), **metrics)
                self._log_progress(it, cur_size)
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t_epoch
        n = len(sizes)
        stats = {"epoch": self.epoch + 1, "iterations": n, "seconds": wall,
                 "img_per_s": n * self.args.batch_size / wall,
                 "data_wait_ms": 1e3 * float(np.mean(waits)), "sizes": sorted(set(sizes)),
                 "size_sequence": sizes, "use_l1": self.use_l1,
                 "nonfinite_losses": int(bad), "peak_mem_mb": device_mem_usage_mb(self.device),
                 "step_ms": None, "input_ms": None}
        if cuda:
            stats["input_ms"] = float(np.mean([e[0].elapsed_time(e[1]) for e in events]))
            stats["step_ms"] = float(np.mean([e[1].elapsed_time(e[2]) for e in events]))
        self.epoch_stats.append(stats)
        if stats["nonfinite_losses"]:
            logger.warning("epoch %d: %d non-finite loss values", self.epoch + 1,
                           stats["nonfinite_losses"])

    def _log_progress(self, it: int, cur_size):
        left_iters = self.iters_per_epoch * (self.max_epoch - self.epoch) - (it + 1)
        eta = left_iters * self.meter["iter_time"].avg / max(self.exp.print_interval, 1)
        loss_str = ", ".join(f"{k}: {self.meter[k].latest:.3f}"
                             for k in ("loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss"))
        logger.info("epoch: %d/%d, iter: %d/%d, %s, lr: %.3e, size: %s, ETA: %.0fs",
                    self.epoch + 1, self.max_epoch, it + 1, self.iters_per_epoch, loss_str,
                    self.meter["lr"].latest, cur_size, eta)

    # ------------------------------------------------------------------
    def after_epoch(self):
        interval = max(int(getattr(self.exp, "ckpt_interval", 1)), 1)
        if (self.epoch + 1) % interval == 0 or self.epoch + 1 == self.max_epoch:
            self.save_ckpt("latest")
        if (self.epoch + 1) % self.exp.eval_interval == 0:
            self.evaluate_and_save_model()

    def eval_variables(self) -> Dict[str, Any]:
        """The EMA shadow (or the live weights) as flax ``{params,
        batch_stats}``, with a masked model's ``masks`` (trainer.py:376-383)."""
        if self.state.ema is None:
            return export_variables(self.model)
        out = ema_variables(self.state.ema)
        masks = export_masks(self.model)
        if masks:
            out["masks"] = masks
        return out

    def evaluate_and_save_model(self):
        """The COCO evaluator over the EMA weights: the unfused model in eval
        mode, in ``compute_dtype``, at the exp's test size, conf and NMS."""
        t0 = time.perf_counter()
        variables = self.eval_variables()
        model = self.exp.get_model(device=self.device, variables=variables,
                                   use_mask=self.use_mask)
        ap, ap50, summary = self.evaluator.evaluate(Predictor(model))
        del model
        self.eval_stats.append({"epoch": self.epoch + 1, "AP": ap, "AP50": ap50,
                                "records": len(self.evaluator.records),
                                "images": self.evaluator.shard_range(),
                                "seconds": time.perf_counter() - t0})
        logger.info("epoch %d eval: %s", self.epoch + 1, summary)
        if self.tblogger is not None:
            self.tblogger.add_scalar("val/COCOAP50", ap50, self.epoch + 1)
            self.tblogger.add_scalar("val/COCOAP50_95", ap, self.epoch + 1)
        self.save_ckpt(f"epoch_{self.epoch + 1}", ap50 > self.best_ap)
        self.best_ap = max(self.best_ap, ap50)

    def checkpoint_state(self) -> Dict[str, Any]:
        """The checkpoint tree of trainer.py:395-407."""
        raw = export_variables(self.model)
        raw.pop("masks", None)
        return {"start_epoch": self.epoch + 1, "model": self.eval_variables(),
                "raw_model": raw,
                "opt_state": optimizer_state_dict(self.optimizer, self.model),
                "best_ap": self.best_ap}

    def save_ckpt(self, name: str, is_best: bool = False):
        """Rank 0 writes; every rank waits for it (trainer.py:395-397)."""
        if self.rank == 0:
            t0 = time.perf_counter()
            path = save_checkpoint(self.checkpoint_state(), is_best, self.file_name, name)
            self.ckpt_stats.append({"name": name, "path": path, "bytes": os.path.getsize(path),
                                    "seconds": time.perf_counter() - t0})
        sync_global_devices(f"save {name}")

    def resume_train(self):
        args = self.args
        if getattr(args, "resume", False):
            ckpt_path = getattr(args, "ckpt", None) or os.path.join(self.file_name,
                                                                    "latest_ckpt.msgpack")
            ckpt = load_checkpoint(ckpt_path)
            self._load_matched_into_model(ckpt.get("raw_model", ckpt.get("model")))
            if "opt_state" in ckpt:
                load_optimizer_state(self.optimizer, self.model, ckpt["opt_state"])
            if self.state.ema is not None and "model" in ckpt:
                cur = export_variables(self.model)
                load_ema(self.state.ema, {
                    "params": load_matched(cur["params"], ckpt["model"]["params"]),
                    "batch_stats": load_matched(cur["batch_stats"],
                                                ckpt["model"].get("batch_stats", {}))})
            start = getattr(args, "start_epoch", None)
            self.start_epoch = int(start if start else ckpt.get("start_epoch", 0))
            if self.state.ema is not None:
                # the decay ramp follows the updates taken (trainer.py:440-445)
                self.state.ema.updates = self.start_epoch * self.iters_per_epoch
            self.best_ap = float(ckpt.get("best_ap", 0.0))
            logger.info("resumed from %s at epoch %d", ckpt_path, self.start_epoch)
        elif getattr(args, "ckpt", None):
            ckpt = load_checkpoint(args.ckpt)
            self._load_matched_into_model(ckpt.get("model", ckpt))
            logger.info("loaded fine-tune weights from %s", args.ckpt)
