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
and go into the evaluated and saved ``model`` variables (:376-383). Raise,
by design (ROADMAP Queue 1 item 4): gradient accumulation
(``num_accumulate > 1``), ``remat``, a spatial mesh or more than one rank.
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.device_aug import apply_device_preproc
from ..data.samplers import DevicePrefetcher
from ..entry import Predictor
from ..utils.checkpoint import load_checkpoint, load_matched, save_checkpoint
from ..utils.convert import (ema_variables, export_masks, export_variables, load_ema,
                             load_optimizer_state, load_variables, optimizer_state_dict)
from ..utils.ema import ModelEMA
from ..utils.logger import logger, setup_logger
from ..utils.metric import MeterBuffer, device_mem_usage_mb
from .train_state import create_train_state, make_train_step, resize_batch

TODO = "(ROADMAP Queue 1 item 4)"


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
        os.makedirs(self.file_name, exist_ok=True)
        setup_logger(self.file_name, filename="train_log.txt")
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
        if exp.num_accumulate > 1:
            raise NotImplementedError(f"gradient accumulation (num_accumulate > 1, "
                                      f"optax.MultiSteps) is not ported {TODO}")
        if getattr(exp, "remat", False):
            raise NotImplementedError(f"remat (torch.utils.checkpoint of the forward) is not "
                                      f"ported {TODO}")
        if int(getattr(exp, "spatial_devices", 1) or 1) > 1:
            raise NotImplementedError(f"the trainer's spatial mesh (spatial_devices > 1) is not "
                                      f"ported {TODO}")
        if torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
            raise NotImplementedError(f"the trainer's data-parallel wiring over several ranks "
                                      f"is not ported {TODO}")
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
        self.model = exp.get_model(device=self.device, use_mask=self.use_mask)
        self.train_loader = exp.get_data_loader(
            batch_size=batch_size, is_distributed=False,
            no_aug=self.start_epoch >= self.max_epoch - exp.no_aug_epochs,
            cache_img=getattr(args, "cache", False), seed=exp.seed or 0)
        self.iters_per_epoch = max(len(self.train_loader.dataset) // batch_size, 1)
        lr = exp.basic_lr_per_img * batch_size
        self.lr_schedule = exp.get_lr_scheduler(lr, self.iters_per_epoch)
        self.optimizer = exp.get_optimizer(batch_size, self.model, self.lr_schedule)
        self.state = create_train_state(self.model, self.optimizer, use_ema=exp.ema,
                                        ema_decay=exp.ema_momentum)
        if init_ckpt:
            self._load_init_ckpt(init_ckpt)
        self.resume_train()
        self.train_step = make_train_step(self.state, exp.strides, num_classes=exp.num_classes,
                                          iou_type=exp.iou_type,
                                          simota_bf16=getattr(exp, "simota_bf16", False))
        self.evaluator = exp.get_evaluator(batch_size=batch_size)
        self.size_rng = random.Random((exp.seed or 0) + 1234)
        self.prefetcher = DevicePrefetcher(self.train_loader, self.device)
        self.data_iter = self.prefetcher
        self.tblogger = None
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
        """The next (images, labels) on the device, preprocessed on the card
        on the device-mosaic path."""
        imgs, labels, _, _ = self.data_iter.next()
        if isinstance(imgs, dict):
            imgs, labels = apply_device_preproc(self.exp, tuple(self.input_size), imgs)
        return imgs, labels

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

            metrics = self.train_step(imgs, labels, use_l1=self.use_l1)
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
                                   use_mask="masks" in variables)
        ap, ap50, summary = self.evaluator.evaluate(Predictor(model))
        del model
        self.eval_stats.append({"epoch": self.epoch + 1, "AP": ap, "AP50": ap50,
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
        t0 = time.perf_counter()
        path = save_checkpoint(self.checkpoint_state(), is_best, self.file_name, name)
        self.ckpt_stats.append({"name": name, "path": path, "bytes": os.path.getsize(path),
                                "seconds": time.perf_counter() - t0})

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
