"""The experiment classes (cocodet_tpu/exp/yolox_exp.py): ``Exp`` with the
standard YOLOX defaults, and the hard-swish lineages ``CustomExp``,
``CustomP6Exp`` (the competition's 4-level P6) and ``CustomP6v2Exp``, with
the JAX package's attribute values.

The factories build the port's objects: the model of ``models.build_model``
in ``compute_dtype``; the COCO train set and the device-mosaic loader; SGD
with nesterov momentum and weight decay on the conv kernels only
(``core/train_state.py::build_optimizer``); the lr schedule
(``utils/lr_scheduler.py``); the multiscale buckets, drawn from a seeded host
``random.Random``; and the ``COCOEvaluator`` at ``test_size``,
``test_conf`` and ``nms_threshold``. The loader is the host mosaic path by
default (``data/mosaic.py``, as the JAX package's default exp) and the
device-mosaic path with ``device_mosaic True``. ``get_model(use_mask=True)``
builds the ChannelMask model of the Pruner and Tuner. ``device_aug`` alone
and the yolov3 model raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Sequence, Tuple, Union

import torch

from .base_exp import BaseExp

DEVICE_AUG_TODO = ("device_aug without device_mosaic (DeviceAugDataset, make_device_collate) "
                   "is not ported (ROADMAP Queue 1 item 4): unset device_aug for the host "
                   "mosaic path, or set device_mosaic True")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Exp(BaseExp):
    """Standard YOLOX experiment defaults (yolox_exp.py:34-133)."""

    def __init__(self):
        super().__init__()
        # model
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        self.model_name = "yolox"
        self.strides = (8, 16, 32)
        self.bn_momentum = 0.03
        self.bn_eps = 1e-3
        # data loader
        self.data_num_workers = 4
        self.input_size = (640, 640)
        self.multiscale_range = 5
        self.multiscale_step = 32
        self.data_dir = None
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.max_labels_mosaic = 120
        self.max_labels = 50
        # transforms
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        self.hsv_prob = 1.0
        self.flip_prob = 0.5
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2.0)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.enable_mixup = True
        self.device_aug = False
        self.device_aug_src_scale = 1.0
        self.device_aug_max_boxes = 120
        self.device_mosaic = False
        self.device_mosaic_max_boxes = 120
        # training
        self.num_accumulate = 1
        self.remat = False
        self.simota_bf16 = False
        self.spatial_devices = 1
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0.0
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_momentum = 0.9998
        self.iou_type = "iou"
        self.weight_decay = 5e-4
        self.momentum = 0.9
        self.print_interval = 10
        self.eval_interval = 10
        self.ckpt_interval = 1
        self.compute_dtype = "bfloat16"
        # testing
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nms_threshold = 0.65
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

    # ---------------- factories ----------------
    def get_model(self, device: Union[str, torch.device] = "cuda", fused: bool = False,
                  use_mask: bool = False, variables=None, seed: Optional[int] = None):
        """The model in ``compute_dtype`` (f32 parameters) on ``device``, with
        the flax-layout ``variables``, or weights drawn from numpy ``seed``
        (default ``self.seed`` or 0) with the head's cls and obj biases at the
        prior 0.01 (``utils/convert.py::random_variables``). ``use_mask``
        builds the ChannelMask model (yolox_exp.py:135-144); its random
        weights equal the unmasked model's, every gate open."""
        from ..models.yolox import MODEL_SPECS, YOLOX, build_model
        from ..utils.convert import random_variables

        dtype = DTYPES[self.compute_dtype]
        if variables is None:
            if self.model_name not in MODEL_SPECS:
                raise KeyError(f"unknown model {self.model_name!r}")
            with torch.device("meta"):
                shapes = YOLOX(MODEL_SPECS[self.model_name], num_classes=self.num_classes,
                               depth=self.depth, width=self.width, fused=fused,
                               use_mask=use_mask)
            variables = random_variables(shapes, (self.seed or 0) if seed is None else seed,
                                         prior_prob=0.01)
        return build_model(self.model_name, num_classes=self.num_classes, depth=self.depth,
                           width=self.width, fused=fused, dtype=dtype, device=device,
                           variables=variables, use_mask=use_mask)

    def get_dataset(self, cache: bool = False):
        from ..data.coco import COCODataset

        return COCODataset(data_dir=self.data_dir, json_file=self.train_ann, name="train2017",
                           img_size=self.input_size, cache=cache)

    def get_data_loader(self, batch_size: int, is_distributed: bool = False,
                        no_aug: bool = False, cache_img: bool = False, rank: int = 0,
                        world_size: int = 1, seed: int = 0):
        """The training loader (yolox_exp.py:161-230). By default the host
        mosaic path: ``MosaicDetection`` with ``TrainTransform`` on the
        loader's threads, batches of float32 images and padded labels. With
        ``device_mosaic``: the host decodes and draws, ``data/device_mosaic.py``
        collates raw uint8 tiles for the card."""
        from ..data.samplers import DetectionLoader, InfiniteSampler, YoloBatchSampler

        device_mosaic = getattr(self, "device_mosaic", False)
        if getattr(self, "device_aug", False) and not device_mosaic:
            raise NotImplementedError(DEVICE_AUG_TODO)
        dataset = self.get_dataset(cache=cache_img)
        item_rng = random.Random(1_000_003 * (seed + 1) + rank)
        sampler = InfiniteSampler(len(dataset), seed=seed, rank=rank, world_size=world_size)
        batch_sampler = YoloBatchSampler(sampler, batch_size, mosaic=not no_aug)
        if not device_mosaic:
            from ..data.mosaic import MosaicDetection
            from ..data.transforms import TrainTransform

            wrapped = MosaicDetection(
                dataset, mosaic=not no_aug, img_size=self.input_size,
                preproc=TrainTransform(max_labels=self.max_labels_mosaic,
                                       flip_prob=self.flip_prob, hsv_prob=self.hsv_prob),
                degrees=self.degrees, translate=self.translate, mosaic_scale=self.mosaic_scale,
                mixup_scale=self.mixup_scale, shear=self.shear, enable_mixup=self.enable_mixup,
                mosaic_prob=self.mosaic_prob, mixup_prob=self.mixup_prob, rng=item_rng)
            return DetectionLoader(wrapped, batch_sampler, num_workers=self.data_num_workers,
                                   seed=seed)

        from ..data.device_mosaic import DeviceMosaicDataset, make_mosaic_collate

        wrapped = DeviceMosaicDataset(
            dataset, img_size=self.input_size, degrees=self.degrees, translate=self.translate,
            mosaic_scale=self.mosaic_scale, mixup_scale=self.mixup_scale, shear=self.shear,
            enable_mixup=self.enable_mixup, mosaic_prob=self.mosaic_prob,
            mixup_prob=self.mixup_prob, mosaic=not no_aug, hsv_prob=self.hsv_prob,
            rng=item_rng)
        collate = make_mosaic_collate(self.input_size,
                                      max_boxes=getattr(self, "device_mosaic_max_boxes", 120))
        return DetectionLoader(wrapped, batch_sampler, num_workers=self.data_num_workers,
                               seed=seed, collate_fn=collate)

    def get_optimizer(self, batch_size: int, model, schedule=None):
        """SGD + nesterov momentum, weight decay on the conv kernels only
        (yolox_exp.py:232-250); the lr of a step is ``schedule(count)``, by
        default the one ``get_lr_scheduler`` built."""
        from ..core.train_state import build_optimizer

        lr = self.basic_lr_per_img * batch_size
        schedule = schedule or getattr(self, "_lr_schedule", None) or lr
        return build_optimizer(model, schedule, weight_decay=self.weight_decay,
                               momentum=self.momentum)

    def get_lr_scheduler(self, lr: float, iters_per_epoch: int):
        from ..utils.lr_scheduler import build_lr_schedule

        self._lr_schedule = build_lr_schedule(
            self.scheduler, lr, iters_per_epoch, self.max_epoch,
            warmup_epochs=self.warmup_epochs, warmup_lr_start=self.warmup_lr,
            no_aug_epochs=self.no_aug_epochs, min_lr_ratio=self.min_lr_ratio)
        return self._lr_schedule

    def multiscale_sizes(self) -> Sequence[Tuple[int, int]]:
        """The multiscale buckets (yolox_exp.py:273-283)."""
        if isinstance(self.multiscale_range, tuple):
            lo, hi = self.multiscale_range
        else:
            lo, hi = -self.multiscale_range, self.multiscale_range
        step = self.multiscale_step
        base = self.input_size[0] // step
        return [(step * (base + k), step * (base + k)) for k in range(lo, hi + 1)]

    def random_input_size(self, step_rng: random.Random) -> Tuple[int, int]:
        sizes = self.multiscale_sizes()
        return sizes[step_rng.randrange(len(sizes))]

    def get_eval_dataset(self, testdev: bool = False, legacy: bool = False):
        from ..data.coco import COCODataset
        from ..data.transforms import ValTransform

        if legacy:
            raise NotImplementedError("the legacy ValTransform is not ported")
        return COCODataset(data_dir=self.data_dir,
                           json_file=self.val_ann if not testdev else "instances_test2017.json",
                           name="val2017" if not testdev else "test2017",
                           img_size=self.test_size, preproc=ValTransform())

    def get_evaluator(self, batch_size: int, is_distributed: bool = False,
                      testdev: bool = False, legacy: bool = False):
        from ..evaluators.coco_evaluator import COCOEvaluator

        return COCOEvaluator(self.get_eval_dataset(testdev=testdev, legacy=legacy),
                             img_size=self.test_size, conf_threshold=self.test_conf,
                             nms_threshold=self.nms_threshold, num_classes=self.num_classes,
                             batch_size=batch_size)


class CustomExp(Exp):
    """3-scale custom model, hard-swish (yolox_exp.py:317-326)."""

    def __init__(self):
        super().__init__()
        self.act = "hard_swish"
        self.model_name = "yolox-custom"
        self.data_num_workers = 2
        self.ema_momentum = 0.9998


class CustomP6Exp(Exp):
    """The P6 4-scale competition lineage (yolox_exp.py:329-345)."""

    def __init__(self):
        super().__init__()
        self.act = "hard_swish"
        self.model_name = "yolox-p6"
        self.strides = (8, 16, 32, 64)
        self.input_size = (768, 768)
        self.test_size = (768, 768)
        self.multiscale_range = (-3, 1)
        self.multiscale_step = 64
        self.data_num_workers = 2
        self.test_conf = 0.001
        self.ema_momentum = 0.9998


class CustomP6v2Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.model_name = "yolox-p6v2"
