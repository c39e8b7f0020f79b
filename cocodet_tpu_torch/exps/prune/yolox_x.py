"""Taylor channel-pruning of YOLOX-X with teacher distillation.

The port's copy of exps/prune/yolox_x.py, on the port's experiment classes.

Parity: ref exps/prune/yolox_x.py:10-72 (prune 100 ch per 0.101 epoch,
distill_coefficient 0.01, no mosaic/mixup, 50 ep, constant lr 0.001).
``num_accumulate`` 2 sets the lr's scale; the Pruner itself does not
accumulate, in JAX as here (cocodet_tpu/core/pruner.py:340).
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 1.33
        self.width = 1.25
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
        self.exp_name += "_prune7"

        self.init_ckpt = "weights/yolox_x.msgpack"

        self.mosaic_prob = 0.0
        self.mixup_prob = 0.0
        self.enable_mixup = False
        self.bn_momentum = 0.015

        self.multiscale_range = (-5, 4)
        self.num_accumulate = 2

        self.warmup_epochs = 0
        self.max_epoch = 50
        self.warmup_lr = 0.001
        self.basic_lr_per_img = 0.0005 / (64.0 / self.num_accumulate)
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 50
        self.min_lr_ratio = 1.0
        self.ema = False

        self.iou_type = "iou"
        self.weight_decay = 2e-4
        self.print_interval = 25
        self.eval_interval = 1

        # pruning schedule (Pruner runtime, core/pruner.py)
        self.prune_channels = 100
        self.prune_interval = 0.101
        self.prune_start_epoch = 0
        self.prune_score_batches = 8
        self.distill_coefficient = 0.01
