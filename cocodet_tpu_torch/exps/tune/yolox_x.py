"""Fine-tune of the pruned YOLOX-X (Tuner runtime, post-prune recovery).

The port's copy of exps/tune/yolox_x.py, on the port's experiment classes.

Parity: ref exps/tune/yolox_x.py:10-72 (init from the pruned ckpt, 50 ep,
constant lr 0.001, no mosaic/mixup, distill off by default).
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 1.33
        self.width = 1.25
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
        self.exp_name += "_tune7"

        self.init_ckpt = "weights/yolox_x_prune7.msgpack"

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
        self.weight_decay = 0.0
        self.print_interval = 25
        self.eval_interval = 1

        # fine-tuning config (Tuner runtime, core/tuner.py)
        self.tune_start_epoch = 0
        self.distill_coefficient = 0
