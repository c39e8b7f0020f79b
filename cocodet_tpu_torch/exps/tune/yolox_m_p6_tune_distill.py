"""Distillation fine-tune config, the port's copy of
exps/tune/yolox_m_p6_tune_distill.py (core/tuner.py)."""

import os

from cocodet_tpu_torch.exp import CustomP6Exp


class Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.init_ckpt = "weights/best_ckpt.msgpack"
        self.max_epoch = 50
        self.basic_lr_per_img = 0.001 / 64.0
        self.warmup_epochs = 1
        self.no_aug_epochs = 10

        self.distill_coefficient = 1.0    # the distill train step
        self.tune_start_epoch = 0
        self.eval_interval = 5
