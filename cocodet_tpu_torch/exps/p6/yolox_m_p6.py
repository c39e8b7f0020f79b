"""Phase-1 training config for the competition YOLOX-M-P6, the port's copy
of exps/p6/yolox_m_p6.py (ref exps/p6/yolox_m_p6.py:10-53), on the port's
experiment classes."""

import os

from cocodet_tpu_torch.exp import CustomP6Exp


class Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.data_num_workers = 4
        self.input_size = (768, 768)
        self.multiscale_range = (-4, 2)
        self.multiscale_step = 32

        self.num_accumulate = 1
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0.0
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_momentum = 0.9999  # batch 64 (ref exps/p6/yolox_m_p6.py:41)

        self.iou_type = "iou"
        self.weight_decay = 5e-4
        self.print_interval = 25
        self.eval_interval = 5

        self.test_size = (768, 768)
        self.test_conf = 0.001
        self.nms_threshold = 0.65
