"""Custom 3-scale YOLOX-L: 704 input, GIoU-free long schedule.

The port's copy of exps/custom/yolox_l_custom.py, on the port's experiment classes.

Parity: ref exps/custom/yolox_l_custom.py:10-54 (CustomExp, 300 ep,
multiscale (-5, 3)).
"""

import os

from cocodet_tpu_torch.exp import CustomExp


class Exp(CustomExp):
    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.bn_momentum = 0.03

        self.data_num_workers = 4
        self.input_size = (704, 704)
        self.multiscale_range = (-5, 3)
        self.multiscale_step = 32

        self.num_accumulate = 1
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0.0
        self.basic_lr_per_img = 0.01 / (64.0 / self.num_accumulate)
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_momentum = 0.9999

        self.iou_type = "iou"
        self.weight_decay = 5e-4
        self.print_interval = 25
        self.eval_interval = 5

        self.test_size = (704, 704)
        self.test_conf = 0.001
        self.nms_threshold = 0.65
