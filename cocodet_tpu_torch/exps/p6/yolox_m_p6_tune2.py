"""Phase-3 fine-tune: continue from the phase-2 result at 896 with silu.

The port's copy of exps/p6/yolox_m_p6_tune2.py, on the port's experiment classes.

Parity: ref exps/p6/yolox_m_p6_tune2.py:10-56 (warmup 10, 150 ep,
multiscale (-2, 1), init from pre_m_p6_tune).
"""

import os

from cocodet_tpu_torch.exp import CustomP6Exp


class Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
        self.exp_name += "_tune3"
        self.act = "silu"

        self.init_ckpt = "weights/pre_m_p6_tune.msgpack"

        self.bn_momentum = 0.01

        self.data_num_workers = 4
        self.input_size = (896, 896)
        self.multiscale_range = (-2, 1)
        self.multiscale_step = 64

        self.num_accumulate = 1
        self.warmup_epochs = 10
        self.max_epoch = 150
        self.warmup_lr = 0.0
        self.basic_lr_per_img = 0.01 / (64.0 / self.num_accumulate)
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 10
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_momentum = 0.9999

        self.iou_type = "giou"
        self.weight_decay = 5e-4
        self.print_interval = 25
        self.eval_interval = 5

        self.test_size = (896, 896)
        self.test_conf = 0.001
        self.nms_threshold = 0.65
