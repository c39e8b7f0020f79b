"""Phase-2 competition fine-tune, the port's copy of exps/p6/yolox_m_p6_tune.py
(ref exps/p6/yolox_m_p6_tune.py:20-56): init from the phase-1 weights, 100
epochs at 896 px, GIoU, multiscale (-1, 1) at step 64 (832-960, each a
multiple of the model's stride 64). ``bn_momentum`` 0.01 is set as in JAX,
where no ``get_model`` reads it (exp/yolox_exp.py)."""

import os

from cocodet_tpu_torch.exp import CustomP6Exp


class Exp(CustomP6Exp):
    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
        self.exp_name += "_tune"

        self.init_ckpt = "weights/pre_m_p6.msgpack"

        self.bn_momentum = 0.01          # reduced 0.03 -> 0.01

        self.data_num_workers = 4
        self.input_size = (896, 896)
        self.multiscale_range = (-1, 1)
        self.multiscale_step = 64

        self.num_accumulate = 1
        self.warmup_epochs = 5
        self.max_epoch = 100
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
