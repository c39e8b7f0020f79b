"""YOLOX-Tiny: 416 input, reduced mosaic scale, no mixup
(registry twin of ref exps/default/yolox_tiny.py:12-21).

The port's copy of exps/default/yolox_tiny.py, on the port's experiment
classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.375
        self.input_size = (416, 416)
        self.mosaic_scale = (0.5, 1.5)
        self.multiscale_range = (-3, 7)  # ref random_size (10, 20) @ step 32
        self.test_size = (416, 416)
        self.enable_mixup = False
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
