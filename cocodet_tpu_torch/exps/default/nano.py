"""YOLOX-Nano: depthwise convs throughout, 416 input, mosaic_prob 0.5
(registry twin of ref exps/default/nano.py:12-49 — there the depthwise
flag is wired via a get_model override; here it's the "yolox-dw" registry
spec).

The port's copy of exps/default/nano.py, on the port's experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.25
        self.model_name = "yolox-dw"
        self.input_size = (416, 416)
        self.mosaic_scale = (0.5, 1.5)
        self.multiscale_range = (-3, 7)  # ref random_size (10, 20) @ step 32
        self.mosaic_prob = 0.5
        self.enable_mixup = False
        self.test_size = (416, 416)
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
