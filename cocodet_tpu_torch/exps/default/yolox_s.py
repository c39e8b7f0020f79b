"""Standard YOLOX-S (registry twin of ref exps/default/yolox_s.py).

The port's copy of exps/default/yolox_s.py, on the port's experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
