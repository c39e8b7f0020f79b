"""YOLOv3: Darknet-53 + YOLOFPN backbone with the decoupled lrelu head
(registry twin of ref exps/default/yolov3.py:12-49).

The port's copy of exps/default/yolov3.py, on the port's experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.model_name = "yolov3"
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]
