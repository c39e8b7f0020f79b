"""Custom-dataset YOLOX-Nano template (ref exps/example/custom/nano.py:
depthwise convs, 416 input, no mixup, custom data_dir + 71-class head).

Point ``data_dir``/``train_ann``/``val_ann`` at your own COCO-format
dataset and adjust ``num_classes``; everything else follows the default
nano recipe (exps/default/nano.py).

The port's copy of exps/example/custom/nano.py, on the port's experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.25
        self.model_name = "yolox-dw"  # depthwise = the nano difference
        self.input_size = (416, 416)
        self.mosaic_scale = (0.5, 1.5)
        self.multiscale_range = (-3, 7)  # ref random_size (10, 20) @ step 32
        self.mosaic_prob = 0.5
        self.enable_mixup = False
        self.test_size = (416, 416)
        self.exp_name = os.path.split(
            os.path.realpath(__file__))[1].split(".")[0]

        # Define your own dataset path (ref nano.py "Define yourself
        # dataset path" block)
        self.data_dir = "datasets/coco128"
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.num_classes = 71
