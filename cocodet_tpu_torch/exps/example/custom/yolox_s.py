"""Custom-dataset YOLOX-S template (ref exps/example/custom/yolox_s.py:
standard s-scale model, custom data_dir, 71-class head, 300 epochs,
eval every epoch).

The port's copy of exps/example/custom/yolox_s.py, on the port's experiment classes.
"""

import os

from cocodet_tpu_torch.exp import Exp as BaseE


class Exp(BaseE):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
        self.exp_name = os.path.split(
            os.path.realpath(__file__))[1].split(".")[0]

        # Define your own dataset path (ref yolox_s.py "Define yourself
        # dataset path" block)
        self.data_dir = "datasets/coco128"
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.num_classes = 71

        self.max_epoch = 300
        self.data_num_workers = 4
        self.eval_interval = 1
