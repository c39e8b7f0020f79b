"""SynFlow pruning of a partially-trained YOLOX-L (init from epoch-10 ckpt).

The port's copy of exps/prune/yolox_l_synflow2.py, on the port's experiment classes.

Parity: ref exps/prune/yolox_l_synflow2.py:10-21.
"""

import os

from cocodet_tpu_torch.exp import SynFlowExp


class Exp(SynFlowExp):
    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.init_ckpt = "weights/epoch_10_synflow.msgpack"

        self.prune_iters = 20
        self.prune_ratio = 0.5
        self.prune_epoch = 0
