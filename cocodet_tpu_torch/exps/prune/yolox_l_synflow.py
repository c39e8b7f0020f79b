"""SynFlow one-shot pruning of YOLOX-L at init.

The port's copy of exps/prune/yolox_l_synflow.py, on the port's experiment classes.

Parity: ref exps/prune/yolox_l_synflow.py:10-18 (20 prune iters to 50%).
"""

import os

from cocodet_tpu_torch.exp import SynFlowExp


class Exp(SynFlowExp):
    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.exp_name = os.path.split(os.path.realpath(__file__))[1].split(".")[0]

        self.prune_iters = 20
        self.prune_ratio = 0.5
